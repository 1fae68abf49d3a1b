"""pipeline.device_ops_per_frame: kernels, copies and fills in the trace
per frame traced, whatever wrapper or library issued them."""

from benchmark import devtrace

read = devtrace.ops_per_frame
