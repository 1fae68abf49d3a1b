"""pipeline.device_ops_per_frame.live:
pipeline.device_ops_per_frame in the cells of one pair a call,
which report the host-paced end-to-end metrics (`.live`)."""

from benchmark import devtrace

read = devtrace.ops_per_frame
