"""postproc_roofline: the post-processing layer's share of its roofline, in
%: the frozen work model's `lr_check`, `speckle`, `fill` and `median`
stages' least time for the traced frames over the device time of every
device operation that the census and sweeps layers do not claim. That
holds its own kernels (`csrc/lr_check.cu`, `cc_labels.cu`, `median3.cu`,
`bitonic.cu`, named in PATTERNS) and the library operations around them,
such as `component_big`'s sort and search, the masks and copies."""

from benchmark import devtrace
from benchmark.metrics import census_roofline, sweeps_roofline

PATTERNS = (r"\blr_check_kernel\b", r"\blr_hits_kernel\b",
            r"\bcc_local_kernel\b", r"\bcc_border_kernel\b",
            r"\bcc_flatten_kernel\b", r"\bmedian3_kernel\b",
            r"\bbitonic_tile\b", r"\bbitonic_global\b")
STAGES = ("lr_check", "speckle", "fill", "median")
OTHERS = census_roofline.PATTERNS + sweeps_roofline.PATTERNS


def read(view):
    return devtrace.roofline_pct(view, STAGES, exclude=OTHERS)
