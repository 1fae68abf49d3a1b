"""postproc_roofline.live: postproc_roofline in the cells of one pair a call,
which report the host-paced end-to-end metrics (`.live`)."""

from benchmark.metrics.postproc_roofline import read  # noqa: F401
