"""sweeps_roofline.live: sweeps_roofline in the cells of one pair a call,
which report the host-paced end-to-end metrics (`.live`)."""

from benchmark.metrics.sweeps_roofline import read  # noqa: F401
