"""frame_roofline.live: frame_roofline in the cells of one pair a call,
which report the host-paced end-to-end metrics (`.live`)."""

from benchmark import devtrace

read = devtrace.frame_roofline_pct
