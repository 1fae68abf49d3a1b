"""frame_roofline: the whole frame's share of the card's roofline, in %:
the least time of every stage of the frozen work model for the traced
frames over the traced window's wall time (idle included). A kernel taken
off the path leaves its own share silent; this one still bounds the
gain."""

from benchmark import devtrace

read = devtrace.frame_roofline_pct
