"""device.idle_pct.live: device.idle_pct in the cells of one pair a call,
which report the host-paced end-to-end metrics (`.live`)."""

from benchmark import devtrace

read = devtrace.idle_pct
