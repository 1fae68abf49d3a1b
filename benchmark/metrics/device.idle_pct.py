"""device.idle_pct: the share of the traced stretch, from the first device
operation's start to the last one's end, in which no kernel, copy or fill
ran on the device, in %."""

from benchmark import devtrace

read = devtrace.idle_pct
