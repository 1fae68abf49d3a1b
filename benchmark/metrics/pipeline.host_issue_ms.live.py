"""pipeline.host_issue_ms.live:
pipeline.host_issue_ms in the cells of one pair a call,
which report the host-paced end-to-end metrics (`.live`)."""

from benchmark import devtrace

read = devtrace.host_issue_ms
