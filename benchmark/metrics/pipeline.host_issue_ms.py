"""pipeline.host_issue_ms: the mean host time of a call, from its issue
until the entry returns and before the synchronize, over the traced run's
calls that the profiler did not record (the host clock)."""

from benchmark import devtrace

read = devtrace.host_issue_ms
