"""census_roofline: the census cost layer's share of its roofline, in %:
the frozen work model's `cost` stage least time for the traced frames over
the device time of the census cost kernel (`csrc/census_cost.cu`)."""

from benchmark import devtrace

PATTERNS = (r"\bcensus_cost_kernel\b",)
STAGES = ("cost",)


def read(view):
    return devtrace.roofline_pct(view, STAGES, PATTERNS)
