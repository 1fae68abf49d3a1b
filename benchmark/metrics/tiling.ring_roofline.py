"""tiling.ring_roofline: strip tiling's exact ring's share of its roofline,
in %: the y-scanning directions' least time (`workmodel.ring`) for the
traced frames over the device time of the fused sweep's launches
(`csrc/sgm_fused.cu`). With exact tiling and 8 paths every fused launch is
one of the ring's carry launches, a scan order over one strip."""

from benchmark import devtrace, workmodel

PATTERNS = (r"\bsgm_fused_kernel\b",)


def read(view):
    if view.stages is None or view.frames <= 0:
        return None
    t = devtrace.device_seconds(view.ops, PATTERNS)
    if t <= 0:
        return None
    work = workmodel.ring(view.stages)
    least = workmodel.bound(work["bytes"], work["ops"]) * view.frames
    return 100.0 * least / t
