"""sweeps_roofline: the SGM sweeps layer's share of its roofline, in %: the
frozen work model's `sweeps` and `select` stages' least time for the traced
frames over the device time of the sweep kernels (`csrc/sgm_sweep.cu`,
`sgm_fused.cu`, `bwd_wta.cu`, `sgm_bidir.cu`), the relayouts of the volume
route (`transpose.cu`) and its selection over a whole volume
(`wta_lr.cu`)."""

from benchmark import devtrace

PATTERNS = (r"\bsgm_sweep_kernel\b", r"\bsgm_fused_kernel\b",
            r"\bbwd_wta_kernel\b", r"\bsgm_bidir_kernel\b",
            r"\btranspose_kernel\b", r"\bwta_select_kernel\b",
            r"\bwta_lr_finish_kernel\b")
STAGES = ("sweeps", "select")


def read(view):
    return devtrace.roofline_pct(view, STAGES, PATTERNS)
