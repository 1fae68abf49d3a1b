"""Hand-written CUDA kernels for Hopper (`sm_90a`), one module per TPU
kernel of the JAX package, each with its plain PyTorch version beside it.

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; it never falls back from one to the other. Each wrapper counts its
kernel launches in a plain integer attribute, `launches`, so a run can show
that it went through the kernels. Importing this package builds nothing:
`_build` compiles `csrc/*.cu` at first use.
"""

from tpustereo_torch.kernels.bitonic import bitonic_sort  # noqa: F401
from tpustereo_torch.kernels.cc import (  # noqa: F401
    connected_component_big, connected_component_labels)
from tpustereo_torch.kernels.cost import census_cost_volume  # noqa: F401
from tpustereo_torch.kernels.lr import (  # noqa: F401
    dr_consistency, dr_consistency_hits)
from tpustereo_torch.kernels.median import median3  # noqa: F401
from tpustereo_torch.kernels.sad import sad_wta  # noqa: F401
from tpustereo_torch.kernels.sgm import (  # noqa: F401
    aggregate_volume, sgm_select, sgm_sweep, sgm_sweep_bidir, sgm_sweep_fused,
    sweep_bwd_wta)
from tpustereo_torch.kernels.transpose import (  # noqa: F401
    transpose_hw, transpose_sum_hw)
from tpustereo_torch.kernels.width_micro import (  # noqa: F401
    bf16_roll_chain_micro, elem_chain_micro, reg_chain_micro,
    roll_chain_micro, sweep_micro)
from tpustereo_torch.kernels.wta import wta_lr  # noqa: F401

WRAPPERS = (census_cost_volume, sgm_sweep, sweep_bwd_wta, dr_consistency,
            connected_component_labels, median3, wta_lr, sad_wta,
            transpose_hw, transpose_sum_hw, sgm_sweep_bidir,
            dr_consistency_hits, bitonic_sort, sweep_micro, elem_chain_micro,
            roll_chain_micro, reg_chain_micro, bf16_roll_chain_micro,
            sgm_sweep_fused, connected_component_big)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    """Set every wrapper's count to 0, and its counts by build where it
    keeps them (`builds`, and `carry_forms` of the sweeps)."""
    for w in WRAPPERS:
        w.launches = 0
        for counts in ("builds", "carry_forms"):
            if hasattr(w, counts):
                setattr(w, counts, dict.fromkeys(getattr(w, counts), 0))
