"""Hand-written CUDA kernels for Hopper (`sm_90a`), one module per TPU
kernel of the JAX package, each with its plain PyTorch version beside it.

A wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; it never falls back from one to the other. Each wrapper counts its
kernel launches in a plain integer attribute, `launches`, so a run can show
that it went through the kernels. Importing this package builds nothing:
`_build` compiles `csrc/*.cu` at first use.
"""

from tpustereo_torch.kernels.cc import connected_component_labels  # noqa: F401
from tpustereo_torch.kernels.cost import census_cost_volume  # noqa: F401
from tpustereo_torch.kernels.lr import dr_consistency  # noqa: F401
from tpustereo_torch.kernels.median import median3  # noqa: F401
from tpustereo_torch.kernels.sad import sad_wta  # noqa: F401
from tpustereo_torch.kernels.sgm import (  # noqa: F401
    sgm_select, sgm_sweep, sweep_bwd_wta)
from tpustereo_torch.kernels.wta import wta_lr  # noqa: F401

WRAPPERS = (census_cost_volume, sgm_sweep, sweep_bwd_wta, dr_consistency,
            connected_component_labels, median3, wta_lr, sad_wta)


def launch_counts() -> dict:
    """{wrapper name: kernel launches since the last reset}."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
