"""The port's one-direction sweep `kernels.sgm_sweep` on the CPU: its write
form (S None, the JAX `sgm_sweep(C, None, ...)`) against the JAX Pallas
sweep in interpret mode, its add form against the plain path costs, and
the build counts that the card's launches keep.

The JAX sweep takes one frame in its (T, N, D) layout with D padded to
128 and N to 8 (zeros, as `aggregate_pallas` pads them): the vertical and
diagonal directions scan the frame's rows, E and W the transposed frame's.
Inputs are made from a seed with numpy and handed to both packages.

Tolerance: int16 path costs bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpustereo.kernels.sgm_pallas import sgm_sweep as j_sgm_sweep
from tpustereo_torch import kernels
from tpustereo_torch.ops.sgm import DIRS_8, path_costs

P1, P2 = 7, 90


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _jax_sweep(C: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """L_r of one (H, W, D) frame by the JAX sweep in interpret mode."""
    frame = C.transpose(1, 0, 2) if dy == 0 else C   # (T, N, D)
    T, N, D = frame.shape
    padded = np.pad(frame, ((0, 0), (0, _round_up(N, 8) - N),
                            (0, _round_up(D, 128) - D)))
    reverse = (dx if dy == 0 else dy) < 0
    S = j_sgm_sweep(jnp.asarray(padded), None, (0 if dy == 0 else dx,),
                    reverse, P1, P2, N, D, interpret=True)
    S = np.asarray(S)[:, :N, :D]
    return S.transpose(1, 0, 2) if dy == 0 else S


@pytest.mark.parametrize("H,W", [(6, 11), (9, 4)])
@pytest.mark.parametrize("D", [16, 40])
@pytest.mark.parametrize("direction", DIRS_8)
def test_write_form_matches_pallas_interpret(rng, H, W, D, direction):
    C = rng.integers(0, 25, (2, H, W, D), dtype=np.uint8)
    got = kernels.sgm_sweep(torch.from_numpy(C), None, *direction, P1, P2)
    assert got.dtype == torch.int16 and got.shape == C.shape
    for f in range(2):
        np.testing.assert_array_equal(got[f].numpy(),
                                      _jax_sweep(C[f], *direction))


@pytest.mark.parametrize("direction", DIRS_8)
def test_forms_match_path_costs(rng, direction):
    """The write form is `path_costs(...).to(int16)`; the add form adds it
    to S in place and returns S."""
    C = torch.from_numpy(rng.integers(0, 256, (2, 5, 7, 24),
                                      dtype=np.uint8))
    L = path_costs(C, *direction, P1, P2).to(torch.int16)
    assert torch.equal(kernels.sgm_sweep(C, None, *direction, P1, P2), L)
    S0 = torch.from_numpy(rng.integers(-500, 500, C.shape, dtype=np.int16))
    S = S0.clone()
    assert kernels.sgm_sweep(C, S, *direction, P1, P2) is S
    assert torch.equal(S, S0 + L)


FORMS = {"write": 0, "add": 0, "write_adaptive": 0, "add_adaptive": 0}


def test_reset_launch_counts_clears_the_sweep_forms():
    kernels.sgm_sweep.builds["write"] += 2
    kernels.sgm_sweep.builds["add"] += 5
    kernels.sgm_sweep.builds["add_adaptive"] += 1
    kernels.reset_launch_counts()
    assert kernels.sgm_sweep.builds == FORMS


def test_cpu_forms_count_no_launch(rng):
    C = torch.from_numpy(rng.integers(0, 25, (1, 4, 6, 16), dtype=np.uint8))
    kernels.reset_launch_counts()
    S = kernels.sgm_sweep(C, None, 1, 0, P1, P2)
    kernels.sgm_sweep(C, S, -1, 0, P1, P2)
    assert kernels.sgm_sweep.launches == 0
    assert kernels.sgm_sweep.builds == FORMS
