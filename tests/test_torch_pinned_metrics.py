"""The port's pipeline held to the JAX package's stored metric points,
`tests/data/pinned_metrics.json` (read, never written), on the CPU.

The suite, its tolerances and the file are `tests/test_pinned_metrics.py`'s
own, imported from there, so the two suites cannot drift apart:
RATE_TOL on D1-all, bad-2.0 and the valid fraction, EPE_TOL on EPE.
`tests/test_torch_gpu.py` runs the same points on the card through
`compute`.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from tpustereo_torch import Config, api
from tpustereo_torch.data import synthetic_pair
from tpustereo_torch.eval.metrics import bad, d1_all, end_point_error

HERE = os.path.dirname(os.path.abspath(__file__))


def load_sibling(name: str):
    """The test module `name` of this directory, loaded by its path: the
    card machine has a package named `tests` of its own, which shadows
    this directory there."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the JAX test's suite, tolerances and file (it imports `tpustereo.config`
# alone, no JAX)
_jax = load_sibling("test_pinned_metrics")
SUITE, RATE_TOL, EPE_TOL, PIN_PATH = (_jax.SUITE, _jax.RATE_TOL,
                                      _jax.EPE_TOL, _jax.PIN_PATH)


def compute(name: str, device="cpu") -> tuple:
    """The point's metrics as the JAX test computes them, from the port's
    `api.match_pair` on `device`, and the disparity map."""
    pair_kw, cfg_kw = next((p, c) for n, p, c in SUITE if n == name)
    L, R, gt, mask = synthetic_pair(**pair_kw)
    gtm = np.where(mask, gt, -1.0).astype(np.float32)
    disp = api.match_pair(L, R, Config(**cfg_kw), device=device)
    return {
        "bad2": round(float(bad(disp, gtm)), 6),
        "d1_all": round(float(d1_all(disp, gtm)), 6),
        "epe": round(float(end_point_error(disp, gtm)), 6),
        "valid_frac": round(float((disp >= 0).mean()), 6),
    }, disp


@pytest.fixture(scope="module")
def pinned():
    with open(PIN_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [n for n, _, _ in SUITE])
def test_pinned_metrics(pinned, name):
    got, _ = compute(name)
    want = pinned[name]
    for k in ("bad2", "d1_all", "valid_frac"):
        assert abs(got[k] - want[k]) <= RATE_TOL, (name, k, got, want)
    assert abs(got["epe"] - want["epe"]) <= EPE_TOL, (name, got, want)


def test_pinned_file_covers_suite(pinned):
    assert set(pinned) == {n for n, _, _ in SUITE}


def test_opencv_sgm_metric_level():
    """`test_pinned_metrics.py`'s metric-level oracle check on the port:
    on a sloped noisy pair the port's SGM and cv2.StereoSGBM (BT cost
    against census) land within a few points of bad-2.0 of each other
    against the analytic truth, on the jointly valid pixels."""
    from tpustereo_torch.golden.opencv_ref import have_cv2, opencv_sgbm
    if not have_cv2():
        pytest.skip("cv2 unavailable")
    L, R, gt, mask = synthetic_pair((96, 128), disparity=10.0, slope=0.05,
                                    seed=5, noise=2.0)
    gtm = np.where(mask, gt, -1.0).astype(np.float32)
    cfg = Config(mode="sgm", paths=8, num_disparities=32,
                 speckle_window_size=50)
    ours = api.match_pair(L, R, cfg, device="cpu")
    cv = opencv_sgbm(L, R, cfg)
    both = (ours >= 0) & (cv >= 0) & (gtm >= 0)
    assert both.mean() > 0.5, both.mean()
    e_ours = (np.abs(ours - gtm)[both] > 2.0).mean()
    e_cv = (np.abs(cv - gtm)[both] > 2.0).mean()
    assert abs(e_ours - e_cv) < 0.05, (e_ours, e_cv)
    assert e_ours < 0.1 and e_cv < 0.1, (e_ours, e_cv)
    assert (ours >= 0).mean() >= (cv >= 0).mean() - 0.02
    assert bad(ours, gtm) < 0.08, bad(ours, gtm)


def test_chip_smoke_reads_the_same_suite():
    """`chip_smoke.py` reads the suite from the JAX test's source (it
    imports nothing of the JAX package): the same points and tolerances."""
    import chip_smoke
    assert chip_smoke.pinned_suite(os.path.dirname(HERE)) == (
        SUITE, RATE_TOL, EPE_TOL)
