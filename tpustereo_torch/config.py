"""Frozen configuration for the stereo pipeline (PyTorch port).

A field-for-field copy of the JAX package's `Config`, so that a JAX
config's `dataclasses.asdict` loads here unchanged (see `convert.py`). One
`Config` drives every mode: SAD block matching, census+WTA, and the full SGM
pipeline, plus distribution knobs (strips/halo/batch). The five operating
points ship as named presets in `PRESETS`; the TOML files under `configs/`
load with `Config.from_toml`.

`backend` is kept only so that such dicts load: the port ignores it.
Dispatch follows the device of the input tensors (CUDA kernels for CUDA
tensors, their plain PyTorch versions for CPU tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

try:  # tomllib is stdlib on py3.11+
    import tomllib as _toml
except ImportError:  # pragma: no cover
    _toml = None


@dataclasses.dataclass(frozen=True)
class Config:
    """All knobs of the stereo pipeline. Frozen and hashable."""

    # --- mode -----------------------------------------------------------
    # 'sad'        : SAD block matching + WTA (BASELINE config 1)
    # 'census_wta' : census cost volume + WTA, no aggregation (config 2)
    # 'sgm'        : full SGM pipeline (configs 3-5)
    mode: str = "sgm"

    # --- disparity search -----------------------------------------------
    num_disparities: int = 128  # D, disparity hypotheses [0, D)
    min_disparity: int = 0

    # --- cost ------------------------------------------------------------
    census_window: Tuple[int, int] = (5, 5)  # (height, width), odd; 24 bits
    sad_block: int = 9  # SAD block size (odd), mode='sad'

    # --- SGM aggregation ---------------------------------------------------
    paths: int = 8  # 4 (E,W,N,S) or 8 (+diagonals)
    p1: int = 10
    p2: int = 120
    adaptive_p2: bool = False  # P2' = max(P1+1, P2 // |I(p)-I(p-r)|)

    # --- disparity selection / refinement ---------------------------------
    uniqueness_ratio: int = 10  # percent; 0 disables
    subpixel: bool = True
    disp12_max_diff: int = 1  # LR check threshold in px; <0 disables
    speckle_window_size: int = 100  # component area threshold; 0 disables
    speckle_range: int = 2  # max disparity jump inside a component (in px)
    median_filter: bool = True
    # invalid-pixel gap filling (Hirschmüller 2008 §V; SURVEY.md §1.1):
    # 'off' keeps invalid = -1; 'background' fills each invalid pixel with
    # the LOWER of its nearest valid row neighbours (the occlusion rule —
    # occluded pixels belong to the background surface); 'hirschmuller'
    # first classifies each invalid pixel as occlusion vs mismatch via the
    # epipolar-intersection test on the right-disparity map (needs the LR
    # check enabled), then fills occlusions with the second-lowest and
    # mismatches with the median of the 8-direction nearest valid values.
    # Fills run before the median so the filled map is smoothed like the
    # rest.
    fill_mode: str = "off"

    # --- distribution ------------------------------------------------------
    batch_size: int = 1
    # frames processed per set of kernel launches (pipeline.sgbm_frames
    # takes them as the batch dimension of every kernel, so more frames
    # mean more independent scan lines per launch). Used by sgbm_batched
    # when it evenly divides the batch; 1 = one frame per set. It changes
    # nothing numerically.
    frames_per_step: int = 1
    strips: int = 1  # spatial strip count over the mesh 'strip' axis
    halo: int = 32  # halo rows per strip boundary (halo-approx mode)
    exact_tiling: bool = False  # ring carry hand-off instead of halo approx

    # --- implementation ---------------------------------------------------
    # the JAX package's kernel selector; the port ignores it (see module doc)
    backend: str = "auto"  # 'auto' | 'jnp' | 'pallas'

    def __post_init__(self):
        if self.mode not in ("sad", "census_wta", "sgm"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.paths not in (4, 8):
            raise ValueError("paths must be 4 or 8")
        if self.num_disparities <= 0:
            raise ValueError("num_disparities must be positive")
        if self.num_disparities > 1024:
            # the gather-free packed argmins (ops/wta.py, ops/postproc.py,
            # dist/disp_shard.py) pack value*next_pow2(D)+d into int32;
            # 1024 leaves >2^20 of value headroom for every cost mode
            raise ValueError("num_disparities > 1024 unsupported")
        if self.min_disparity < 0:
            # the search window is [min_disparity, min_disparity + D);
            # negative (verged-camera) offsets are not implemented
            raise ValueError("min_disparity must be >= 0")
        ch, cw = self.census_window
        if ch % 2 == 0 or cw % 2 == 0:
            raise ValueError("census window dims must be odd")
        if ch * cw - 1 > 64:
            raise ValueError("census window larger than 64 bits unsupported")
        if not (0 <= self.p1 <= self.p2):
            raise ValueError("need 0 <= P1 <= P2")
        if self.frames_per_step < 1:
            raise ValueError("frames_per_step must be >= 1")
        if self.fill_mode not in ("off", "background", "hirschmuller"):
            raise ValueError(f"unknown fill_mode {self.fill_mode!r}")
        if self.fill_mode == "hirschmuller" and self.disp12_max_diff < 0:
            # the occlusion/mismatch classification is defined by the LR
            # intersection test; without a threshold it has no semantics
            raise ValueError(
                "fill_mode='hirschmuller' requires disp12_max_diff >= 0")

    # ------------------------------------------------------------------
    @property
    def census_bits(self) -> int:
        ch, cw = self.census_window
        return ch * cw - 1

    @property
    def max_census_cost(self) -> int:
        return self.census_bits

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        d = dict(d)
        if "census_window" in d:
            d["census_window"] = tuple(d["census_window"])
        return cls(**d)

    @classmethod
    def from_toml(cls, path: str, overrides: Optional[Dict[str, Any]] = None) -> "Config":
        if _toml is None:  # pragma: no cover
            raise RuntimeError("tomllib unavailable on this Python")
        with open(path, "rb") as f:
            d = _toml.load(f)
        d.update(overrides or {})
        return cls.from_dict(d)


# The five BASELINE.json operating points (BASELINE.json:7-11; SURVEY.md §1).
PRESETS: Dict[str, Config] = {
    # 1: Block-matching SAD, Tsukuba 384x288, 64 disparities.
    "tsukuba_sad": Config(
        mode="sad", num_disparities=64, sad_block=9, uniqueness_ratio=10,
        subpixel=True, disp12_max_diff=-1, speckle_window_size=0,
        median_filter=False,
    ),
    # 2: Census cost volume + WTA, Middlebury half-res, 128 disparities.
    "middlebury_census_wta": Config(
        mode="census_wta", num_disparities=128, uniqueness_ratio=10,
        subpixel=True, disp12_max_diff=-1, speckle_window_size=0,
        median_filter=False,
    ),
    # 3: SGM 4-path + subpixel + LR check, Middlebury full-res, four frames
    # per set of kernel launches (as the "F=4 b8" rows of BASELINE.md).
    "middlebury_sgm4": Config(
        mode="sgm", paths=4, num_disparities=128, subpixel=True,
        disp12_max_diff=1, speckle_window_size=100, speckle_range=2,
        frames_per_step=4,
    ),
    # 4: SGM 8-path full pipeline, KITTI 2015, batched pairs, four frames
    # per set of kernel launches (one set per frame when the batch is not a
    # multiple of 4).
    "kitti_sgm8": Config(
        mode="sgm", paths=8, num_disparities=128, subpixel=True,
        disp12_max_diff=1, speckle_window_size=100, speckle_range=2,
        batch_size=4, frames_per_step=4,
    ),
    # 5: Multi-host tiled SGM over a KITTI odometry sequence.
    "kitti_odometry": Config(
        mode="sgm", paths=8, num_disparities=128, subpixel=True,
        disp12_max_diff=1, speckle_window_size=100, speckle_range=2,
        strips=2, halo=32,
    ),
}
