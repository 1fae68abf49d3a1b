"""The port's distribution over several ranks (`torch.distributed`, one
process a rank) on the CPU: 2 and 4 `gloo` ranks started by
`tpustereo_torch.dist.launch` over a `file://` store under the test's
temporary directory (so that parallel test workers never share a port),
each start bounded by its own timeout.

* `dist.sgbm_tiled_batched` over a rank mesh, exact mode (8 and 4 paths,
  adaptive P2, min_disparity, the Hirschmueller fill, SAD, census_wta, the
  volume route, a height that does not divide by the strips) and halo
  mode, against the JAX `sgbm_tiled_batched` on the forced host devices
  (`tests/conftest.py`, `backend="jnp"`) with `test_torch_tiling.py`'s
  bar, and against the port's one-process run bit for bit; exact mode
  also against the untiled `sgbm_batched` bit for bit.
* `dist.sgbm_data_parallel`, `dist.wta_disparity_sharded` and
  `api.run_sequence` (the odometry) over rank meshes against their
  one-process runs, bit for bit.
* `dist.comm`: the halo at the edge strips (against the one-process
  `halo_exchange`), the ring order, the gather, minimum ties and the
  message and byte counters.
* `dryrun_multichip(4)`, and the record arithmetic of
  `run_multihost_bench` (the harness itself, slow, as its JAX
  counterpart).

One start of a cluster runs every case of its size and returns all their
outputs; the clusters run while the JAX references compile. This module
imports no JAX at its top, since each rank imports it to run
`rank_suite`.

Tolerance: integer outputs and the invalid pattern exact; against JAX,
float disparity within 1e-5 (the JAX `tests/test_dist.py` bar); against
the port's own one-process runs, equal bit for bit.
"""

import concurrent.futures
import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from tpustereo_torch import api, dist
from tpustereo_torch.config import PRESETS, Config
from tpustereo_torch.data import synthetic_pair, synthetic_sequence
from tpustereo_torch.dist import comm
from tpustereo_torch.dist.launch import launch
from tpustereo_torch.pipeline import sgbm_batched

W, D = 64, 16
TIMEOUT = 240.0          # seconds for one cluster's start, run and end
TARGET = "tests.test_torch_dist_multirank:rank_suite"

BASE = {"num_disparities": D, "speckle_window_size": 20}
CASES = {
    "exact8": {"paths": 8, "exact_tiling": True},
    "exact_adaptive": {"paths": 4, "exact_tiling": True, "adaptive_p2": True},
    "exact_min_disp": {"paths": 8, "exact_tiling": True, "min_disparity": 3},
    "exact_hirschmuller": {"paths": 8, "exact_tiling": True,
                           "fill_mode": "hirschmuller"},
    "exact_volume": {"paths": 4, "exact_tiling": True, "p2": 1000},
    "sad": {"mode": "sad", "disp12_max_diff": -1, "speckle_window_size": 0,
            "median_filter": False},
    "census_wta": {"mode": "census_wta", "disp12_max_diff": -1,
                   "speckle_window_size": 0, "median_filter": False},
    "census_wta_hirschmuller": {"mode": "census_wta",
                                "fill_mode": "hirschmuller"},
    "halo12": {"paths": 8, "halo": 12},
    "halo_adaptive": {"paths": 4, "halo": 12, "adaptive_p2": True},
    "halo_hirschmuller": {"paths": 8, "halo": 12, "min_disparity": 2,
                          "fill_mode": "hirschmuller"},
    "halo_volume": {"paths": 4, "halo": 12, "p2": 1000},
}
# (ranks, [(rows, (data, strip), [case, ...]), ...]): every case over 2
# strips at 48 rows and exact mode at 45 (not a multiple of 16); over 4
# ranks 45 rows in 4 strips and in (2 data x 2 strips)
TILED = {
    2: [(48, (1, 2), list(CASES)),
        (45, (1, 2), ["exact8", "halo12"])],
    4: [(45, (1, 4), ["exact8", "exact_adaptive", "sad", "halo12"]),
        (45, (2, 2), ["exact8", "census_wta", "halo12"])],
}
# the cases also held to the JAX package (the others match JAX through
# their one-process runs in test_torch_tiling.py)
JAX_CASES = {
    2: [(48, (1, 2), ["exact8", "exact_adaptive", "exact_min_disp",
                      "exact_hirschmuller", "sad", "census_wta",
                      "halo12", "halo_adaptive"]),
        (45, (1, 2), ["exact8", "halo12"])],
    4: [(45, (1, 4), ["exact8"]), (45, (2, 2), ["halo12"])],
}


def _cfg(name: str) -> Config:
    return Config(**{**BASE, **CASES[name]})


def _pairs(rows: int):
    """Two pairs of (rows, W): a slanted plane and its flip."""
    L, R, _, _ = synthetic_pair((rows, W), disparity=6.0, slope=0.05,
                                seed=7)
    return (np.ascontiguousarray(np.stack([L, L[::-1]])),
            np.ascontiguousarray(np.stack([R, R[::-1]])))


def _quad():
    """Four pairs of 48 x W for the data axis."""
    L, R, _, _ = synthetic_pair((48, W), disparity=6.0, slope=0.05, seed=7)
    return (np.ascontiguousarray(np.stack([L, L[::-1], L, L[:, ::-1]])),
            np.ascontiguousarray(np.stack([R, R[::-1], R, R[:, ::-1]])))


def _sequence():
    """`tests/test_torch_dist_odometry.py`'s 64 x 96 sequence."""
    return synthetic_sequence(n_frames=4, shape=(64, 96), depth=8.0,
                              fx=200.0, baseline=0.5, step_x=0.08,
                              slant=0.35, seed=3)


def _odometry_cfg(**kw) -> Config:
    return PRESETS["kitti_odometry"].replace(num_disparities=D,
                                             speckle_window_size=20, **kw)


def _key(name, rows, shape):
    return f"{name}@{rows}:{shape[0]}x{shape[1]}"


# --- what each rank runs ----------------------------------------------------

def _comm_checks(n: int, rank: int) -> dict:
    """dist.comm on this rank: the halo (int32, bool and float32 strips),
    both ring orders, the gather, minimum ties and the counters."""
    out = {}
    x = (torch.arange(2 * 5 * 3, dtype=torch.int32).reshape(2, 5, 3)
         + 1000 * rank)
    comm.reset_counts()
    out["halo"] = comm.exchange_halo(x, 2).tolist()
    out["halo_counts"] = comm.counts()["halo"]
    out["halo_bool"] = comm.exchange_halo(x % 3 == 0, 1).tolist()
    out["halo_float"] = comm.exchange_halo(x.float() / 7, 5).tolist()
    # the ring: each rank appends its index to what the one before it in
    # path order sent, and sends on
    for name, order in (("down", range(n)), ("up", range(n - 1, -1, -1))):
        order = list(order)
        k = order.index(rank)
        got = (comm.recv_carry((k,), torch.int32, order[k - 1]) if k
               else torch.zeros(0, dtype=torch.int32))
        seen = torch.cat([got, torch.tensor([rank], dtype=torch.int32)])
        if k < n - 1:
            comm.send_carry(seen, order[k + 1])
        out[f"ring_{name}"] = seen.tolist()
    comm.reset_counts()
    out["gather"] = comm.all_gather_rows(x).tolist()
    # equal costs on every rank: the packed minimum keeps the smallest d
    cost = torch.full((3,), 5, dtype=torch.int32)
    out["min_tie"] = comm.all_reduce_min(cost * 64 + 10 + rank).tolist()
    out["min_counts"] = comm.counts()["min"]
    out["gather_counts"] = comm.counts()["gather_rows"]
    return out


def rank_suite(spec: dict) -> dict:
    """One rank's share of the module's cases (run by `dist.launch`): the
    outputs go to `rank{r}.npz` under spec["out"], the rest is returned."""
    import torch.distributed as tdist
    rank, n = tdist.get_rank(), tdist.get_world_size()
    arrays, res = {}, {"counts": {}}
    warnings.simplefilter("ignore")      # as `_one_process` does
    for rows, shape, names in TILED[n]:
        lefts, rights = (torch.from_numpy(a) for a in _pairs(rows))
        mesh = dist.make_mesh(*shape, device="cpu")
        for name in names:
            comm.reset_counts()
            key = _key(name, rows, shape)
            arrays[key] = dist.sgbm_tiled_batched(lefts, rights, _cfg(name),
                                                  mesh).numpy()
            res["counts"][key] = comm.counts()
    lefts, rights = (torch.from_numpy(a) for a in _quad())
    cfg = Config(**BASE, paths=4)
    for shape in ((n, 1), (n // 2, 2)):
        arrays[f"dp@{shape[0]}x{shape[1]}"] = dist.sgbm_data_parallel(
            lefts, rights, cfg, dist.make_mesh(*shape, device="cpu")).numpy()
    for mode in ("census_wta", "sad"):
        arrays[f"wta_{mode}"] = dist.wta_disparity_sharded(
            lefts[0], rights[0], Config(**BASE, mode=mode),
            dist.make_mesh(1, n, device="cpu")).numpy()
    if n == 2:
        calib, frames, _ = _sequence()
        for mode, kw in (("halo", {}), ("exact", {"exact_tiling": True})):
            arrays[f"odometry_{mode}"] = api.run_sequence(
                frames, calib, _odometry_cfg(**kw), device="cpu",
                mesh=dist.make_mesh(1, 2, device="cpu"))
    res["comm"] = _comm_checks(n, rank)
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **arrays)
    return res


# --- the clusters and the references ----------------------------------------

def _one_process(name, rows, shape):
    lefts, rights = (torch.from_numpy(a) for a in _pairs(rows))
    mesh = dist.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return dist.sgbm_tiled_batched(lefts, rights, _cfg(name),
                                       mesh).numpy()


def _jax_refs(n: int) -> dict:
    import jax.numpy as jnp

    from tpustereo.config import Config as JConfig
    from tpustereo.dist import make_mesh as j_make_mesh
    from tpustereo.dist import sgbm_tiled_batched as j_tiled_batched
    refs = {}
    for rows, shape, names in JAX_CASES[n]:
        lefts, rights = _pairs(rows)
        for name in names:
            jcfg = JConfig(**{**BASE, **CASES[name], "backend": "jnp"})
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                refs[_key(name, rows, shape)] = np.asarray(j_tiled_batched(
                    jnp.asarray(lefts), jnp.asarray(rights), jcfg,
                    j_make_mesh(*shape)))
    return refs


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """{n: (the ranks' returns, their outputs, the JAX references)} for 2
    and 4 ranks, and the dry run's summary: the three clusters start
    together, then the JAX references compile while they run."""
    from tpustereo_torch.graft_entry import dryrun_multichip
    root = tmp_path_factory.mktemp("ranks")
    futures = {}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for n in (2, 4):
            out = root / f"n{n}"
            out.mkdir()
            futures[n] = pool.submit(
                launch, n, TARGET, {"out": str(out)}, backend="gloo",
                device="cpu", init_method=f"file://{root}/store{n}",
                timeout=TIMEOUT)
        futures["dryrun"] = pool.submit(
            dryrun_multichip, 4, device="cpu", timeout=TIMEOUT,
            init_method=f"file://{root}/store_dryrun")
        refs = {n: _jax_refs(n) for n in (2, 4)}
        runs = {}
        for n in (2, 4):
            res = futures[n].result()
            outs = [dict(np.load(root / f"n{n}" / f"rank{r}.npz"))
                    for r in range(n)]
            runs[n] = (res, outs, refs[n])
        runs["dryrun"] = futures["dryrun"].result()
    return runs


def _same_as_jax(got, ref):
    np.testing.assert_array_equal(got == -1.0, ref == -1.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# --- the tests -------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_tiled_over_ranks_equals_one_process(clusters, n):
    """Every case on every rank: the whole batch, equal to the port's
    one-process `sgbm_tiled_batched` on the same mesh shape bit for bit,
    exact mode also to the untiled `sgbm_batched`."""
    _, outs, _ = clusters[n]
    for rows, shape, names in TILED[n]:
        lefts, rights = (torch.from_numpy(a) for a in _pairs(rows))
        for name in names:
            key = _key(name, rows, shape)
            ref = _one_process(name, rows, shape)
            for r, out in enumerate(outs):
                assert out[key].shape == (2, rows, W), key
                np.testing.assert_array_equal(out[key], ref, err_msg=(
                    f"{key}, rank {r}"))
            cfg = _cfg(name)
            if cfg.exact_tiling or cfg.mode != "sgm":
                np.testing.assert_array_equal(
                    outs[0][key], sgbm_batched(lefts, rights, cfg).numpy(),
                    err_msg=key)


@pytest.mark.parametrize("n", [2, 4])
def test_tiled_over_ranks_matches_jax(clusters, n):
    """The JAX `sgbm_tiled_batched` on the same (data, strip) mesh of
    forced host devices: the invalid pattern exact, disparity within
    1e-5."""
    _, outs, refs = clusters[n]
    assert refs
    for key, ref in refs.items():
        _same_as_jax(outs[0][key], ref)


@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_and_sharded_wta_over_ranks(clusters, n):
    """`sgbm_data_parallel` over (n, 1) and (n / 2, 2) rank meshes equals
    `sgbm_batched`; `wta_disparity_sharded` over n strips equals its
    one-process run (ties across the slices to the smallest d)."""
    _, outs, _ = clusters[n]
    lefts, rights = (torch.from_numpy(a) for a in _quad())
    ref = sgbm_batched(lefts, rights, Config(**BASE, paths=4)).numpy()
    for shape in ((n, 1), (n // 2, 2)):
        for out in outs:
            np.testing.assert_array_equal(out[f"dp@{shape[0]}x{shape[1]}"],
                                          ref)
    for mode in ("census_wta", "sad"):
        want = dist.wta_disparity_sharded(
            lefts[0], rights[0], Config(**BASE, mode=mode),
            dist.make_mesh(1, n, device="cpu")).numpy()
        for out in outs:
            np.testing.assert_array_equal(out[f"wta_{mode}"], want)


@pytest.mark.parametrize("mode", ["halo", "exact"])
def test_odometry_over_two_ranks_equals_one_process(clusters, mode):
    """`api.run_sequence` with kitti_odometry (2 strips) over a 2-rank
    mesh: every rank's trajectory equals the one-process tiled run."""
    _, outs, _ = clusters[2]
    calib, frames, _ = _sequence()
    cfg = _odometry_cfg(**({"exact_tiling": True} if mode == "exact"
                           else {}))
    want = api.run_sequence(frames, calib, cfg, device="cpu")
    for out in outs:
        np.testing.assert_array_equal(out[f"odometry_{mode}"], want)


@pytest.mark.parametrize("n", [2, 4])
def test_comm_halo_ring_gather_min(clusters, n):
    """The wire halo equals the one-process `halo_exchange` of the
    stacked strips (edge rows replicated at the first and last); the ring
    passes through the ranks in path order; the gather stacks the strips
    in rank order; equal costs give the smallest d."""
    res, _, _ = clusters[n]
    strips = torch.stack([torch.arange(2 * 5 * 3, dtype=torch.int32)
                          .reshape(2, 5, 3) + 1000 * r for r in range(n)])
    for halo, key, conv in ((2, "halo", lambda t: t),
                            (1, "halo_bool", lambda t: t % 3 == 0),
                            (5, "halo_float", lambda t: t.float() / 7)):
        want = dist.halo_exchange(conv(strips), halo)
        for r in range(n):
            assert torch.equal(torch.tensor(res[r]["comm"][key]), want[r])
    for r in range(n):
        c = res[r]["comm"]
        assert c["ring_down"] == list(range(r + 1))
        assert c["ring_up"] == list(range(n - 1, r - 1, -1))
        assert torch.equal(torch.tensor(c["gather"]), torch.cat(
            list(strips), -2))
        assert c["min_tie"] == [5 * 64 + 10] * 3


@pytest.mark.parametrize("n", [2, 4])
def test_comm_counts_messages_and_bytes(clusters, n):
    """One message to each neighbour a halo; a gather or a minimum sends
    this rank's piece to each of the n - 1 others; exact mode passes
    carries only across strips, halo mode none."""
    res, _, _ = clusters[n]
    piece = 2 * 5 * 3 * 4
    for r in range(n):
        c = res[r]["comm"]
        edges = (r > 0) + (r < n - 1)
        assert c["halo_counts"] == {"messages": edges,
                                    "bytes": edges * 2 * 2 * 3 * 4}
        assert c["gather_counts"] == {"messages": n - 1,
                                      "bytes": (n - 1) * piece}
        assert c["min_counts"] == {"messages": n - 1,
                                   "bytes": (n - 1) * 3 * 4}
    rows, shape, _ = TILED[n][0]
    counts = res[0]["counts"]
    exact = counts[_key("exact8", rows, shape)]
    strips = shape[1]
    # rank 0 holds the top strip: it sends the down carries of the three
    # down directions, one a direction
    assert exact["carry"]["messages"] == (3 if strips > 1 else 0)
    assert exact["carry"]["bytes"] == 3 * 2 * W * D * 4
    assert counts[_key("halo12", rows, shape)]["carry"]["messages"] == 0
    assert exact["gather_rows"]["messages"] == strips - 1


def test_dryrun_multichip_four_ranks(clusters):
    """`graft_entry.dryrun_multichip(4)`: (data 2, strip 2), exact and
    halo mode and the odometry at 19 rows, on 4 gloo ranks of the CPU."""
    res = clusters["dryrun"]
    assert res["mesh"] == [2, 2]
    assert np.asarray(res["exact"]).shape == (2, 16, 64)
    assert np.isfinite(np.asarray(res["pose"])).all()


def test_mesh_over_ranks_refusals():
    """Outside a world of several ranks make_mesh stays one-process; a
    grid over distinct devices in one process is refused, naming the
    multi-rank form."""
    assert dist.make_mesh(1, 2, device="cpu").ranks is None
    with pytest.raises(NotImplementedError, match="one rank a card"):
        dist.make_mesh(1, 2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="coordinator"):
        dist.init_distributed(None, 2, 0)


def _check_record_consistency(rec):
    """The harness's arithmetic, as tests/test_multihost.py holds the JAX
    record's: efficiency and fps recompute from the recorded
    primitives."""
    fps_1 = rec["global_batch_1host"] / rec["sec_per_step_1host"]
    fps_n = rec["global_batch_nhost"] / rec["sec_per_step_nhost"]
    assert abs(fps_1 - rec["fps_total_1host"]) <= 0.002 * fps_1, rec
    assert abs(fps_n - rec["fps_total_nhost"]) <= 0.002 * fps_n, rec
    eff = rec["fps_total_nhost"] / (rec["hosts"] * rec["fps_total_1host"])
    assert abs(eff - rec["value"]) <= 1e-3, rec
    assert abs(rec["fps_per_host"] - rec["fps_total_nhost"] / rec["hosts"]) \
        <= 0.002 * max(rec["fps_per_host"], 1e-9), rec


def test_multihost_record_arithmetic():
    """`scaling_record` from two ranks' results: the JAX record's keys and
    arithmetic."""
    from tpustereo_torch.eval.multihost import scaling_record
    one = {"fps_total": round(2 / 0.05, 3), "sec_per_step": 0.05,
           "global_batch": 2, "strips": 2, "local_devices": 2,
           "processes": 2, "backend": "cpu", "transport": "gloo",
           "device_kind": "cpu", "ranks_share_a_card": False}
    many = dict(one, fps_total=round(6 / 0.07, 3), sec_per_step=0.07,
                global_batch=6, processes=6)
    cfg = Config(**BASE)
    rec = scaling_record(one, many, 3, cfg, (32, 64), 2, True)
    _check_record_consistency(rec)
    assert rec["metric"] == "multihost tiled scaling efficiency at 3 hosts"
    assert rec["config"] == dataclasses.asdict(cfg)
    assert (rec["hosts"], rec["ranks"], rec["strips"]) == (3, 6, 2)


@pytest.mark.slow
def test_multihost_bench_harness():
    """`run_multihost_bench(2)` end to end on the CPU, data parallel and
    tiled (2 ranks a host): both clusters time-share this machine, so the
    efficiency is only sanity-bounded."""
    from tpustereo_torch.eval.multihost import run_multihost_bench
    cfg = Config(num_disparities=16, paths=4, speckle_window_size=0,
                 median_filter=False, uniqueness_ratio=0, subpixel=False)
    for tiled in (False, True):
        rec = run_multihost_bench(2, cfg, shape=(32, 64), batch=1, iters=2,
                                  timeout=TIMEOUT, tiled=tiled, device="cpu")
        assert rec["hosts"] == 2 and rec["tiled"] == tiled
        assert rec["ranks"] == (4 if tiled else 2)
        assert rec["transport"] == "gloo" and rec["backend"] == "cpu"
        assert 0 < rec["value"] < 10.0, rec
        _check_record_consistency(rec)
