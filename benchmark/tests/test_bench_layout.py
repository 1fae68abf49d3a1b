"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic and metric files by name, a missing one fails, and
the file keeps to the contract's shape."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness

SPEC = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_finds_its_files(cell):
    c = harness.load_cell(cell)
    assert c.traffic["pool"] % c.traffic["batch"] == 0
    moved = {m["name"] for m in SPEC["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(c.metrics) == {
        m["name"] for m in SPEC["per_layer"]
        if cell in m.get("workloads", [cell] if m["moves"] in moved else [])}
    assert all(m["moves"] in moved for m in SPEC["per_layer"]
               if m["name"] in c.metrics)
    assert callable(c.metrics[next(iter(c.metrics))])


def _against_preset(data: dict) -> list:
    """What keeps a configuration file from its preset's rule: a pinned
    field that differs from the preset and is not listed in `departs`, a
    listed field that is not pinned or equals the preset's, a departure
    without its reason."""
    from tpustereo_torch.config import PRESETS
    preset = PRESETS[data["preset"]]
    cfg = harness.port_config(data)
    departs = data.get("departs", {})
    faults = [f"{k} differs unlisted" for k in data["pinned"]
              if k not in departs and getattr(cfg, k) != getattr(preset, k)]
    for k, why in departs.items():
        if k not in data["pinned"]:
            faults.append(f"{k} listed, not pinned")
        elif getattr(cfg, k) == getattr(preset, k):
            faults.append(f"{k} listed, equal to the preset")
        if not (isinstance(why, str) and why.strip()):
            faults.append(f"{k} without a reason")
    return faults


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_pinned_fields_are_the_presets(config):
    """Every pinned field is the preset's, but those that the file lists
    under `departs`, each with its reason, which are pinned and differ."""
    f = next(c["file"] for c in SPEC["configs"] if c["name"] == config)
    data = json.load(open(os.path.join(harness.ROOT, f)))
    assert _against_preset(data) == []
    assert data["source"] == next(c["source"] for c in SPEC["configs"]
                                  if c["name"] == config)


@pytest.mark.parametrize("change,fault", [
    ({"departs": {}}, "exact_tiling differs unlisted"),
    ({"pinned_halo": 16}, "halo differs unlisted"),
    ({"departs": {"exact_tiling": "", "halo": "wider"}},
     "exact_tiling without a reason"),
    ({"departs": {"exact_tiling": "exact", "halo": "wider"}},
     "halo listed, equal to the preset"),
    ({"departs": {"exact_tiling": "exact", "frames_per_step": "one"}},
     "frames_per_step listed, not pinned")])
def test_a_departure_must_be_stated(change, fault):
    data = json.load(open(os.path.join(
        harness.ROOT, "benchmark", "configs", "kitti_odometry.json")))
    for k, v in change.items():
        if k.startswith("pinned_"):
            data["pinned"][k[len("pinned_"):]] = v
        else:
            data[k] = v
    assert fault in _against_preset(data)


@pytest.mark.parametrize("cell,missing", [
    ("kitti_sgm8.stream-b8", "benchmark/traffic/stream-b8.json"),
    ("kitti_sgm8.stream-b8", "benchmark/configs/kitti_sgm8.json"),
    ("kitti_sgm8.stream-b8", "benchmark/metrics/sweeps_roofline.py"),
    ("kitti_sgm8.api-b8", "benchmark/traffic/api-b8.json"),
    ("kitti_sgm8.api-b8", "benchmark/metrics/api.copy_link_pct.py"),
    ("kitti_odometry.exact-b1", "benchmark/configs/kitti_odometry.json"),
    ("kitti_odometry.exact-b1", "benchmark/traffic/exact-b1.json"),
    ("kitti_odometry.exact-b1", "benchmark/metrics/tiling.ring_roofline.py")])
def test_a_missing_file_fails(tmp_path, cell, missing):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    harness.load_cell(cell, str(tmp_path))
    os.remove(tmp_path / missing)
    with pytest.raises(harness.CellError, match="missing file"):
        harness.load_cell(cell, str(tmp_path))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_traffic_keys(cell):
    """A traffic file holds the harness's keys, `arrays` and `mesh`
    optional."""
    t = harness.load_cell(cell).traffic
    keys = {"entry", "batch", "loop", "clients", "pool", "warmup_calls",
            "trace_frames", "check_megapixels"}
    assert keys <= set(t) <= keys | {"arrays", "mesh"}
    assert harness.arrays(t) in harness.ARRAYS
    assert harness.arrays(t) == ("host" if cell == "kitti_sgm8.api-b8"
                                 else "device")
    assert t.get("mesh", harness.MESHES[0]) in harness.MESHES
    assert harness.resolve_entry(t["entry"]).__module__.startswith(
        "tpustereo_torch.")


def test_every_cell_reports_what_its_metrics_move():
    e2e = {w["name"]: {m["name"] for m in SPEC["end_to_end"]
                       if w["name"] in m.get("workloads", [w["name"]])}
           for w in SPEC["workloads"]}
    for cell, names in e2e.items():
        assert "setup_s" in names and len(names) >= 2
        per = [m for m in SPEC["per_layer"]
               if cell in m.get("workloads", [cell])
               and ("workloads" in m or m["moves"] in names)]
        assert per, cell
        for m in per:
            assert m["moves"] in names, (cell, m["name"])
    for m in SPEC["end_to_end"]:
        assert m["name"].split(".")[0] in harness.END_TO_END


def test_unknown_cell_fails():
    with pytest.raises(harness.CellError):
        harness.load_cell("kitti_sgm8.nothing")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_full_check_fits_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
