"""BENCHMARK.json against the contract's shape, and a cell, a
configuration, a traffic mix and a per-layer metric added as new files and
entries, found by name without an edit to any existing file."""

import json
import re
import shutil

import pytest
import torch

from portbench.lib import cells
from portbench.run import run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"]
              for k in ("name", "config", "traffic")]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen)), group


def test_shape_of_the_benchmark():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        cell = cells.find(w["name"])
        moved = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in moved and len(moved) >= 2
        assert cell.per_layer, w["name"]
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert (cells.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(cells.reader(m["name"]))


NEW_KIND = """
import time


def drive(cell, dev, t_start):
    t0 = time.perf_counter()
    done = sum(range(cell.traffic["calls"]))
    return {"metrics": {"calls_per_s": cell.traffic["calls"]
                        / max(time.perf_counter() - t0, 1e-9)},
            "setup_s": time.time() - t_start, "attempted": 1, "failed": 0,
            "counts": {"done": done}, "batch": 1}


def numbers(run):
    return {"sum_gap": abs(run["counts"]["done"] - 45)}
"""


def test_additions_need_no_edit(tmp_path):
    """A configuration, a traffic mix of an existing kind, a new kind of
    traffic with its driver, each workload's limits and a per-layer metric
    are found by name, and a cell of the new kind runs to its result line,
    with no existing file changed."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    config = json.loads((root / BENCH["configs"][0]["file"]).read_text())
    config["name"] = "shot-wrn28-2-c10-4k-copy"
    new_config = root / "portbench/configs/shot-wrn28-2-c10-4k-copy.json"
    new_config.write_text(json.dumps(config))
    traffic = json.loads(
        (root / "portbench/traffic/train_epochs.json").read_text())
    traffic["traced_epochs"] = 1
    (root / "portbench/traffic/one_traced_epoch.json").write_text(
        json.dumps(traffic))
    (root / "portbench/lib/count_up.py").write_text(NEW_KIND)
    (root / "portbench/traffic/ten_calls.json").write_text(
        json.dumps({"kind": "count_up", "calls": 10}))
    for name, limits in (("copy.train", {"loss": 1e-3}),
                         ("copy.count", {"sum_gap": 0})):
        (root / f"portbench/limits/{name}.json").write_text(
            json.dumps(limits))
    (root / "portbench/metrics/epochs_seen.py").write_text(
        "def read(run):\n    return run.counts.get('epochs') or None\n")
    (root / "portbench/metrics/done_count.py").write_text(
        "def read(run):\n    return run.counts['done']\n")
    bench["configs"].append(dict(BENCH["configs"][0],
                                 name=config["name"],
                                 file=str(new_config.relative_to(root))))
    bench["workloads"] += [
        {"name": "copy.train", "config": config["name"],
         "traffic": "one_traced_epoch", "chips": 1, "why": "a test"},
        {"name": "copy.count", "config": config["name"],
         "traffic": "ten_calls", "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"]:
        if m["name"].startswith("train_"):
            m["workloads"].append("copy.train")
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["copy.count"]})
    bench["per_layer"] += [
        {"name": "epochs_seen", "unit": "epochs", "better": "higher",
         "source": "host_clock", "layer": "train loop body",
         "moves": "train_img_per_s", "workloads": ["copy.train"]},
        {"name": "done_count", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "a test",
         "moves": "calls_per_s", "workloads": ["copy.count"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.find("copy.train", root)
    assert cell.config["name"] == config["name"]
    assert cell.traffic["traced_epochs"] == 1
    assert cell.limits == {"loss": 1e-3}
    assert "epochs_seen" in [m["name"] for m in cell.per_layer]
    assert cells.driver(cell.traffic["kind"], root).drive

    cell = cells.find("copy.count", root)
    cell.seed = 2**31 + 5
    result, table = run_cell(cell, torch.device("cpu"))
    assert result["correct"] is True and table == {"sum_gap": [0, 0]}
    assert set(result["metrics"]) == {"calls_per_s", "setup_s"}
    assert cells.reader("done_count", root)(
        type("Run", (), {"counts": {"done": 45}})()) == 45
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_every_workload_has_its_limits():
    for w in BENCH["workloads"]:
        cell = cells.find(w["name"])
        assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        cells.find("no-such-cell")
