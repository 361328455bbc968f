"""Every file a cell needs is found by name; a new configuration, mix,
driver or metric is a new file and an entry, with no edit elsewhere."""

import json
import shutil

import pytest

from portbench.spec import HERE, REPO, load_cell, load_driver, load_module


def test_every_cell_of_the_benchmark_resolves():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        assert cell.limits, f"{w['name']} has no limits file"
        load_driver(cell).Driver
        for m in cell.end_to_end + cell.per_layer:
            assert callable(load_module("metrics", m["name"]).read)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_a_new_config_mix_driver_and_metric_are_found(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = {"rows": 5, "dim": 4}
    (root / "configs" / "toy-flat.json").write_text(json.dumps(cfg))
    (root / "mixes" / "burst.json").write_text(json.dumps(
        {"driver": "toy_driver", "batch": 3}))
    (root / "drivers" / "toy_driver.py").write_text(
        "class Driver:\n    MIX_KEYS = ('batch',)\n    found = 'toy'\n")
    (root / "metrics" / "toy.rate.py").write_text(
        "def read(rec):\n    return 42.0\n")
    (root / "limits" / "toy.burst.json").write_text(
        json.dumps({"err": {"limit": 0.5}}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-flat", "source": "x",
                            "file": "portbench/configs/toy-flat.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "toy.burst", "config": "toy-flat",
                              "traffic": "burst", "chips": 1, "why": "x"})
    spec["end_to_end"].append({"name": "toy.rate", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["toy.burst"]})
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))
    cell = load_cell("toy.burst", bench, root)
    assert cell.config == cfg
    assert cell.mix["batch"] == 3
    assert load_driver(cell, root).Driver.found == "toy"
    names = [m["name"] for m in cell.end_to_end]
    assert sorted(names) == ["setup_s", "toy.rate"]
    assert load_module("metrics", "toy.rate", root).read(None) == 42.0
    assert cell.limits == {"err": {"limit": 0.5}}
    # The other cells do not report the new metric.
    assert "toy.rate" not in [m["name"] for m in
                              load_cell("sift1m.build", bench,
                                        root).end_to_end]


def test_a_mix_key_no_driver_reads_is_refused(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    mix = json.loads((root / "mixes" / "serve-policy.json").read_text())
    mix["clients"] = 4
    (root / "mixes" / "serve-policy.json").write_text(json.dumps(mix))
    cell = load_cell("sift1m.serve-policy", REPO / "BENCHMARK.json", root)
    with pytest.raises(ValueError, match="clients"):
        load_driver(cell, root)
