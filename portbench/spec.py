"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the one ``configs`` gives it; the mix is
``mixes/<traffic>.json``, which names its driver,
``drivers/<driver>.py`` (which names the mix's keys it reads: any other
key is refused); each metric is read by ``metrics/<metric>.py``;
the limits of the cell's correctness check are ``limits/<cell>.json``.
Adding a configuration, a mix, a driver or a metric is adding its file
and its entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

#: The benchmark's own folder.
HERE = Path(__file__).resolve().parent
#: The checkout the benchmark runs from.
REPO = HERE.parent


def load_module(kind: str, name: str, root: Path = HERE) -> ModuleType:
    """``root/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: The keys of a mix the harness reads itself; a driver names the others
#: it reads in its ``MIX_KEYS``.
MIX_KEYS = ("driver", "trace_seconds")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: str
    mix: dict
    end_to_end: list
    per_layer: list
    limits: dict

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(name: str, bench: Path = REPO / "BENCHMARK.json",
              root: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench``, its files read from ``root`` (and
    the configuration's from the path ``bench`` gives, relative to
    ``bench``'s folder)."""
    spec = _json(bench)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench} "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    limits_path = root / "limits" / f"{name}.json"
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_json(bench.parent / conf["file"]),
                traffic=w["traffic"],
                mix=_json(root / "mixes" / f"{w['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=_json(limits_path) if limits_path.is_file() else {})


def load_driver(cell: Cell, root: Path = HERE) -> ModuleType:
    """The module of ``cell``'s driver, once its mix is known to hold no
    key that neither the harness nor the driver reads: a mix that asks
    for what nothing implements is refused, not run as something else."""
    mod = load_module("drivers", cell.driver, root)
    unread = sorted(set(cell.mix) - set(MIX_KEYS)
                    - set(getattr(mod, "Driver").MIX_KEYS))
    if unread:
        raise ValueError(f"mix {cell.traffic!r} sets {unread}, which driver "
                         f"{cell.driver!r} does not read")
    return mod
