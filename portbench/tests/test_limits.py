"""Every limit lies between the two readings it was set from: above the
program's largest (the lower) and below the control's or a planted
fault's smallest (the upper), so a limit file can be neither swapped
with another cell's nor set from a guess."""

import json

import pytest

from portbench.spec import HERE, REPO

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_limit_lies_between_its_readings(cell):
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    assert limits
    for name, entry in limits.items():
        lower, limit, upper = entry["lower"], entry["limit"], entry["upper"]
        assert lower < limit < upper, (name, entry)
        assert upper >= 3 * lower, (name, entry)
        assert entry["readings"], name
