"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the repo root. Tests that need the card carry the ``cuda`` marker and skip
without one (decided in the ``card`` fixture, never at import)."""

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return "cuda"


#: A cell's sizes cut to what a CPU test holds; the widths, the shapes of
#: the index and the query parameters stay the configuration's (nprobe a
#: quarter of the partitions at most).
SMALL = {"rows": 12000, "partitions": 32, "query_pool": 600,
         "check_rows": 4096, "coarse_train_cap": 1 << 20,
         "pq_train_cap": 1 << 20}
#: Enough partitions and checked rows for TF32's flips to show in a build.
CONTROL = dict(SMALL, rows=24000, partitions=256, check_rows=24000)


def _bench(root: Path, size: dict) -> Path:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "configs").mkdir()
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(size)
        cfg["nprobe"] = min(cfg["nprobe"], size["partitions"] // 4)
        c["file"] = f"configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root / "BENCHMARK.json"


@pytest.fixture(scope="session")
def small_bench(tmp_path_factory) -> Path:
    """A copy of ``BENCHMARK.json`` whose configurations are cut to
    :data:`SMALL`."""
    return _bench(tmp_path_factory.mktemp("bench"), SMALL)


@pytest.fixture(scope="session")
def control_bench(tmp_path_factory) -> Path:
    """The same cut to :data:`CONTROL`."""
    return _bench(tmp_path_factory.mktemp("control"), CONTROL)
