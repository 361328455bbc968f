"""What a run loads: never JAX or the JAX package (compared by whole
top-level names: ``flechasdb_tpu_torch`` is the program), and a reference
that loads nothing of the program."""

import subprocess
import sys

from portbench.spec import HERE, REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "flechasdb_tpu")


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print('\\n'.join(sys.modules))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_the_harness_and_every_driver_and_metric_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.core, portbench.control, portbench.tracing\n"
        "import flechasdb_tpu_torch, flechasdb_tpu_torch.serving\n"
        "import flechasdb_tpu_torch.parallel\n"
        "from portbench.spec import load_module, HERE\n"
        "for kind in ('drivers', 'metrics', 'roofline'):\n"
        "    for f in sorted((HERE / kind).glob('*.py')):\n"
        "        load_module(kind, f.stem)\n")
    top = _modules(code)
    assert "flechasdb_tpu_torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    top = _modules("import sys; sys.path.insert(0, '.')\n"
                   "import portbench.reference.judge\n"
                   "import portbench.reference.ivfpq\n"
                   "import portbench.synth, portbench.roofline.adc_scan\n")
    assert not top & {"flechasdb_tpu_torch", *FORBIDDEN}
    for f in (HERE / "reference").glob("*.py"):
        text = f.read_text()
        assert "import flechasdb" not in text and "from flechasdb" \
            not in text, f


def test_the_benchmark_reads_no_old_benchmark_file():
    for f in HERE.rglob("*.py"):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        for old in ("benchmarks/", "bench.py", "BENCH_", "BASELINE",
                    "MULTICHIP_"):
            assert old not in text, (f, old)
