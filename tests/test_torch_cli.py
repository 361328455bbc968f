"""The port's CLI (``python -m flechasdb_tpu_torch``) against the JAX
package's (``flechasdb_tpu/__main__.py``).

The ops commands (``verify``, ``gc``, ``publish``, ``resolve``,
``labels``) print no timings, so on the same tree both packages must
print the same lines and return the same code. ``generate`` and ``load``
run with ``device="cpu"`` here (their output carries timings and an
unseeded corpus, so only its shape is checked); on the card
``chip_smoke.py`` runs them in a subprocess.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flechasdb_tpu_torch as ft
from flechasdb_tpu.__main__ import main as jmain
from flechasdb_tpu_torch.__main__ import main

REPO = Path(__file__).resolve().parent.parent


def _ivfpq(base, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((120, 16)).astype(np.float32)
    db = (ft.DatabaseBuilder(x, device="cpu").with_partitions(4)
          .with_divisions(4).with_clusters(8).with_seed(1).build())
    db.set_attribute_at(0, ("tag", 7))
    return db, ft.save_database(db, ft.LocalFileSystem(base))


def _flat(base, seed=5):
    rng = np.random.default_rng(seed)
    db = ft.FlatDatabase(rng.standard_normal((50, 8)).astype(np.float32),
                         seed=2, device="cpu")
    db.set_attribute_at(1, ("k", "v"))
    return db, ft.save_flat_database(db, ft.LocalFileSystem(base))


def _both(capsys, argv):
    """``(rc, stdout, stderr)`` of the port's ``main`` and then of the JAX
    package's, on the same arguments."""
    out = []
    for run in (lambda: main(argv, device="cpu"), lambda: jmain(argv)):
        rc = run()
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


@pytest.mark.parametrize("kind", ["ivfpq", "flat"])
def test_verify_prints_what_the_jax_cli_prints(kind, tmp_path, capsys):
    (_ivfpq if kind == "ivfpq" else _flat)(tmp_path)
    mine, theirs = _both(capsys, ["verify", str(tmp_path)])
    assert mine == theirs
    assert mine[0] == 0 and "all artifacts verified" in mine[1]
    assert ("flat root" if kind == "flat" else "IVF-PQ root") in mine[1]
    if kind == "ivfpq":     # root + parts + centroids + codebooks + logs
        assert mine[1].count("ok    ") == 1 + 4 + 1 + 4 + 4


@pytest.mark.parametrize("kind", ["ivfpq", "flat"])
def test_verify_catches_a_changed_byte(kind, tmp_path, capsys):
    (_ivfpq if kind == "ivfpq" else _flat)(tmp_path)
    sub = "partitions" if kind == "ivfpq" else "chunks"
    victim = sorted((tmp_path / sub).glob("*.binpb"))[0]
    blob = bytearray(victim.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    victim.write_bytes(bytes(blob))
    mine, theirs = _both(capsys, ["verify", str(tmp_path)])
    assert mine == theirs
    assert mine[0] == 1 and "FAIL" in mine[1]
    assert "FAILED verification" in mine[2]


def test_verify_rejects_an_ambiguous_directory(tmp_path, capsys):
    (tmp_path / "a.binpb").write_bytes(b"x")
    (tmp_path / "b.binpb").write_bytes(b"y")
    mine, theirs = _both(capsys, ["verify", str(tmp_path)])
    assert mine == theirs and mine[0] == 1


def test_gc_dry_run_then_reap(tmp_path, capsys):
    db, root = _ivfpq(tmp_path)
    mem = ft.load_database(ft.LocalFileSystem(tmp_path), f"{root}.binpb",
                           device="cpu").to_database()
    mem.add_vectors(np.random.default_rng(9).standard_normal(
        (5, 16)).astype(np.float32), seed=3)
    root2 = ft.save_database(mem, ft.LocalFileSystem(tmp_path))
    mine, theirs = _both(capsys, ["gc", str(tmp_path)])
    assert mine == theirs and "0 orphaned" in mine[1]   # both roots live
    (tmp_path / f"{root}.binpb").unlink()
    before = sorted(tmp_path.rglob("*.binpb"))
    mine, theirs = _both(capsys, ["gc", "--dry-run", str(tmp_path)])
    assert mine == theirs and "would delete" in mine[1]
    assert sorted(tmp_path.rglob("*.binpb")) == before
    assert main(["gc", str(tmp_path)], device="cpu") == 0
    out = capsys.readouterr().out
    assert "deleted" in out and "0 orphaned" not in out
    assert main(["verify", str(tmp_path)]) == 0
    capsys.readouterr()
    sdb = ft.load_database(ft.LocalFileSystem(tmp_path), f"{root2}.binpb",
                           device="cpu")
    assert len(sdb.query(np.zeros(16, np.float32), k=3, nprobe=4)) == 3
    mine, theirs = _both(capsys, ["gc", str(tmp_path)])
    assert mine == theirs and "0 orphaned" in mine[1]


def test_gc_on_a_flat_tree(tmp_path, capsys):
    db, root = _flat(tmp_path)
    mem = ft.load_flat_database(ft.LocalFileSystem(tmp_path),
                                f"{root}.binpb", device="cpu").to_database()
    mem.append(np.ones((4, 8), np.float32))
    ft.save_flat_database(mem, ft.LocalFileSystem(tmp_path))
    (tmp_path / f"{root}.binpb").unlink()
    mine, theirs = _both(capsys, ["gc", "--dry-run", str(tmp_path)])
    assert mine == theirs and "would delete" in mine[1]
    assert main(["gc", str(tmp_path)]) == 0
    assert main(["verify", str(tmp_path)]) == 0
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "x.binpb").write_bytes(b"not a root")
    with pytest.raises(ft.IOError_, match="zlib"):
        main(["gc", str(tmp_path / "bad")])


def test_publish_resolve_and_labels(tmp_path, capsys):
    _, root = _ivfpq(tmp_path)
    mine, theirs = _both(capsys, ["labels", str(tmp_path)])
    assert mine == theirs and mine[0] == 1 and "no labels" in mine[2]
    for argv in (["publish", str(tmp_path), root],
                 ["publish", str(tmp_path), root, "stable"],
                 ["resolve", str(tmp_path)],
                 ["resolve", str(tmp_path), "stable"],
                 ["labels", str(tmp_path)]):
        mine, theirs = _both(capsys, argv)
        assert mine == theirs and mine[0] == 0
    assert mine[1] == f"latest -> {root}\nstable -> {root}\n"
    (tmp_path / f"{root}.binpb").rename(tmp_path / "retired")
    mine, theirs = _both(capsys, ["labels", str(tmp_path)])
    assert mine == theirs and "(dangling)" in mine[1]
    mine, theirs = _both(capsys, ["gc", "--dry-run", str(tmp_path)])
    assert mine[:2] == theirs[:2]


def test_generate_then_load_on_the_cpu(tmp_path, capsys):
    assert main(["generate", str(tmp_path / "db")], device="cpu") == 0
    out = capsys.readouterr().out
    for line in ("prepared data", "built database", "queried k-NN",
                 "saved database", "quantized division 7"):
        assert line in out, line
    assert sum(line[:3] in {f"{i}: " for i in range(10)}
               for line in out.splitlines()) == 10
    roots = list((tmp_path / "db").glob("*.binpb"))
    assert len(roots) == 1
    assert main(["load", str(tmp_path / "db")], device="cpu") == 0
    out = capsys.readouterr().out
    assert "loaded database" in out and "[1] queried k-NN" in out
    assert out.count("datum_id=") == 20          # two rounds of 10
    # the JAX CLI loads the port's tree and verifies it
    assert jmain(["verify", str(tmp_path / "db")]) == 0
    # the reference form: the root file itself; a published store
    assert main(["load", str(roots[0])], device="cpu") == 0
    ft.publish_label(ft.LocalFileSystem(tmp_path / "db"), roots[0].stem)
    assert main(["load", str(tmp_path / "db")], device="cpu") == 0
    assert "loading database" in capsys.readouterr().out


def test_generate_on_a_missing_cuda_device_raises(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("holds only where CUDA is missing")
    with pytest.raises((RuntimeError, AssertionError)):
        main(["generate", str(tmp_path / "db")])
    assert not (tmp_path / "db").exists()


def test_load_rejects_a_directory_of_several_roots(tmp_path, capsys):
    (tmp_path / "a.binpb").write_bytes(b"x")
    (tmp_path / "b.binpb").write_bytes(b"y")
    with pytest.raises(SystemExit) as e:
        main(["load", str(tmp_path)], device="cpu")
    assert e.value.code == 1
    assert "expected exactly one root manifest" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["nope"], ["load"], ["publish", "x"]])
def test_usage_message(argv, capsys):
    mine, theirs = _both(capsys, argv)
    assert mine[0] == theirs[0] == 1
    assert mine[2] == theirs[2].replace("python -m flechasdb_tpu ",
                                        "python -m flechasdb_tpu_torch ")
    assert mine[2].startswith("usage: python -m flechasdb_tpu_torch ")


def test_console_entry_and_module_run(tmp_path):
    _ivfpq(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "flechasdb_tpu_torch", "verify",
         str(tmp_path)], capture_output=True, text=True, cwd=REPO,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "all artifacts verified" in out.stdout
    from flechasdb_tpu_torch.__main__ import _console_entry
    assert callable(_console_entry)
