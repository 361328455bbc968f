"""Command-line interface.

Mirrors the reference binary (``src/main.rs:18-29``):

* ``python -m flechasdb_tpu_torch generate [path]`` — build a database from
  5000×1024 normalized random vectors (P=10, D=8, C=25, ``main.rs:31-38``),
  query it, and save it (default path ``testdb``), printing per-phase event
  timings.
* ``python -m flechasdb_tpu_torch load <path>`` — load a stored database and run
  two query rounds to show cold (lazy loads) vs warm latency
  (``main.rs:151-222``), fetching the ``datum_id`` attribute per result.

Timings print in μs like the reference so outputs are directly comparable.

The port of the JAX package's ``__main__.py`` (for the reason given in
:mod:`.errors`), with its seven commands and their output; ops commands
(``verify``, ``gc``, ``publish``, ``resolve``, ``labels``) work on IVF-PQ
and flat trees alike. ``generate`` builds (kernel K-B) and queries (kernel
K-A) on the device, and ``load`` serves cold queries on the host over a
database loaded for that device. The device is a Python argument of
:func:`main`, :func:`generate` and :func:`load` (``"cuda"`` by default);
the command line has no flag for it, as the JAX package's has none.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from . import events as ev
from .build import DatabaseBuilder
from .io import LocalFileSystem
from .serialize import save_database
from .stored import load_database

N, M, D, P, C = 5000, 1024, 8, 10, 25
K, NP = 10, 3


class _Timer:
    """Per-phase event stopwatch (the ``event_time`` pattern in
    ``main.rs:52-94``)."""

    def __init__(self, prefix: str = "") -> None:
        self.t = time.perf_counter()
        self.prefix = prefix

    def restart(self) -> None:
        self.t = time.perf_counter()

    def us(self) -> int:
        return int((time.perf_counter() - self.t) * 1e6)

    def report(self, what: str) -> None:
        print(f"{self.prefix}{what} in {self.us()} μs")


def _build_events(timer: _Timer):
    def handler(e: ev.Event) -> None:
        if isinstance(e, (ev.StartingIdAssignment, ev.StartingPartitioning,
                          ev.StartingSubvectorDivision)):
            timer.restart()
        elif isinstance(e, ev.StartingQuantization) and e.division == 0:
            timer.restart()
        elif isinstance(e, ev.FinishedIdAssignment):
            timer.report("assigned vector IDs")
        elif isinstance(e, ev.FinishedPartitioning):
            timer.report("partitioned data")
        elif isinstance(e, ev.FinishedSubvectorDivision):
            timer.report("divided data")
        elif isinstance(e, ev.FinishedQuantization):
            timer.report(f"quantized division {e.division}")
            timer.restart()
    return handler


def _query_events(timer: _Timer):
    def handler(e: ev.Event) -> None:
        if isinstance(e, (ev.StartingQueryInitialization,
                          ev.StartingPartitionSelection,
                          ev.StartingPartitionQuery,
                          ev.StartingResultSelection)):
            timer.restart()
        elif isinstance(e, ev.FinishedQueryInitialization):
            timer.report("initialized query")
        elif isinstance(e, ev.FinishedPartitionSelection):
            timer.report("selected partitions")
        elif isinstance(e, ev.FinishedPartitionQuery):
            timer.report(f"queried partition {e.partition_index}")
        elif isinstance(e, ev.FinishedResultSelection):
            timer.report("selected results")
    return handler


def generate(path: str = "testdb", device: str = "cuda") -> None:
    rng = np.random.default_rng()
    t = _Timer()
    data = rng.random((N, M), dtype=np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    t.report("prepared data")

    t.restart()
    db = (DatabaseBuilder(data, device=device)
          .with_partitions(P)
          .with_divisions(D)
          .with_clusters(C)
          .build(_build_events(_Timer())))
    t.report("built database")

    for i in range(0, N, 2):  # odd vectors stay attribute-less
        db.set_attribute_at(i, ("datum_id", str(i)))

    qv = rng.random(M, dtype=np.float32)
    qv /= np.linalg.norm(qv)
    t.restart()
    results = db.query_with_events(qv, K, NP, _query_events(_Timer()))
    t.report("queried k-NN")
    for i, r in enumerate(results):
        print(f"{i}: {r}")

    t.restart()
    save_database(db, LocalFileSystem(path))
    t.report("saved database")


def load(path: str, device: str = "cuda") -> None:
    import pathlib

    p = pathlib.Path(path)
    if p.is_dir():  # convenience: a directory with exactly one root manifest
        roots = sorted(p.glob("*.binpb"))
        if (p / "labels" / "latest").is_file():
            # A published store: follow the "latest" label (catalog.py).
            from .catalog import resolve_label
            base = p
            root_name = (resolve_label(LocalFileSystem(p)) + ".binpb")
        elif len(roots) != 1:
            print(f"expected exactly one root manifest in {path} "
                  f"(found {len(roots)}) — or a labels/latest pointer",
                  file=sys.stderr)
            raise SystemExit(1)
        else:
            base, root_name = p, roots[0].name
    else:  # reference form: path to the root .binpb file (main.rs:151-161)
        base, root_name = p.parent, p.name
    print(f"loading database from {path!r}")
    t = _Timer()
    db = load_database(LocalFileSystem(base), root_name, device=device)
    t.report("loaded database")

    rng = np.random.default_rng()
    qv = rng.random(db.vector_size, dtype=np.float32)
    qv /= np.linalg.norm(qv)
    for r in range(2):  # cold then warm (main.rs:165-221)
        t.restart()
        results = db.query_with_events(
            qv, K, NP, _query_events(_Timer(prefix=f"[{r}] ")))
        t.report(f"[{r}] queried k-NN")
        t.restart()
        for i, res in enumerate(results):
            datum_id = res.get_attribute("datum_id")
            print(f"{i}: datum_id={datum_id!r}, {res.vector_id}")
        t.report(f"[{r}] listed results")


def verify(path: str) -> int:
    """Hash-verifies and decodes EVERY artifact of a stored tree.

    Extension ops tool (no reference analogue; the reference's sync
    reader even skips verifying two artifact kinds, ``db/stored.rs:
    729-755`` — this checks everything, like the async tier). Works on
    IVF-PQ and flat trees. Exit 0 = every file matches its
    content-addressed name and parses; 1 = at least one failure.
    """
    import pathlib

    from .errors import FlechasError, InvalidData
    from .protos import PDatabase, PFlatDatabase

    p = pathlib.Path(path)
    if p.is_dir():
        roots = sorted(p.glob("*.binpb"))
        if len(roots) != 1:
            print(f"expected exactly one root manifest in {path}, "
                  f"found {len(roots)}", file=sys.stderr)
            return 1
        base, root_name = p, roots[0].name
    else:
        base, root_name = p.parent, p.name
    fs = LocalFileSystem(base)
    failures = 0

    def check(rel: str, compressed: bool, decode) -> object:
        nonlocal failures
        try:
            f = fs.open_hashed_file(rel, compressed=compressed)
            payload = f.read()
            f.verify()
            msg = decode(payload)
            print(f"ok    {rel}")
            return msg
        except FlechasError as e:
            failures += 1
            print(f"FAIL  {rel}: {type(e).__name__}: {e}")
            return None

    # Root: IVF-PQ first, flat on a structural mismatch.
    f = fs.open_hashed_file(root_name, compressed=True)
    payload = f.read()
    f.verify()
    try:
        root = PDatabase.decode(payload)
        # A valid IVF-PQ root always sets both (load_database enforces
        # it); a flat root has neither field, so they decode as 0.
        flat = root.num_divisions == 0 or root.num_codes == 0
    except FlechasError:
        flat = True
    if flat:
        root = PFlatDatabase.decode(payload)
        if root.vector_size == 0:
            raise InvalidData("root manifest is neither an IVF-PQ nor a "
                              "flat database")
        print(f"ok    {root_name} (flat root)")
        from .protos import PAttributesLog, PFlatChunk
        for cid in root.chunk_ids:
            check(f"chunks/{cid}.binpb", True, PFlatChunk.decode)
        for aid in root.attributes_log_ids:
            check(f"attributes/{aid}.binpb", True, PAttributesLog.decode)
    else:
        print(f"ok    {root_name} (IVF-PQ root)")
        from .protos import PAttributesLog, PPartition
        from .stored import decode_vector_set
        for pid in root.partition_ids:
            check(f"partitions/{pid}.binpb", True, PPartition.decode)
        check(f"partitions/{root.partition_centroids_id}.binpb", False,
              lambda b: decode_vector_set(
                  b, root.vector_size, root.num_partitions,
                  "partition centroids"))
        sub = root.vector_size // root.num_divisions
        for did in root.codebook_ids:
            check(f"codebooks/{did}.binpb", False,
                  lambda b: decode_vector_set(
                      b, sub, root.num_codes, "codebook"))
        for aid in root.attributes_log_ids:
            check(f"attributes/{aid}.binpb", True, PAttributesLog.decode)
        if getattr(root, "rotation_id", ""):
            check(f"rotations/{root.rotation_id}.binpb", False,
                  lambda b: decode_vector_set(
                      b, root.vector_size, root.vector_size, "rotation"))
    if failures:
        print(f"{failures} artifact(s) FAILED verification",
              file=sys.stderr)
        return 1
    print("all artifacts verified")
    return 0


def _referenced(root) -> "set[str]":
    """Relative artifact paths a decoded root manifest points at."""
    refs: set[str] = set()
    if getattr(root, "num_divisions", 0):    # IVF-PQ
        refs.update(f"partitions/{i}.binpb" for i in root.partition_ids)
        refs.add(f"partitions/{root.partition_centroids_id}.binpb")
        refs.update(f"codebooks/{i}.binpb" for i in root.codebook_ids)
        refs.update(f"attributes/{i}.binpb"
                    for i in root.attributes_log_ids)
        if getattr(root, "rotation_id", ""):
            refs.add(f"rotations/{root.rotation_id}.binpb")
    else:                                    # flat
        refs.update(f"chunks/{i}.binpb" for i in root.chunk_ids)
        refs.update(f"attributes/{i}.binpb"
                    for i in root.attributes_log_ids)
    return refs


def _walk_labels(base) -> "list[tuple[str, str | None, bool]]":
    """``(name, target, live)`` for every entry under ``labels/``.

    ``target is None`` marks an unreadable entry (e.g. a stray
    subdirectory); ``live`` says whether ``<target>.binpb`` exists at the
    store's top level. Shared by ``gc`` and ``labels`` so the dangling
    check cannot drift between them (catalog.LABEL_DIR is the one name).
    """
    from .catalog import LABEL_DIR

    ldir = base / LABEL_DIR
    if not ldir.is_dir():
        return []
    out = []
    for lp in sorted(ldir.iterdir()):
        try:
            target = lp.read_bytes().decode("utf-8", "replace").strip()
        except OSError:
            out.append((lp.name, None, False))
            continue
        out.append((lp.name, target, (base / f"{target}.binpb").is_file()))
    return out


def gc(path: str, dry_run: bool = False) -> int:
    """Deletes artifacts no root manifest references.

    The update story (materialize → mutate → re-save) leaves the PREVIOUS
    root's touched partitions orphaned — content addressing never
    overwrites, so stores grow monotonically. Every ``*.binpb`` at the
    store's top level is treated as a live root (keep old roots around
    for time travel; delete a root file first to let gc reap its tree).
    Exit 0 always; ``--dry-run`` only lists.
    """
    import pathlib

    from .errors import InvalidData
    from .protos import PDatabase, PFlatDatabase

    base = pathlib.Path(path)
    fs = LocalFileSystem(base)
    live: set[str] = set()
    roots = sorted(base.glob("*.binpb"))
    if not roots:
        print(f"no root manifests in {path}", file=sys.stderr)
        return 1
    for rp in roots:
        f = fs.open_hashed_file(rp.name, compressed=True)
        payload = f.read()
        f.verify()          # a corrupt root would hide its references
        root = PDatabase.decode(payload)
        if not (root.num_divisions and root.num_codes):
            root = PFlatDatabase.decode(payload)
            if root.vector_size == 0:
                raise InvalidData(
                    f"{rp.name} is neither an IVF-PQ nor a flat root")
        live |= _referenced(root)
        live.add(rp.name)
    freed = 0
    victims = []
    for sub in ("partitions", "codebooks", "attributes", "chunks",
                "rotations"):
        d = base / sub
        if not d.is_dir():
            continue
        for p in sorted(d.glob("*.binpb")):
            rel = f"{sub}/{p.name}"
            if rel not in live:
                victims.append((rel, p.stat().st_size))
    for rel, size in victims:
        freed += size
        print(f"{'would delete' if dry_run else 'deleted'}  {rel} "
              f"({size} B)")
        if not dry_run:
            (base / rel).unlink()
    # Labels are never reaped, but a label whose root file was deleted
    # dangles — surface it (catalog.py).
    for lname, target, lives in _walk_labels(base):
        if target is None:      # e.g. a stray subdirectory under labels/
            print(f"warning: unreadable label entry {lname}",
                  file=sys.stderr)
        elif not lives:
            print(f"warning: label {lname} dangles "
                  f"(root {target} not in store)", file=sys.stderr)
    print(f"{len(victims)} orphaned artifact(s), {freed} bytes"
          f"{' (dry run)' if dry_run else ' freed'}; "
          f"{len(roots)} live root(s)")
    return 0


def publish(path: str, root: str, name: str = "latest") -> int:
    """Points ``labels/<name>`` at a root hash (catalog.py)."""
    from .catalog import publish_label

    publish_label(LocalFileSystem(path), root, name)
    print(f"{name} -> {root}")
    return 0


def resolve(path: str, name: str = "latest") -> int:
    from .catalog import resolve_label

    print(resolve_label(LocalFileSystem(path), name))
    return 0


def labels(path: str) -> int:
    """Lists every label and its target (dangling ones are flagged)."""
    import pathlib

    entries = _walk_labels(pathlib.Path(path))
    if not entries:
        print("no labels", file=sys.stderr)
        return 1
    for lname, target, lives in entries:
        if target is None:
            print(f"warning: unreadable label entry {lname}",
                  file=sys.stderr)
        else:
            print(f"{lname} -> {target}{'' if lives else '  (dangling)'}")
    return 0


def main(argv: list[str], device: str = "cuda") -> int:
    if len(argv) >= 1 and argv[0] == "generate":
        generate(*argv[1:2], device=device)
        return 0
    if len(argv) >= 2 and argv[0] == "load":
        load(argv[1], device=device)
        return 0
    if len(argv) >= 2 and argv[0] == "verify":
        return verify(argv[1])
    if len(argv) >= 2 and argv[0] == "gc":
        return gc(argv[-1], dry_run="--dry-run" in argv[1:-1])
    if len(argv) >= 3 and argv[0] == "publish":
        return publish(argv[1], argv[2], *argv[3:4])
    if len(argv) >= 2 and argv[0] == "resolve":
        return resolve(argv[1], *argv[2:3])
    if len(argv) >= 2 and argv[0] == "labels":
        return labels(argv[1])
    print("usage: python -m flechasdb_tpu_torch "
          "[generate [path] | load <path> | verify <path> | "
          "gc [--dry-run] <path> | publish <path> <root> [name] | "
          "resolve <path> [name] | labels <path>]",
          file=sys.stderr)
    return 1


def _console_entry() -> int:
    """``flechasdb-tpu-torch`` console script (pyproject
    ``[project.scripts]``)."""
    return main(sys.argv[1:])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
