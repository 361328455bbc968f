"""The port's multi-rank scale-out (``flechasdb_tpu_torch.parallel``,
``ShardedIndex``, ``preload(mesh=)``, ``with_mesh``) against the JAX
package's sharded paths (``tests/test_parallel.py``,
``tests/test_multihost.py``), on the CPU.

The JAX side runs here, on its 8-device CPU mesh. The port's side runs in
gloo worlds of 4 and of 3 ranks (3 so that N and P do not divide), each
started once for the module: every rank is a process running
``tests/_torch_mesh_worker.py`` on the inputs this module made from seeds
with numpy, and writes its results as ``.npz``. A world of one runs in
this process. Tolerances: sharded queries against the JAX package's on
the same index arrays, distances within rel 1e-4, abs 1e-5, rows up to
exact ties, no pad row; sharded builds against the port's own
``_build_fn`` on the same generators, indices and codes equal,
centroids within rel 1e-4, abs 1e-5; a world of one bit-equal.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flechasdb_tpu as fdb
import flechasdb_tpu_torch as ft
from _torch_helpers import (cuda, midpoint_radius, same_range,  # noqa: F401
                            same_ranked, world_of_one)
from flechasdb_tpu.parallel import corpus_mesh as jax_mesh

HERE = Path(__file__).parent
WORLDS = (4, 3)
RTOL, ATOL = 1e-4, 1e-5


def _index(rng, n, m, p, d, c):
    """A random IVF-PQ index, as ``tests/test_parallel.py`` makes one."""
    return {"cents": rng.standard_normal((p, m)).astype(np.float32),
            "books": rng.standard_normal((d, c, m // d)).astype(np.float32),
            "codes": rng.integers(0, c, (n, d)).astype(np.int32),
            "pidx": rng.integers(0, p, n).astype(np.int32)}


def _inputs() -> dict:
    inp = {}

    def index(pre, seed, n, m, p, d, c, b):
        rng = np.random.default_rng(seed)
        for key, v in _index(rng, n, m, p, d, c).items():
            inp[pre + key] = v
        inp[pre + "q"] = rng.standard_normal((b, m)).astype(np.float32)
        return rng

    index("mq_", 1, 512, 64, 8, 4, 16, 5)
    index("mu_", 2, 509, 64, 8, 4, 16, 3)
    index("bq_", 3, 700, 64, 13, 4, 16, 6)           # P=13: pad partitions
    inp["bm_mask"] = index("bm_", 4, 600, 32, 8, 4, 16, 4).random(600) < 0.5
    index("si_", 5, 800, 64, 8, 4, 16, 5)
    inp["rg_mask"] = index("rg_", 6, 700, 32, 8, 4, 16, 3).random(700) < 0.6
    rng = index("ov_", 7, 400, 16, 4, 4, 8, 2)
    inp["ov_books"][0, 3] = 3e19         # ‖r − c‖² overflows f32 to +inf
    inp["ov_codes"][::5, 0] = 3
    for pre, seed, n, m in (("be_", 10, 256, 32), ("bm_", 11, 128, 16),
                            ("bk_", 12, 256, 128), ("bu_", 13, 251, 16),
                            ("bp_", 14, 512, 16), ("bc_", 15, 512, 16),
                            ("mh_", 16, 64 * 8 + 3, 32), ("fl_", 17, 501, 32),
                            ("ex_", 18, 501, 32), ("st_", 19, 600, 32)):
        inp[pre + "x"] = np.random.default_rng(seed).standard_normal(
            (n, m)).astype(np.float32)
    rng = np.random.default_rng(20)
    inp["cap_x"] = rng.standard_normal((1, 256, 16)).astype(np.float32)
    inp["fg_x"] = rng.standard_normal((4, 96, 16)).astype(np.float32)
    inp["ex_q"] = rng.standard_normal((4, 32)).astype(np.float32)
    inp["ex_mask"] = rng.random(501) < 0.5
    inp["mh_q"] = rng.standard_normal((4, 32)).astype(np.float32)
    inp["fl_q"] = rng.standard_normal((6, 32)).astype(np.float32)
    inp["st_q"] = inp["st_x"][:16]
    inp["rr_x"] = rng.standard_normal((500, 24)).astype(np.float32)
    inp["rr_q"] = rng.standard_normal((4, 24)).astype(np.float32)
    inp["rr_rows"] = np.stack([rng.choice(500, 16, replace=False)
                               for _ in range(4)]).astype(np.int64)
    valid = rng.random((4, 16)) < 0.8
    valid[:, :6] = True
    inp["rr_valid"] = valid
    inp["sm_x"] = rng.standard_normal((40_000, 32)).astype(np.float32)
    keys = ((inp["fl_x"] - inp["fl_q"][0]) ** 2).sum(axis=1)
    inp["fl_radius"] = np.asarray(midpoint_radius(keys, 0.05))
    return inp


def _trees(inp, work: Path) -> None:
    """The stored trees the ranks preload: an IVF-PQ database and a flat
    one, saved by the port."""
    db = (ft.DatabaseBuilder(inp["st_x"], device="cpu").with_partitions(6)
          .with_divisions(4).with_clusters(16).with_seed(8).build())
    (work / "ivf_root").write_text(
        ft.save_database(db, ft.LocalFileSystem(work / "ivf")))
    flat = ft.FlatDatabase(inp["fl_x"], seed=4, device="cpu")
    (work / "flat_root").write_text(
        ft.save_flat_database(flat, ft.LocalFileSystem(work / "flat")))


def _spawn(world: int, work: Path) -> list:
    env = dict(os.environ)
    repo = str(HERE.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p and p != repo])
    env["OMP_NUM_THREADS"] = "1"
    return [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_mesh_worker.py"), str(r),
         str(world), str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds' results: ``(inputs, {world: [rank 0's, rank 1's,
    ...]}, the directory of the stored trees)``. A rank that fails or
    outlives the deadline fails the module."""
    work = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    np.savez(work / "inputs.npz", **inp)
    _trees(inp, work)
    procs = {w: _spawn(w, work) for w in WORLDS}
    deadline = time.time() + 300
    logs = {}
    try:
        for w, ps in procs.items():
            for r, pr in enumerate(ps):
                logs[w, r] = pr.communicate(
                    timeout=max(5.0, deadline - time.time()))[0]
    finally:
        for ps in procs.values():
            for pr in ps:
                if pr.poll() is None:
                    pr.kill()
    for (w, r), log in logs.items():
        assert procs[w][r].returncode == 0, \
            f"world {w} rank {r} exited {procs[w][r].returncode}:\n{log}"
    out = {}
    for w in WORLDS:
        out[w] = []
        for r in range(w):
            with np.load(work / f"w{w}_r{r}.npz") as f:
                out[w].append(dict(f))
    return inp, out, work


@pytest.fixture(scope="module")
def mesh():
    return jax_mesh(jax.devices("cpu"))


def _case(run, world, name):
    """Rank 0's results of one case, keys without the case prefix."""
    pre = name + "/"
    return {k[len(pre):]: v for k, v in run[1][world][0].items()
            if k.startswith(pre)}


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jax_index(inp, pre):
    return _j(*(inp[pre + s] for s in ("q", "cents", "books")))


# -- the worlds ---------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_results(run, world):
    """Every sharded output is replicated: each rank's arrays are rank
    0's, bit for bit (centroids included)."""
    ranks = run[1][world]
    for other in ranks[1:]:
        for key, want in ranks[0].items():
            if key.split("/")[-1].startswith(("ref", "local")):
                continue            # rank 0's references, each rank's own
            np.testing.assert_array_equal(other[key], want, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_no_rank_imported_jax(run, world):
    for rank in run[1][world]:
        assert rank["imported"].size == 0, rank["imported"]


# -- masked queries (test_parallel.py:36-79) -----------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_query_matches_single_device(run, mesh, world):
    from flechasdb_tpu.parallel import query_sharded, shard_corpus

    inp = run[0]
    codes_s, pidx_s = shard_corpus(mesh, inp["mq_codes"], inp["mq_pidx"])
    q, cents, books = _jax_index(inp, "mq_")
    want = query_sharded(q, cents, books, codes_s, pidx_s, mesh=mesh, k=10,
                         nprobe=3)
    got = _case(run, world, "masked")
    same_ranked(got["0"], got["1"], np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_array_equal(got["2"], np.asarray(want[2]))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_query_unpadded_corpus(run, mesh, world):
    from flechasdb_tpu.parallel import query_sharded, shard_corpus

    inp = run[0]
    codes_s, pidx_s = shard_corpus(mesh, inp["mu_codes"], inp["mu_pidx"])
    want = query_sharded(*_jax_index(inp, "mu_"), codes_s, pidx_s,
                         mesh=mesh, k=7, nprobe=8)
    got = _case(run, world, "unpadded")
    same_ranked(got["0"], got["1"], np.asarray(want[0]), np.asarray(want[1]))
    assert np.all(got["1"] < 509)


# -- builds (test_parallel.py:82-250, 446-470, 532-552) ---------------------------

def _inertia(x, cents, pidx) -> float:
    return float(((x - cents[pidx.astype(np.int64)]) ** 2).sum())


def _same_build(got, rtol=RTOL, atol=ATOL):
    """The sharded build against the port's ``_build_fn`` on the same
    generators: indices and codes equal, centroids and codebooks close."""
    for i in (0, 2):
        np.testing.assert_allclose(got[str(i)], got[f"ref{i}"], rtol=rtol,
                                   atol=atol)
    for i in (1, 3):
        assert got[str(i)].dtype == got[f"ref{i}"].dtype
        np.testing.assert_array_equal(got[str(i)], got[f"ref{i}"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_build_end_to_end(run, mesh, world):
    """Shapes and ranges, self-query hits, and the JAX package's sharded
    build on the same rows in quality: hits and coarse inertia."""
    from flechasdb_tpu.parallel import build_sharded

    inp = run[0]
    x = inp["be_x"]
    got = _case(run, world, "build_e2e")
    assert got["0"].shape == (4, 32) and got["2"].shape == (4, 8, 8)
    assert got["3"].shape == (256, 4) and got["3"].dtype == np.uint8
    assert got["1"].dtype == np.uint16 and got["1"].max() < 4
    assert got["3"].max() < 8
    hits = (got["hits"][:, 0] == np.arange(8)).mean()
    assert hits >= 0.5
    theirs = build_sharded(x, 4, 4, 8, jax.random.key(7), mesh=mesh)
    assert _inertia(x, got["0"], got["1"]) <= 1.05 * _inertia(
        x, np.asarray(theirs.partition_centroids),
        np.asarray(theirs.partition_indices))
    _same_build(got)


@pytest.mark.parametrize("case", ["build_match", "build_unpadded",
                                  "build_round"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_build_matches_unsharded(run, world, case):
    """``_build_fn`` on the same generators: the default kernel, N that
    the world does not divide (251), and K-B forced (``impl="round"``,
    the JAX package's fused-kernel case)."""
    _same_build(_case(run, world, case))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_build_pq_cap_engaged(run, world):
    got = _case(run, world, "build_pq_cap")
    _same_build(got)
    assert got["3"].shape == (512, 2)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_build_coarse_cap_engaged(run, world):
    _same_build(_case(run, world, "build_coarse_cap"))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cap_path_resolves_kernel_from_local_block(run, world):
    """``fit_sharded(train_cap=)`` resolves its kernel once, against the
    rank's own block, and fits as ``kmeans.fit`` does."""
    got = _case(run, world, "cap_resolve")
    for rank in run[1][world]:
        seen = rank["cap_resolve/local_seen"]
        assert seen.size >= 1 and seen.max() <= -(-256 // world)
    np.testing.assert_allclose(got["0"], got["ref0"], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got["1"], got["ref1"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_grouped_kernel_matches(run, mesh, world):
    """K-C's path (m=16) sharded against the single-device fit, at the
    JAX package's bars, and in inertia against the JAX sharded fit."""
    from flechasdb_tpu.parallel.kmeans import fit_sharded

    inp = run[0]
    got = _case(run, world, "fit_grouped")
    np.testing.assert_allclose(got["0"], got["ref0"], rtol=1e-3, atol=1e-4)
    assert (got["1"] == got["ref1"]).mean() >= 0.99
    x = inp["fg_x"]
    pad = (-x.shape[1]) % mesh.devices.size
    theirs = fit_sharded(jnp.pad(jnp.asarray(x), ((0, 0), (0, pad), (0, 0))),
                         6, jax.random.key(5), mesh=mesh, n_valid=96,
                         impl="pallas_grouped")
    tc = np.asarray(theirs.centroids)
    ti = np.asarray(theirs.indices)[:, :96]
    mine = sum(_inertia(x[b], got["0"][b], got["1"][b]) for b in range(4))
    assert mine <= 1.05 * sum(_inertia(x[b], tc[b], ti[b]) for b in range(4))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_build_fast_suffix(run, world):
    """``round_fast`` equals the single-device fast build, and agrees with
    the full-precision build at the JAX package's bar; bare ``_fast``
    resolves to the same kernel."""
    fast = _case(run, world, "build_fast")
    _same_build(fast)
    assert fast["3"].dtype == np.uint8
    full = _case(run, world, "build_round")
    assert (fast["1"] == full["1"]).mean() >= 0.98
    bare = _case(run, world, "build_fast_bare")
    assert (bare["1"] == fast["1"]).mean() >= 0.98


# -- exact and rerank (test_parallel.py:253-272, 420-443) ---------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_sharded_exact_matches_single_device(run, mesh, world):
    from flechasdb_tpu.parallel import exact_sharded, shard_flat
    from flechasdb_tpu.parallel.mesh import shard_mask

    inp = run[0]
    xs, n = shard_flat(mesh, inp["ex_x"])
    q = jnp.asarray(inp["ex_q"])
    for case, mask in (("exact", None),
                       ("exact_mask", shard_mask(mesh, inp["ex_mask"]))):
        want = exact_sharded(q, xs, mask, mesh=mesh, k=9, n=n)
        got = _case(run, world, case)
        same_ranked(got["0"], got["1"], np.asarray(want[0]),
                    np.asarray(want[1]))
        assert np.all(got["1"] < 501)
    rows = _case(run, world, "exact_mask")["1"]
    assert inp["ex_mask"][rows].all()


@pytest.mark.parametrize("world", WORLDS)
def test_rerank_sharded_matches_exact(run, mesh, world):
    from flechasdb_tpu.parallel import rerank_sharded, shard_flat

    inp = run[0]
    xs, _ = shard_flat(mesh, inp["rr_x"])
    got = _case(run, world, "rerank")
    for metric in ("l2", "dot"):
        want = rerank_sharded(*_j(inp["rr_q"], inp["rr_rows"],
                                  inp["rr_valid"]), xs, mesh=mesh, k=6,
                              metric=metric)
        np.testing.assert_allclose(got[metric + "0"], np.asarray(want[0]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got[metric + "1"], np.asarray(want[1]))


# -- bucketed serving (test_parallel.py:305-417) ---------------------------------

def _jax_buckets(inp, pre, mesh):
    from flechasdb_tpu.ops.bucketed import bucketize
    from flechasdb_tpu.parallel.bucketed import shard_buckets

    return shard_buckets(mesh, bucketize(
        inp[pre + "codes"], inp[pre + "pidx"], len(inp[pre + "cents"]),
        pack="auto"))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bucketed_matches_single_device(run, mesh, world):
    from flechasdb_tpu.parallel.bucketed import query_bucketed_sharded

    inp = run[0]
    want = query_bucketed_sharded(*_jax_index(inp, "bq_"),
                                  _jax_buckets(inp, "bq_", mesh), mesh=mesh,
                                  k=9, nprobe=5)
    got = _case(run, world, "bucketed")
    same_ranked(got["0"], got["1"], np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_array_equal(got["2"], np.asarray(want[2]))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bucketed_row_mask(run, mesh, world):
    from flechasdb_tpu.parallel.bucketed import query_bucketed_sharded

    inp = run[0]
    mask = inp["bm_mask"]
    want = query_bucketed_sharded(*_jax_index(inp, "bm_"),
                                  _jax_buckets(inp, "bm_", mesh), None,
                                  jnp.asarray(mask), mesh=mesh, k=7, nprobe=8)
    got = _case(run, world, "bucketed_mask")
    same_ranked(got["0"], got["1"], np.asarray(want[0]), np.asarray(want[1]))
    assert mask[got["1"][np.isfinite(got["0"])]].all()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_index_bucketed_layout(run, mesh, world):
    from flechasdb_tpu.serving import ShardedIndex

    inp = run[0]
    args = [inp["si_" + s] for s in ("cents", "books", "codes", "pidx")]
    want = ShardedIndex(*args, mesh=mesh).query(inp["si_q"], k=6, nprobe=4)
    got = _case(run, world, "index_bucketed")
    assert str(got["layout"]) == "sharded-bucketed"
    same_ranked(got["0"], got["1"], want[0], want[1])
    np.testing.assert_array_equal(got["2"], want[2])


@pytest.mark.parametrize("layout", ["bucketed", "masked"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_range_matches_single_device(run, mesh, world, layout):
    """``ShardedIndex.query_range`` against the JAX package's on both
    layouts, with and without a row mask, at the port's radius."""
    from flechasdb_tpu.serving import ShardedIndex

    inp = run[0]
    args = [inp["rg_" + s] for s in ("cents", "books", "codes", "pidx")]
    got = _case(run, world, "range")
    theirs = ShardedIndex(*args, layout=layout, mesh=mesh)
    radius = float(got[layout + "_radius"])
    for tag, rm in (("all", None), ("mask", inp["rg_mask"])):
        want = theirs.query_range(inp["rg_q"], radius, nprobe=8, row_mask=rm)
        mine = [(got[f"{layout}_{tag}_{i}_rows"],
                 got[f"{layout}_{tag}_{i}_keys"]) for i in range(3)]
        same_range(mine, want)
        if rm is not None:
            assert all(rm[rows].all() for rows, _ in mine)


@pytest.mark.parametrize("world", WORLDS)
def test_range_keeps_a_row_whose_key_overflows(run, world):
    """A kept slot whose ADC key overflows to ``+inf`` keeps its row, as
    the single-device ``range_bucketed`` keeps it (ADVICE.md:5): rows and
    keys equal to it, slot for slot."""
    got = _case(run, world, "range_overflow")
    assert np.isinf(got["0"]).any() and (got["1"] >= 0).any()
    overflow = np.isinf(got["0"]) & (got["1"] >= 0)
    assert overflow.any()
    for i in range(3):
        np.testing.assert_array_equal(got[str(i)], got[f"ref{i}"])


# -- the stored and flat tiers, the streamed build ---------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_stored_database_sharded_serving(run, world, tmp_path):
    """``StoredDatabase.preload(mesh=)`` of the port's tree serves what the
    JAX package's ``preload()`` of the same tree serves."""
    inp = run[0]
    got = _case(run, world, "stored")
    assert str(got["layout"]).startswith("sharded")
    base = run[2]
    theirs = fdb.load_database(fdb.LocalFileSystem(base / "ivf"),
                               (base / "ivf_root").read_text() + ".binpb")
    theirs.preload()
    want = theirs.query_batch(inp["st_q"], k=5, nprobe=3)
    for b, rs in enumerate(want):
        assert list(got["ids"][b]) == [str(r.vector_id) for r in rs]
        np.testing.assert_allclose(got["dists"][b],
                                   [r.squared_distance for r in rs],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_flat_preload_mesh_matches_jax(run, world):
    """Both flat tiers' ``preload(mesh=)`` serve the JAX package's exact
    results and range hits on the same vectors."""
    inp = run[0]
    got = _case(run, world, "flat")
    theirs = fdb.FlatDatabase(inp["fl_x"], seed=4)
    want = theirs.query_batch(inp["fl_q"], k=7)
    want_d = np.asarray([[r.squared_distance for r in rs] for rs in want])
    want_r = np.asarray([[r.vector_index for r in rs] for rs in want])
    hits = [r.vector_index for r in
            theirs.query_range(inp["fl_q"][0], float(inp["fl_radius"]))]
    for tier in ("mem", "stored"):
        same_ranked(got[tier + "_dists"], got[tier + "_rows"], want_d,
                    want_r)
        np.testing.assert_array_equal(got[tier + "_range"], hits)


@pytest.mark.parametrize("world", WORLDS)
def test_streamed_build_sharded_encode_matches(run, world):
    """``with_mesh``: partition indices and codes bit-identical to the
    unsharded streamed build (chunks of 35,000 rows, so that blocks of
    whole 16,384-row units split them), the same ids and training."""
    got = _case(run, world, "streamed")
    for key in ("pidx", "codes", "cents", "books", "ids"):
        np.testing.assert_array_equal(got[key], got["ref_" + key],
                                      err_msg=key)


# -- the two-process check (test_multihost.py) ------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_multiprocess_world_matches_single_program(run, world):
    """The JAX package's multi-process check: a sharded build, then the
    masked, bucketed and exact queries and a rerank across process
    boundaries, each against the single-device op on rank 0."""
    got = _case(run, world, "multiprocess")
    assert got["build0"].shape == (4, 32) and got["build3"].shape == (515, 4)
    for name in ("masked", "bucketed", "exact"):
        same_ranked(got[name + "0"], got[name + "1"], got[f"ref_{name}0"],
                    got[f"ref_{name}1"])
    np.testing.assert_array_equal(got["masked2"], got["ref_masked2"])
    np.testing.assert_allclose(got["rerank0"], got["exact0"][:, :3],
                               rtol=RTOL, atol=ATOL)


# -- a world of one, in this process ------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(pq_cap=128, coarse_cap=128), dict(impl="round"),
    dict(impl="round_fast"), dict(impl="_fast", pq_cap=100)])
def test_world_of_one_is_bit_equal_to_build_fn(world_of_one, kw):
    from flechasdb_tpu_torch.parallel import build_sharded
    from flechasdb_tpu_torch.parallel.build import _build_fn

    x = np.random.default_rng(31).standard_normal((300, 16)) \
        .astype(np.float32)
    got = build_sharded(x, 4, 2, 8, 5, mesh=world_of_one, **kw)
    want = _build_fn(x, 5, p=4, d=2, c=8, device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("impl", [None, "grouped", "grouped_fast"])
@pytest.mark.parametrize("cap", [None, 64])
def test_world_of_one_fit_is_bit_equal(world_of_one, impl, cap):
    from flechasdb_tpu_torch.ops import kmeans
    from flechasdb_tpu_torch.parallel import fit_sharded

    x = torch.as_tensor(np.random.default_rng(32).standard_normal(
        (4, 96, 16)).astype(np.float32))
    got = fit_sharded(x, 6, torch.Generator().manual_seed(3),
                      mesh=world_of_one, n=96, impl=impl, train_cap=cap)
    want = kmeans.fit(x, 6, torch.Generator().manual_seed(3), impl=impl,
                      train_cap=cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_mesh_helpers(world_of_one):
    from flechasdb_tpu_torch.parallel.mesh import (block_sizes, row_block,
                                                   sum_ranks)

    assert [row_block(10, 4, r) for r in range(4)] == \
        [(0, 2), (2, 5), (5, 7), (7, 10)]
    assert [row_block(20_000, 3, r, 16_384) for r in range(3)] == \
        [(0, 0), (0, 16_384), (16_384, 20_000)]
    assert [row_block(5, 8, r) for r in range(8)][-1] == (4, 5)
    assert block_sizes(world_of_one, 7) == [7]
    t = torch.tensor([1.5, -0.0])
    assert torch.equal(sum_ranks(world_of_one, t), t)
    with pytest.raises(ValueError, match="rank 0 holds 3 rows"):
        from flechasdb_tpu_torch.parallel import fit_sharded
        fit_sharded(torch.zeros(1, 3, 4), 2, torch.Generator(),
                    mesh=world_of_one, n=5)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_world_of_one_bucketed_counts_and_answers_as_one_device(
        world_of_one, metric):
    """A world-of-one ``ShardedIndex(layout="bucketed")`` runs the
    single-device pipeline over its one block: under a profiler it counts
    the same ``bucketed.slots``, ``bucketed.real_slots`` and
    ``tables.cells`` as a ``DeviceIndex`` on the same arrays, and returns
    the same arrays."""
    from torch.profiler import ProfilerActivity, profile

    from flechasdb_tpu_torch.serving import DeviceIndex, ShardedIndex
    from flechasdb_tpu_torch.utils import profiling

    rng = np.random.default_rng(35)
    args = list(_index(rng, 600, 32, 13, 4, 16).values())
    q = rng.standard_normal((5, 32)).astype(np.float32)
    mask = rng.random(600) < 0.7
    one = DeviceIndex(*args, layout="bucketed", metric=metric, device="cpu")
    sharded = ShardedIndex(*args, layout="bucketed", metric=metric,
                           mesh=world_of_one)
    counted, answers = [], []
    for index in (one, sharded):
        profiling.reset_counters()
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                answers.append(index.query(q, k=6, nprobe=4, row_mask=mask))
            counted.append(profiling.counters())
        finally:
            profiling.reset_counters()
    assert counted[0]["bucketed.slots"] == 5 * 4 * one.buckets.codes.shape[2]
    for name in ("bucketed.slots", "bucketed.real_slots", "tables.cells"):
        assert counted[1].get(name) == counted[0][name], name
    for got, want in zip(answers[1], answers[0], strict=True):
        np.testing.assert_array_equal(got, want)


def test_parallel_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A fresh interpreter: the port's parallel package and a world-1
    sharded build leave jax and flechasdb_tpu out of ``sys.modules``."""
    code = (
        "import sys, numpy as np, torch.distributed as dist\n"
        f"dist.init_process_group('gloo', init_method="
        f"'file://{tmp_path / 'store'}', rank=0, world_size=1)\n"
        "from flechasdb_tpu_torch.parallel import build_sharded, "
        "corpus_mesh\n"
        "x = np.random.default_rng(0).standard_normal((200, 16))"
        ".astype(np.float32)\n"
        "b = build_sharded(x, 4, 2, 8, 1, mesh=corpus_mesh(device='cpu'))\n"
        "assert b.codes.shape == (200, 2)\n"
        "dist.destroy_process_group()\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'flechasdb_tpu' or "
        "m.startswith('flechasdb_tpu.')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


# -- the card: a world of one over NCCL ---------------------------------------

@pytest.fixture
def nccl_world(cuda, tmp_path):
    import datetime

    import torch.distributed as dist
    from flechasdb_tpu_torch.parallel import corpus_mesh

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield corpus_mesh(device="cuda:0")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(pq_cap=20_000),
                                dict(impl="_fast")])
def test_nccl_world_of_one_build_is_bit_equal(nccl_world, kw):
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.parallel import build_sharded
    from flechasdb_tpu_torch.parallel.build import _build_fn

    x = np.random.default_rng(33).standard_normal((50_000, 128)) \
        .astype(np.float32)
    _kernels.reset_launches()
    got = build_sharded(x, 64, 8, 256, 5, mesh=nccl_world, **kw)
    launched = dict(_kernels.LAUNCHES)
    want = _build_fn(x, 5, p=64, d=8, c=256, device="cuda", **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert launched["cluster_sums"] > 0
    assert launched["lloyd_round_fast" if kw.get("impl") else
                    "lloyd_round"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bucketed", "masked"])
def test_nccl_sharded_index_equals_device_index(nccl_world, layout):
    from flechasdb_tpu_torch.serving import DeviceIndex, ShardedIndex

    rng = np.random.default_rng(34)
    args = list(_index(rng, 20_000, 64, 64, 8, 256).values())
    q = rng.standard_normal((100, 64)).astype(np.float32)
    want = DeviceIndex(*args, layout=layout, device="cuda").query(
        q, k=10, nprobe=8)
    got = ShardedIndex(*args, layout=layout, mesh=nccl_world).query(
        q, k=10, nprobe=8)
    same_ranked(got[0], got[1], want[0], want[1])
    np.testing.assert_array_equal(got[2], want[2])

