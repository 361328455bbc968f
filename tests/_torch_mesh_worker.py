"""One rank of a gloo world for ``tests/test_torch_parallel.py``.

Run as ``python _torch_mesh_worker.py <rank> <world> <dir>``: the rank
joins the world through a file store in ``<dir>``, reads the cases'
inputs from ``<dir>/inputs.npz`` (made from seeds by the test module),
runs every case of the port's sharded paths on the CPU, and writes its
results to ``<dir>/w<world>_r<rank>.npz``. Rank 0 also computes the
single-device references the cases hold the sharded results against.
It imports only torch, numpy and the port, never jax or the JAX package:
the test module checks that no rank imported them.
"""

import datetime
import sys

import numpy as np
import torch
import torch.distributed as dist


def cases(mesh, inp, tree):
    """Every case: ``name → {key: array}``; rank 0 adds references."""
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch.ops import kmeans
    from flechasdb_tpu_torch.ops.bucketed import (bucketize, query_bucketed,
                                                  range_bucketed)
    from flechasdb_tpu_torch.parallel import (
        build_sharded, exact_sharded, fit_sharded, query_sharded,
        rerank_sharded, shard_corpus, shard_flat)
    from flechasdb_tpu_torch.parallel.bucketed import (
        query_bucketed_sharded, range_bucketed_sharded, shard_buckets)
    from flechasdb_tpu_torch.parallel.build import _build_fn
    from flechasdb_tpu_torch.parallel.mesh import (block_sizes,
                                                   gather_blocks, shard_mask)
    from flechasdb_tpu_torch.serving import DeviceIndex, ShardedIndex
    from _torch_helpers import midpoint_radius

    t = torch.as_tensor
    lead = mesh.rank == 0
    out = {}

    def arrays(prefix, tensors):
        return {f"{prefix}{i}": np.asarray(a.cpu() if torch.is_tensor(a)
                                           else a)
                for i, a in enumerate(tensors)}

    def masked(pre, k, nprobe):
        codes, pidx = shard_corpus(mesh, inp[pre + "codes"],
                                   inp[pre + "pidx"])
        return query_sharded(
            t(inp[pre + "q"]), t(inp[pre + "cents"]), t(inp[pre + "books"]),
            codes, pidx, mesh=mesh, n=len(inp[pre + "codes"]), k=k,
            nprobe=nprobe)

    out["masked"] = arrays("", masked("mq_", 10, 3))
    out["unpadded"] = arrays("", masked("mu_", 7, 8)[:2])

    def build(name, x, p, d, c, seed, **kw):
        got = arrays("", build_sharded(x, p, d, c, seed, mesh=mesh, **kw))
        if lead:
            got.update(arrays("ref", _build_fn(x, seed, p=p, d=d, c=c,
                                               device="cpu", **kw)))
        out[name] = got

    x = inp["be_x"]
    build("build_e2e", x, 4, 4, 8, 7)
    b = out["build_e2e"]
    codes, pidx = shard_corpus(mesh, b["3"], b["1"])
    out["build_e2e"]["hits"] = query_sharded(
        t(x[:8]), t(b["0"]), t(b["2"]), codes, pidx, mesh=mesh, n=len(x),
        k=1, nprobe=4)[1].numpy()
    build("build_match", inp["bm_x"], 4, 2, 8, 3)
    build("build_round", inp["bk_x"], 4, 2, 8, 11, impl="round")
    build("build_unpadded", inp["bu_x"], 4, 2, 8, 5)
    build("build_pq_cap", inp["bp_x"], 4, 2, 8, 9, pq_cap=256)
    build("build_coarse_cap", inp["bc_x"], 4, 2, 8, 13, coarse_cap=128)
    build("build_fast", inp["bk_x"], 4, 2, 8, 11, impl="round_fast")
    build("build_fast_bare", inp["bk_x"], 4, 2, 8, 11, impl="_fast")

    def whole(res, n):
        """A sharded fit's centroids and its indices gathered whole."""
        return res.centroids, gather_blocks(mesh, res.indices,
                                            block_sizes(mesh, n), dim=1)

    # The kernel is resolved against this rank's block, never the whole.
    seen = []
    real = kmeans._auto_impl
    kmeans._auto_impl = lambda xx: seen.append(xx.shape[1]) or real(xx)
    try:
        xc = inp["cap_x"]
        a, z = mesh.block(xc.shape[1])
        res = fit_sharded(t(xc[:, a:z]), 4, torch.Generator().manual_seed(3),
                          mesh=mesh, n=xc.shape[1], train_cap=64)
    finally:
        kmeans._auto_impl = real
    got = arrays("", whole(res, xc.shape[1]))
    got["local_seen"] = np.asarray(seen)
    if lead:
        got.update(arrays("ref", kmeans.fit(
            t(xc), 4, torch.Generator().manual_seed(3), train_cap=64)[:2]))
    out["cap_resolve"] = got

    xg = inp["fg_x"]
    a, z = mesh.block(xg.shape[1])
    got = arrays("", whole(fit_sharded(
        t(xg[:, a:z]), 6, torch.Generator().manual_seed(5), mesh=mesh,
        n=xg.shape[1], impl="grouped"), xg.shape[1]))
    if lead:
        got.update(arrays("ref", kmeans.fit(
            t(xg), 6, torch.Generator().manual_seed(5), impl="grouped")[:2]))
    out["fit_grouped"] = got

    xe, qe = inp["ex_x"], inp["ex_q"]
    xs, n = shard_flat(mesh, xe)
    out["exact"] = arrays("", exact_sharded(t(qe), xs, mesh=mesh, k=9, n=n))
    mask = inp["ex_mask"]
    out["exact_mask"] = arrays("", exact_sharded(
        t(qe), xs, shard_mask(mesh, mask), mesh=mesh, k=9, n=n))

    xr = inp["rr_x"]
    xs, n = shard_flat(mesh, xr)
    out["rerank"] = {}
    for metric in ("l2", "dot"):
        out["rerank"].update(arrays(metric, rerank_sharded(
            t(inp["rr_q"]), t(inp["rr_rows"]), t(inp["rr_valid"]), xs,
            mesh=mesh, k=6, n=n, metric=metric)))

    def bucketed(pre, k, nprobe, row_mask=None):
        bk = bucketize(inp[pre + "codes"], inp[pre + "pidx"],
                       len(inp[pre + "cents"]))
        return query_bucketed_sharded(
            t(inp[pre + "q"]), t(inp[pre + "cents"]), t(inp[pre + "books"]),
            shard_buckets(mesh, bk), row_mask, mesh=mesh, k=k, nprobe=nprobe)

    out["bucketed"] = arrays("", bucketed("bq_", 9, 5))
    out["bucketed_mask"] = arrays("", bucketed("bm_", 7, 8,
                                               t(inp["bm_mask"]))[:2])

    args = [inp["si_" + s] for s in ("cents", "books", "codes", "pidx")]
    idx = ShardedIndex(*args, mesh=mesh)
    got = arrays("", idx.query(inp["si_q"], k=6, nprobe=4))
    got["layout"] = np.asarray(idx.layout)
    out["index_bucketed"] = got

    args = [inp["rg_" + s] for s in ("cents", "books", "codes", "pidx")]
    q = inp["rg_q"]
    got = {}
    for layout in ("bucketed", "masked"):
        single = DeviceIndex(*args, layout=layout, device="cpu")
        radius = midpoint_radius(single.query(q, k=5, nprobe=8)[0], 0.5)
        got[layout + "_radius"] = np.asarray(radius)
        sharded = ShardedIndex(*args, layout=layout, mesh=mesh)
        for tag, rm in (("all", None), ("mask", inp["rg_mask"])):
            for i, (rows, keys) in enumerate(sharded.query_range(
                    q, radius, nprobe=8, row_mask=rm)):
                got[f"{layout}_{tag}_{i}_rows"] = rows
                got[f"{layout}_{tag}_{i}_keys"] = keys
    out["range"] = got

    # A key that overflows to +inf on a kept row (codeword 3 of division
    # 0 is huge): the row stays a candidate, as on one device.
    args = [t(inp["ov_" + s]) for s in ("q", "cents", "books")]
    bk = bucketize(inp["ov_codes"], inp["ov_pidx"], len(inp["ov_cents"]))
    got = arrays("", range_bucketed_sharded(*args, shard_buckets(mesh, bk),
                                            mesh=mesh, nprobe=3))
    if lead:
        got.update(arrays("ref", range_bucketed(*args, bk, nprobe=3)))
    out["range_overflow"] = got

    # The two-process check of the JAX package (tests/_multihost_worker.py)
    x = inp["mh_x"]
    built = build_sharded(x, 4, 4, 8, 0, mesh=mesh)
    codes_h = built.codes.numpy()
    pidx_h = built.partition_indices.to(torch.int32).numpy()
    codes, pidx = shard_corpus(mesh, codes_h, pidx_h)
    q = t(inp["mh_q"])
    cents, books = built.partition_centroids, built.codebooks
    got = arrays("masked", query_sharded(q, cents, books, codes, pidx,
                                         mesh=mesh, n=len(x), k=5,
                                         nprobe=2))
    bk = bucketize(codes_h, pidx_h, 4)
    got.update(arrays("bucketed", query_bucketed_sharded(
        q, cents, books, shard_buckets(mesh, bk), mesh=mesh, k=5,
        nprobe=2)))
    xs, n = shard_flat(mesh, x)
    got.update(arrays("exact", exact_sharded(q, xs, mesh=mesh, k=5, n=n)))
    rows = t(got["exact1"]).long()
    got.update(arrays("rerank", rerank_sharded(
        q, rows, torch.ones_like(rows, dtype=torch.bool), xs, mesh=mesh,
        k=3, n=n)))
    got.update(arrays("build", built))
    if lead:
        from flechasdb_tpu_torch.ops.adc import query_masked_scan
        from flechasdb_tpu_torch.ops.exact import exact_topk
        got.update(arrays("ref_masked", query_masked_scan(
            q, cents, books, t(codes_h.astype(np.int32)), t(pidx_h), k=5,
            nprobe=2)))
        got.update(arrays("ref_bucketed", query_bucketed(
            q, cents, books, bk, k=5, nprobe=2)))
        got.update(arrays("ref_exact", exact_topk(q, t(x), k=5)))
    out["multiprocess"] = got

    # preload(mesh=) of a stored tree, and of the flat tiers.
    sdb = ft.load_database(ft.LocalFileSystem(tree / "ivf"),
                           (tree / "ivf_root").read_text() + ".binpb",
                           device="cpu")
    sdb.preload(mesh=mesh)
    res = sdb.query_batch(inp["st_q"], k=5, nprobe=3)
    out["stored"] = {
        "layout": np.asarray(sdb._dev[0].layout),
        "ids": np.asarray([[str(r.vector_id) for r in rs] for rs in res]),
        "dists": np.asarray([[r.squared_distance for r in rs]
                             for rs in res])}

    fdb = ft.FlatDatabase(inp["fl_x"], seed=4, device="cpu")
    fdb.preload(mesh=mesh)
    sfl = ft.load_flat_database(ft.LocalFileSystem(tree / "flat"),
                                (tree / "flat_root").read_text() + ".binpb",
                                device="cpu")
    sfl.preload(mesh=mesh)
    got = {}
    for name, db in (("mem", fdb), ("stored", sfl)):
        res = db.query_batch(inp["fl_q"], k=7)
        got[name + "_rows"] = np.asarray([[r.vector_index for r in rs]
                                          for rs in res])
        got[name + "_dists"] = np.asarray([[r.squared_distance for r in rs]
                                           for rs in res])
        hits = db.query_range(inp["fl_q"][0], float(inp["fl_radius"]))
        got[name + "_range"] = np.asarray([r.vector_index for r in hits])
    out["flat"] = got

    src = inp["sm_x"]

    def streamed(m):
        b = (ft.StreamingDatabaseBuilder(src, device="cpu")
             .with_partitions(16).with_divisions(4).with_clusters(16)
             .with_seed(11).with_chunk_rows(35_000))
        if m is not None:
            b = b.with_mesh(m)
        db = b.build()
        return {"pidx": db.partition_indices, "codes": db.codes,
                "cents": db.partition_centroids, "books": db.codebooks,
                "ids": np.asarray([str(v) for v in db.vector_ids[:50]])}

    got = streamed(mesh)
    if lead:
        got.update({"ref_" + key: v for key, v in streamed(None).items()})
    out["streamed"] = got
    return out


def main() -> None:
    from pathlib import Path

    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{work / f'store{world}'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        from flechasdb_tpu_torch.parallel import corpus_mesh

        mesh = corpus_mesh(device="cpu")
        with np.load(work / "inputs.npz") as f:
            inp = dict(f)
        res = cases(mesh, inp, work)
        flat = {f"{case}/{key}": v for case, got in res.items()
                for key, v in got.items()}
        flat["imported"] = np.asarray(sorted(
            m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "flechasdb_tpu" or m.startswith("flechasdb_tpu.")))
        np.savez(work / f"w{world}_r{rank}.npz", **flat)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
