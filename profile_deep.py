#!/usr/bin/env python3
"""Measures, on one NVIDIA GPU, the recall@10 gap between the Deep10M
staged build and the streamed build over several seeds, and takes it
apart.

    python3 profile_deep.py [--seeds 42 1 2 3 4] [--out F]

For each seed, on ``chip_smoke.py`` phase 9's data (10M x 96 GMM rows and
200 queries from ``synth.gmm_pair_device``, 1024 components, intrinsic
12, drawn on the card from the seed; ``exact_topk`` ground truth), and at
nprobe 32:

* ``staged``: ``parallel.build.build_staged(x, 4096, 8, 256, seed)``
  served by ``query_bucketed`` (phase 9's serving);
* ``streamed``: ``StreamingDatabaseBuilder`` over the corpus copied to
  the host, served by ``Database.query_batch`` (phase 9's serving), and
  ``streamed_bucketed``: its arrays served by ``query_bucketed``;
* four rebuilds of the PQ half alone, each with the same PQ generator:
  on the streamed build's coarse centroids and partitions, the codebooks
  trained on the residuals of 1,048,576 rows drawn from the streamed
  build's training sample (``streamed_pq_in``) or from the rows outside
  it (``streamed_pq_out``); on the staged build's, from the rows of its
  capped coarse fit (``staged_pq_in``) or outside them
  (``staged_pq_out``). Every code comes from ``_encode_chunked``.

Each variant's line gives its recall, the mean squared coarse residual
over its coarse fit's training rows and over the other rows, and the mean
squared PQ error of all rows. One line per variant is printed and all are
written to ``--out`` (default ``chiprun_out/profile_deep.json``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs

PQ_ROWS = 1 << 20
DEVICE = "cuda"


class KeepRows(cs.ReadCounter):
    """A read counter that also keeps the rows of the training gather."""

    rows = None

    def __getitem__(self, key):
        if not isinstance(key, slice) and self.rows is None:
            self.rows = np.asarray(key).copy()
        return super().__getitem__(key)


def energies(torch, x, cents, pidx, books, codes, trained):
    """The mean ‖x − c‖² over the rows in ``trained`` and over the
    others, and the mean PQ error ‖x − c − q‖² over all rows, a chunk at
    a time."""
    d, _, sub = books.shape
    dd = torch.arange(d, device=DEVICE)[None, :]
    coarse = torch.zeros(len(x), device=DEVICE)
    pq = 0.0
    for lo in range(0, len(x), 1 << 20):
        rows = slice(lo, lo + (1 << 20))
        r = x[rows] - cents[pidx[rows]]
        coarse[rows] = (r * r).sum(1)
        q = books[dd, codes[rows]].reshape(len(r), d * sub)
        pq += float(((r - q) ** 2).sum())
    return (float(coarse[trained].mean()), float(coarse[~trained].mean()),
            pq / len(x))


def recall(torch, q, cents, books, codes, pidx, gt) -> float:
    """recall@10 of ``query_bucketed`` at nprobe 32 on these arrays, in
    query chunks as phase 9 sizes them."""
    from flechasdb_tpu_torch.ops.bucketed import bucketize, query_bucketed
    bk = bucketize(codes.cpu().numpy(), pidx.cpu().numpy().astype(np.int32),
                   cs.DEEP_P, device=DEVICE)
    l_pad = bk.codes.shape[2]
    cb = max(1, min(len(q), int(1.5e9 / (cs.DEEP_NPROBE * l_pad
                                         * (cs.DEEP_D + 2) * 4))))
    rows = torch.cat([query_bucketed(q[i:i + cb], cents, books, bk,
                                     k=cs.K_TOP, nprobe=cs.DEEP_NPROBE)[1]
                      for i in range(0, len(q), cb)])
    return cs.recall_at(rows.cpu().numpy(), gt)


def pq_half(torch, x, cents, pidx, rows, seed: int):
    """The PQ codebooks trained on the residuals of ``rows`` (a fixed
    generator), and every row's code from ``_encode_chunked``."""
    from flechasdb_tpu_torch.ops import kmeans
    from flechasdb_tpu_torch.parallel import build as pbuild
    r = x[rows] - cents[pidx[rows]]
    divided = r.reshape(len(r), cs.DEEP_D, -1).transpose(0, 1).contiguous()
    gen = torch.Generator(DEVICE).manual_seed(seed + 2**32)
    books = kmeans.fit(divided, cs.C, gen).centroids
    return books, pbuild._encode_chunked(x, cents, pidx, books)


def pick(torch, mask, gen):
    """PQ_ROWS rows where ``mask`` holds, without replacement."""
    where = mask.nonzero().squeeze(1)
    return where[torch.randperm(len(where), generator=gen,
                                device=DEVICE)[:PQ_ROWS]]


def one_seed(torch, seed: int) -> list[dict]:
    import flechasdb_tpu_torch as ft
    from flechasdb_tpu_torch import synth
    from flechasdb_tpu_torch.ops import kmeans
    from flechasdb_tpu_torch.ops.exact import exact_topk
    from flechasdb_tpu_torch.parallel import COARSE_TRAIN_CAP
    from flechasdb_tpu_torch.parallel import build as pbuild
    n = cs.DEEP_N
    x, q = synth.gmm_pair_device(torch.Generator(DEVICE).manual_seed(seed),
                                 n, cs.DEEP_NQ, cs.DEEP_M, n_clusters=1024,
                                 intrinsic=12)
    gt = exact_topk(q, x, k=cs.K_TOP)[1].cpu().numpy()
    out = []

    def note(name, cents, pidx, books, codes, trained, r=None, **extra):
        pidx = pidx.long()
        codes = codes.long()
        if r is None:
            r = recall(torch, q, cents, books, codes, pidx, gt)
        e_in, e_out, e_pq = energies(torch, x, cents, pidx, books, codes,
                                     trained)
        rec = {"seed": seed, "variant": name, "recall": r,
               "coarse_in": e_in, "coarse_out": e_out, "pq_error": e_pq,
               **extra}
        out.append(rec)
        cs.log(f"seed {seed} {name}: recall@10 {r:.4f}; coarse residual "
               f"{e_in:.6f} on its training rows, {e_out:.6f} on the others;"
               f" PQ error {e_pq:.6f}")

    # The staged build; its coarse fit's rows, drawn as fit(train_cap=)
    # draws them from the build's coarse generator.
    t0 = time.perf_counter()
    st = pbuild.build_staged(x, cs.DEEP_P, cs.DEEP_D, cs.C, seed,
                             device=DEVICE)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    st_s = time.perf_counter() - t0
    g = torch.Generator(DEVICE).manual_seed(seed)
    st_rows = torch.randint(0, n, (COARSE_TRAIN_CAP,),
                            generator=kmeans._split(g), device=DEVICE)
    st_in = torch.zeros(n, dtype=torch.bool, device=DEVICE)
    st_in[st_rows] = True
    st_p = cs.widen(torch, st.partition_indices)
    note("staged", st.partition_centroids, st_p, st.codebooks, st.codes,
         st_in, build_s=st_s)

    # The streamed build over the host copy.
    src = KeepRows(x.cpu().numpy())
    t0 = time.perf_counter()
    db = (ft.StreamingDatabaseBuilder(src, device=DEVICE)
          .with_partitions(cs.DEEP_P).with_divisions(cs.DEEP_D)
          .with_clusters(cs.C).with_seed(seed).build())
    sm_s = time.perf_counter() - t0
    res = db.query_batch(q.cpu().numpy(), k=cs.K_TOP, nprobe=cs.DEEP_NPROBE)
    order, starts = cs.global_rows(db.partition_indices, cs.DEEP_P)
    sm_r = cs.recall_at(cs.result_rows(res, order, starts, cs.K_TOP), gt)
    sm_c = torch.as_tensor(db.partition_centroids, device=DEVICE)
    sm_p = torch.as_tensor(db.partition_indices, device=DEVICE)
    sm_b = torch.as_tensor(db.codebooks, device=DEVICE)
    sm_codes = torch.as_tensor(db.codes.astype(np.int64), device=DEVICE)
    sm_in = torch.zeros(n, dtype=torch.bool, device=DEVICE)
    sm_in[torch.as_tensor(src.rows, device=DEVICE)] = True
    del src, db, res
    note("streamed", sm_c, sm_p, sm_b, sm_codes, sm_in, r=sm_r,
         build_s=sm_s)
    note("streamed_bucketed", sm_c, sm_p, sm_b, sm_codes, sm_in)

    # The PQ half again, on each build's coarse half, from rows in or out
    # of that build's coarse training rows.
    gen = torch.Generator(DEVICE).manual_seed(seed + 3 * 2**32)
    for name, cents, pidx, trained in (
            ("streamed", sm_c, sm_p.long(), sm_in),
            ("staged", st.partition_centroids, st_p.long(), st_in)):
        for side, mask in (("in", trained), ("out", ~trained)):
            rows = pick(torch, mask, gen)
            books, codes = pq_half(torch, x, cents, pidx, rows, seed)
            note(f"{name}_pq_{side}", cents, pidx, books, codes, trained)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 1, 2, 3, 4])
    ap.add_argument("--out", default="chiprun_out/profile_deep.json")
    args = ap.parse_args()

    import torch
    cs.setup(torch)
    records = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        records += one_seed(torch, seed)
        torch.cuda.empty_cache()
        by = {r["variant"]: r["recall"] for r in records
              if r["seed"] == seed}
        cs.log(f"seed {seed}: streamed - staged recall "
               f"{by['streamed'] - by['staged']:+.4f} "
               f"({time.perf_counter() - t0:.1f} s)")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    print(json.dumps({"ok": True, "records": len(records),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
