"""Driver: ``Database.query_batch``, the user's entry point, on the layout
the program's policy picks.

Set-up draws the corpus and the query pool on the card, builds with
``DatabaseBuilder(...).build()`` from the host copy of the corpus (ids,
residues and all), and makes the first query, which builds the device
index, all from the configuration's ``data_seed`` (the deployment); the
run's seed draws the order of the batches and the check's sample. A call
answers one batch of the mix's size at the configuration's
``k`` and ``nprobe`` and returns its ``QueryResult`` lists. The check
reads back each sampled answer's corpus row by its vector id and compares
it with the plain reference over the built database's arrays, and judges
those arrays as the build cells judge theirs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.common import (QueryStream, check_rows, derive, make_data,
                               sampled, sync)
from portbench.reference import arith, ivfpq, judge


class Driver:
    #: The keys of its mix this driver reads, besides the harness's own.
    MIX_KEYS = ("batch", "warmup_calls", "sample_every")

    def __init__(self, ctx) -> None:
        import flechasdb_tpu_torch as ft

        cfg, mix = ctx.cell.config, ctx.cell.mix
        self.ctx, self.cfg, self.mix = ctx, cfg, mix
        self.k, self.nprobe = cfg["k"], cfg["nprobe"]
        dev = ctx.device
        with ctx.part("data"):
            x, pool = make_data(cfg, dev)
            self.x = x
            self.pool = pool.cpu().numpy()
            host = x.cpu().numpy()
        with ctx.part("build"):
            self.db = (ft.DatabaseBuilder(host, device=dev)
                       .with_partitions(cfg["partitions"])
                       .with_divisions(cfg["divisions"])
                       .with_clusters(cfg["clusters"])
                       .with_seed(derive(cfg["data_seed"], 0xB17D)).build())
        del host
        self.stream = QueryStream(self.pool, mix["batch"], ctx.seed)
        warm = QueryStream(self.pool, mix["batch"], derive(ctx.seed, 0x3A))
        with ctx.part("index"):
            self.call(warm.queries(0))
        with ctx.part("warm-up"):
            for i in range(1, mix["warmup_calls"]):
                self.call(warm.queries(i))
        db = self.db
        self.arrays = tuple(torch.as_tensor(np.asarray(a), device=dev)
                            for a in (db.partition_centroids, db.codebooks,
                                      db.codes.astype(np.int64),
                                      db.partition_indices))
        self.pidx_host = np.asarray(db.partition_indices)
        self.kept, self.last = {}, None

    def describe(self) -> str:
        dev_index = getattr(self.db, "_dev", None)
        return f"layout {getattr(dev_index, 'layout', 'unknown')}"

    def prepare(self, i: int) -> np.ndarray:
        return self.stream.queries(i)

    def call(self, q: np.ndarray):
        return len(q), self.db.query_batch(q, self.k, self.nprobe)

    def control_setup(self) -> None:
        """The control's set-up: the plain reference's build, in TF32, in
        the place of the program's arrays, which the control then serves
        from."""
        c = self.cfg
        cents, idx, books, codes = ivfpq.build(
            self.x, c["partitions"], c["divisions"], c["clusters"],
            derive(c["data_seed"], 0xB17D), arith.TF32,
            coarse_cap=c["coarse_train_cap"], pq_cap=c["pq_train_cap"])
        self.arrays = (cents, books, codes, idx)

    def control_call(self, q: np.ndarray):
        keys, rows = ivfpq.search(
            self.x, torch.as_tensor(q, device=self.ctx.device),
            *self.arrays, k=self.k, nprobe=self.nprobe, arith=arith.TF32)
        return len(q), (keys.cpu().numpy(), rows.cpu().numpy())

    def keep(self, i: int, q, out) -> None:
        if sampled(self.ctx.seed, i, self.mix["sample_every"]):
            self.kept[i] = out
        self.last = (i, out)

    def work(self, window) -> dict:
        return {}

    def free_program(self) -> None:
        if self.db is not None:
            self.ids = {vid: i for i, vid in enumerate(self.db.vector_ids)}
        self.db = None
        sync(self.ctx.device)
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    def _answers(self, out) -> tuple[np.ndarray, np.ndarray]:
        """``(rows, dists)`` ``[B, k]`` of one call's output: ``QueryResult``
        lists (rows by vector id; a result whose partition is not its
        row's reads as no row), or the control's arrays."""
        if isinstance(out, tuple):
            return out[1], out[0]
        rows = np.full((len(out), self.k), -1, np.int64)
        dists = np.full((len(out), self.k), math.inf)
        pidx = self.pidx_host
        for b, results in enumerate(out):
            for j, r in enumerate(results[:self.k]):
                row = self.ids.get(r.vector_id, -1)
                if row >= 0 and int(pidx[row]) != r.partition_index:
                    row = -1
                rows[b, j] = row
                dists[b, j] = r.squared_distance if row >= 0 else math.nan
        return rows, dists

    def judge(self, window) -> dict:
        kept = dict(self.kept)
        if not kept and self.last is not None:
            kept[self.last[0]] = self.last[1]
        if not kept:
            return {}
        keys = sorted(kept)
        q = np.concatenate([self.stream.queries(i) for i in keys])
        pairs = [self._answers(kept[i]) for i in keys]
        rows = torch.as_tensor(np.concatenate([p[0] for p in pairs]))
        dists = torch.as_tensor(np.concatenate([p[1] for p in pairs]))
        dev = self.ctx.device
        numbers = judge.serve_numbers(
            self.x, torch.as_tensor(q, device=dev), *self.arrays,
            rows.to(dev), dists.to(dev), k=self.k, nprobe=self.nprobe)
        return {**numbers, **self._build_numbers()}

    def _build_numbers(self) -> dict:
        """The served index's own build, judged as the build cells judge
        theirs: a sample of rows drawn from the run's seed."""
        cents, books, codes, pidx = self.arrays
        c = self.cfg
        sample = check_rows(self.x.shape[0], self.ctx.seed, c["check_rows"],
                            self.x.device)
        return judge.build_numbers(self.x, cents, pidx, books, codes, sample,
                                   p=c["partitions"], d=c["divisions"],
                                   c=c["clusters"])
