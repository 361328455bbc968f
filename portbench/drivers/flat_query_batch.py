"""Driver: ``FlatDatabase.query_batch``, the flat tier's entry point: exact
k-NN over every row.

Set-up draws the corpus and the query pool on the card, makes the
database from the host copy of the corpus (its ids from the
configuration's ``data_seed``), pushes the corpus to the card (the part
``index``) and makes the warm-up calls: the deployment's, the same for
every run's seed, which draws the order of the batches and the check's
sample. A call answers one batch of the mix's size at the
configuration's ``k`` and returns its ``FlatQueryResult`` lists. The
check reads back each sampled answer's corpus row by its vector id (a
result whose ``vector_index`` is not that row reads as no row) and
compares it with the plain exact reference (``reference/exact.py``) in
float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.common import QueryStream, derive, make_data, sampled, sync
from portbench.reference import arith, exact


class Driver:
    #: The keys of its mix this driver reads, besides the harness's own.
    MIX_KEYS = ("batch", "warmup_calls", "sample_every")

    def __init__(self, ctx) -> None:
        import flechasdb_tpu_torch as ft

        cfg, mix = ctx.cell.config, ctx.cell.mix
        self.ctx, self.cfg, self.mix = ctx, cfg, mix
        self.k = cfg["k"]
        dev = ctx.device
        with ctx.part("data"):
            x, pool = make_data(cfg, dev)
            self.x = x
            self.pool = pool.cpu().numpy()
            host = x.cpu().numpy()
        with ctx.part("database"):
            self.db = ft.FlatDatabase(host, seed=derive(cfg["data_seed"],
                                                        0xF1A7),
                                      device=dev)
        del host
        with ctx.part("index"):
            self.db.preload()
        self.stream = QueryStream(self.pool, mix["batch"], ctx.seed)
        warm = QueryStream(self.pool, mix["batch"], derive(ctx.seed, 0x3A))
        with ctx.part("warm-up"):
            for i in range(mix["warmup_calls"]):
                self.call(warm.queries(i))
        self.kept, self.last, self.ids = {}, None, None

    def describe(self) -> str:
        return f"{self.db.num_vectors} rows on {self.db.device}"

    def prepare(self, i: int) -> np.ndarray:
        return self.stream.queries(i)

    def call(self, q: np.ndarray):
        return len(q), self.db.query_batch(q, self.k)

    def control_call(self, q: np.ndarray):
        """The plain reference in TF32 in the program's place."""
        keys, rows = exact.search(
            self.x, torch.as_tensor(q, device=self.ctx.device), self.k,
            arith.TF32)
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
        """``(rows, dists)`` ``[B, k]`` of one call's output:
        ``FlatQueryResult`` lists (rows by vector id; a result whose
        ``vector_index`` is not its row reads as no row), or the control's
        arrays."""
        if isinstance(out, tuple):
            return out[1], out[0]
        rows = np.full((len(out), self.k), -1, np.int64)
        dists = np.full((len(out), self.k), math.inf)
        for b, results in enumerate(out):
            for j, r in enumerate(results[:self.k]):
                row = self.ids.get(r.vector_id, -1)
                if row != r.vector_index:
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
        dev = self.ctx.device
        rows = torch.as_tensor(np.concatenate([p[0] for p in pairs]),
                               device=dev)
        dists = torch.as_tensor(np.concatenate([p[1] for p in pairs]),
                                device=dev)
        return exact.numbers(self.x, torch.as_tensor(q, device=dev), rows,
                             dists, self.k)
