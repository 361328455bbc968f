"""Driver: ``serving.DeviceIndex(layout="bucketed").query_rerank`` on a
staged build, the serving path of a 10M-row index.

Set-up draws the corpus and the query pool on the card, builds with
``parallel.build_staged`` and holds the buckets in a ``DeviceIndex``, all
from the configuration's ``data_seed`` (the deployment); the run's seed
draws the order of the batches and the check's sample. A
call answers one batch of the mix's size at the configuration's ``k``,
``nprobe`` and ``rerank``; its results are on the host when it returns.
The check compares a sample of the answered batches with the plain
reference over the build's arrays, and judges those arrays as the build
cells judge theirs (each sampled row's partition and codes, the Lloyd
updates left in the centroids and codebooks).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.common import (QueryStream, check_rows, derive, make_data,
                               sampled, sync)
from portbench.reference import arith, ivfpq, judge


class Driver:
    #: The keys of its mix this driver reads, besides the harness's own.
    MIX_KEYS = ("batch", "warmup_calls", "sample_every")

    def __init__(self, ctx) -> None:
        from flechasdb_tpu_torch import serving
        from flechasdb_tpu_torch.parallel import build_staged

        cfg, mix = ctx.cell.config, ctx.cell.mix
        self.ctx, self.cfg, self.mix = ctx, cfg, mix
        self.k, self.nprobe, self.rerank = cfg["k"], cfg["nprobe"], \
            cfg["rerank"]
        dev = ctx.device
        with ctx.part("data"):
            self.x, pool = make_data(cfg, dev)
            self.pool = pool.cpu().numpy()
        with ctx.part("build"):
            b = build_staged(self.x, cfg["partitions"], cfg["divisions"],
                             cfg["clusters"], derive(cfg["data_seed"], 0xB17D),
                             coarse_cap=cfg["coarse_train_cap"],
                             pq_cap=cfg["pq_train_cap"], device=dev)
        self.arrays = (b.partition_centroids, b.codebooks, b.codes,
                       b.partition_indices)
        with ctx.part("index"):
            self.index = serving.DeviceIndex(
                *(t.cpu().numpy() for t in self.arrays),
                layout="bucketed", device=dev)
        self.stream = QueryStream(self.pool, mix["batch"], ctx.seed)
        warm = QueryStream(self.pool, mix["batch"], derive(ctx.seed, 0x3A))
        with ctx.part("warm-up"):
            for i in range(mix["warmup_calls"]):
                self.call(warm.queries(i))
        self.kept, self.last = {}, None

    def describe(self) -> str:
        return (f"layout {self.index.layout}, buckets "
                f"{tuple(self.index.buckets.codes.shape)}")

    def prepare(self, i: int) -> np.ndarray:
        return self.stream.queries(i)

    def call(self, q: np.ndarray):
        dists, rows = self.index.query_rerank(
            q, self.x, k=self.k, nprobe=self.nprobe, rerank=self.rerank)
        return len(q), (dists, rows)

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
            *self.arrays, k=self.k, nprobe=self.nprobe, rerank=self.rerank,
            arith=arith.TF32)
        return len(q), (keys.cpu().numpy(), rows.cpu().numpy())

    def control_tables_call(self, q: np.ndarray):
        """A planted fault below the control: the program's arrays, the
        ADC keys (tables and sums) in TF32 and the exact rerank in float64,
        so that only the candidates the rerank is given can move."""
        keys, rows = ivfpq.search(
            self.x, torch.as_tensor(q, device=self.ctx.device),
            *self.arrays, k=self.k, nprobe=self.nprobe, rerank=self.rerank,
            arith=arith.TF32, rerank_arith=arith.F64)
        return len(q), (keys.cpu().numpy(), rows.cpu().numpy())

    def keep(self, i: int, q, out) -> None:
        if sampled(self.ctx.seed, i, self.mix["sample_every"]):
            self.kept[i] = out
        self.last = (i, out)

    def work(self, window) -> dict:
        """Each K-A launch's work: the rows its batch's probed partitions
        hold (the probe worked out again here), over the build's
        partition sizes."""
        cents, _, _, pidx = self.arrays
        counts = torch.bincount(pidx.long(), minlength=cents.shape[0])
        d, c, _ = self.arrays[1].shape
        out = []
        for call in window.calls:
            q = torch.as_tensor(self.stream.queries(call.index),
                                device=cents.device)
            probed = torch.argsort(ivfpq.sqdist(q, cents, arith.F64), dim=1,
                                   stable=True)[:, :self.nprobe]
            out.append({"real_slots": int(counts[probed].sum()),
                        "g": probed.numel(), "d": d, "c": c})
        return {"adc_scan": out}

    def free_program(self) -> None:
        self.index = None
        sync(self.ctx.device)
        torch.cuda.empty_cache() if torch.cuda.is_available() else None

    def judge(self, window) -> dict:
        kept = dict(self.kept)
        if not kept and self.last is not None:
            kept[self.last[0]] = self.last[1]
        if not kept:
            return {}
        keys = sorted(kept)
        q = np.concatenate([self.stream.queries(i) for i in keys])
        outs = [kept[i] for i in keys]
        dists = torch.as_tensor(np.concatenate([o[0] for o in outs]))
        rows = torch.as_tensor(np.concatenate([o[1] for o in outs])).long()
        dev = self.ctx.device
        numbers = judge.serve_numbers(
            self.x, torch.as_tensor(q, device=dev), *self.arrays,
            rows.to(dev), dists.to(dev), k=self.k, nprobe=self.nprobe,
            rerank=self.rerank)
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
