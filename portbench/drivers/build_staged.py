"""Driver: ``parallel.build_staged``, builds back to back on a corpus
already on the card.

Set-up draws the configuration's corpus on the card and runs one build
(the warm-up). A call is one whole build, the card synchronized at its
end. The i-th build of every run takes the same seed, drawn from the
configuration's ``data_seed``, so every run does the same work (a build's
seed sets how many rounds its fits run before they converge); the run's
seed draws the build the check judges and its rows. In a traced run
every build also takes its events: the fits' rounds, from which the
kernels' shapes follow, and the seeding's interval, the card synchronized
at each seeding event. ``kmeans.seeding_s`` is read from one more build
after the traced window, outside the profiler, whose per-operator cost
would otherwise double the launch-bound seeding.

The check judges one build drawn from the seed against the plain
reference: each sampled row's partition and codes, and the Lloyd updates
left in the centroids and codebooks.
"""

from __future__ import annotations

import time

import torch

from portbench.common import check_rows, derive, make_data, sync
from portbench.reference import arith, ivfpq, judge


class _Events:
    """The build's events, timed on the host; the card synchronized at
    the seeding events so their interval is the seeding's."""

    def __init__(self, device: str) -> None:
        self.device = device
        self.log = []

    def __call__(self, event) -> None:
        name = type(event).__name__
        if name.endswith("CentroidInitialization"):
            sync(self.device)
        self.log.append((name, getattr(event, "round", None),
                         time.perf_counter()))


def fits(log: list) -> list:
    """Per fit (coarse, then PQ): ``(rounds, exhausted, seeding_s)`` from
    an event log. A fit whose last round ran its reassignment exhausted
    its rounds and reassigns once more."""
    out, cur, seed_t = [], None, None
    for name, rnd, t in log:
        if name == "StartingCentroidInitialization":
            cur = {"rounds": 0, "last_reassigned": False, "seeding": 0.0}
            out.append(cur)
            seed_t = t
        elif name == "FinishedCentroidInitialization" and cur is not None:
            cur["seeding"] += t - seed_t
        elif name == "StartingCentroidUpdate" and cur is not None:
            cur["rounds"] = rnd + 1
            cur["last_reassigned"] = False
        elif name == "StartingCentroidReassignment" and cur is not None:
            cur["last_reassigned"] = rnd + 1 == cur["rounds"]
    return [(f["rounds"], f["last_reassigned"], f["seeding"]) for f in out]


class Driver:
    #: The keys of its mix this driver reads, besides the harness's own.
    MIX_KEYS = ()

    def __init__(self, ctx) -> None:
        from flechasdb_tpu_torch.parallel import build_staged

        cfg = ctx.cell.config
        self.ctx, self.cfg = ctx, cfg
        self._build = build_staged
        with ctx.part("data"):
            self.x, _ = make_data(cfg, ctx.device)
        with ctx.part("warm-up"):
            self.call(derive(cfg["data_seed"], 0x3A))
        self.kept = {}

    def describe(self) -> str:
        return f"corpus {tuple(self.x.shape)}"

    def prepare(self, i: int) -> int:
        return derive(self.cfg["data_seed"], 0xB17D, i)

    def _shape(self):
        c = self.cfg
        return c["partitions"], c["divisions"], c["clusters"]

    def call(self, seed: int):
        p, d, c = self._shape()
        events = _Events(self.ctx.device) if self.ctx.trace else None
        b = self._build(self.x, p, d, c, seed, events,
                        coarse_cap=self.cfg["coarse_train_cap"],
                        pq_cap=self.cfg["pq_train_cap"],
                        device=self.ctx.device)
        sync(self.ctx.device)
        return 1, (b.partition_centroids, b.partition_indices, b.codebooks,
                   b.codes, events.log if events else None)

    def control_call(self, seed: int):
        p, d, c = self._shape()
        out = ivfpq.build(self.x, p, d, c, seed, arith.TF32,
                          coarse_cap=self.cfg["coarse_train_cap"],
                          pq_cap=self.cfg["pq_train_cap"])
        sync(self.ctx.device)
        return 1, (*out, None)

    def keep(self, i: int, seed, out) -> None:
        self.kept[i] = out

    def work(self, window) -> dict:
        """The shapes of the traced builds' K-B / K-C launches and passes,
        in launch order, from the configuration and each fit's events
        (which kernel the PQ fit ran, the launch counts tell), and the
        seeding seconds of one more build, made outside the profiler."""
        n, m = self.x.shape
        p, d, c = self._shape()
        n_c = min(n, self.cfg["coarse_train_cap"])
        n_p = min(n, self.cfg["pq_train_cap"])
        coarse, pq = [], []
        for call in window.calls:
            log = self.kept[call.index][4]
            (rc, xc, _), (rp, xp, _) = fits(log)
            coarse += [dict(b=1, n=n_c, k=p, m=m)] * (rc + xc)
            if n > n_c:
                coarse.append(dict(b=1, n=n, k=p, m=m))
            pq += [dict(b=d, n=n_p, k=c, m=m // d)] * (rp + xp)
        _, out = self.call(derive(self.cfg["data_seed"], 0x5EED))
        seeding = [sum(f[2] for f in fits(out[4]))]
        return {"coarse": coarse, "pq": pq, "seeding_s": seeding}

    def free_program(self) -> None:
        sync(self.ctx.device)

    def judge(self, window) -> dict:
        done = [call.index for call in window.calls if call.ok]
        if not done:
            return {}
        j = done[derive(self.ctx.seed, 0x1D6E) % len(done)]
        cents, idx, books, codes, _ = self.kept[j]
        self.kept = {j: self.kept[j]}
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
        sample = check_rows(self.x.shape[0], self.ctx.seed,
                            self.cfg["check_rows"], self.x.device)
        p, d, c = self._shape()
        return judge.build_numbers(self.x, cents, idx, books, codes, sample,
                                   p=p, d=d, c=c)
