#!/usr/bin/env python3
"""Where K-B fast's time goes, on one NVIDIA GPU: builds variants of
``flechasdb_tpu_torch/csrc/lloyd_round_fast.cu`` that each leave out one
part of the work, and times each beside the kernel, in turns, on the same
tensors at the fast builds' timed shapes.

    python3 profile_kbfast.py [--seed N] [--out F]

There is no ``ncu`` on the card's machine, so this is how the kernel's
parts are weighed. The variants keep the launch, the tiling and the ring;
their results are wrong by design:

- ``kernel``: the kernel as it is (its indices checked against the
  library's);
- ``no_reload``: the centroid tiles are loaded from L2 only in a block's
  first row block; afterwards the producer completes each ring slot with a
  bare arrival and the consumers reuse the stale tiles (no L2 traffic for
  the centroids);
- ``no_products``: no wgmma is issued; the fold runs on stale
  accumulators (the fold, x and the ring alone);
- ``light_fold``: the fold replaced by a sum of the accumulators (the
  products, with their results read).

Each variant's source and library go to ``build/profile_kbfast/``
(gitignored), built with the package's ``nvcc`` flags (the variants in
parallel), and each is called through the same C
entry as ``ops.lloyd._assign_fast``. Times are the device time of one
``assign_fast_kernel`` launch (``chip_smoke.kernel_device_ms``), median of
three windows, in turns kernel, variants, variants, kernel. A line a run is
printed and all are written to ``--out`` (default
``chiprun_out/profile_kbfast.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import chip_smoke as cs

SRC = Path("flechasdb_tpu_torch/csrc/lloyd_round_fast.cu")
BUILD = Path("build/profile_kbfast")

# (name, [(text of the source, its replacement), ...]).
VARIANTS = [
    ("kernel", []),
    ("no_reload", [(
        "              mbar_wait(empty + slot, phase ^ 1);\n"
        "              mbar_expect_tx(full + slot, L::kStage);\n",
        "              mbar_wait(empty + slot, phase ^ 1);\n"
        "              if (r != blockIdx.x) {\n"
        "                mbar_arrive(full + slot);\n"
        "                if (++slot == f.stages) {\n"
        "                  slot = 0;\n"
        "                  phase ^= 1;\n"
        "                }\n"
        "                continue;\n"
        "              }\n"
        "              mbar_expect_tx(full + slot, L::kStage);\n")]),
    ("no_products", [(
        "    wgmma64(d, a[s], desc + step, fresh && s == 0 ? 0u : 1u);",
        "    if (desc == 1) wgmma64(d, a[s], desc + step, 1u);")]),
    ("light_fold", [(
        "                                     float (&best)[2], "
        "int (&bk)[2]) {\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {",
        "                                     float (&best)[2], "
        "int (&bk)[2]) {\n  float s = 0.f;\n#pragma unroll\n"
        "  for (int i = 0; i < 32; ++i) s += d[i];\n"
        "  if (s < best[0]) {\n    best[0] = s;\n    bk[0] = k0;\n  }\n"
        "  return;\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {")]),
]

SHAPES = [("SIFT coarse", 1, cs.SIFT_N, cs.SIFT_P, cs.SIFT_M),
          ("PQ", cs.D, cs.N, cs.C, cs.M // cs.D),
          ("headline coarse", 1, cs.N, cs.P, cs.M)]


def build_variants(nvcc: str, flags, src_path: Path, variants, out: Path,
                   tag: str = "") -> dict:
    """Each variant of ``src_path`` (``(name, [(text, replacement),
    ...])``) built into ``out`` as a library of its own, the variants
    compiled in parallel; ``{name: (library path, compiler output)}``."""
    text = src_path.read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants:
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: its text is not in "
                                 f"{src_path} once; update the variant")
            src = src.replace(old, new)
        cu, so = out / f"{tag}{name}.cu", out / f"{tag}{name}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-I", str(src_path.parent), "-o", str(so),
             str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        built[name] = (so.resolve(), log)
    return built


def build(nvcc: str, flags) -> dict:
    """Each variant's library, the variants compiled in parallel."""
    libs = {}
    for name, (so, _) in build_variants(nvcc, flags, SRC, VARIANTS,
                                        BUILD).items():
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fdb_lloyd_round_fast.argtypes = [p, p, p, p, p] + [i] * 8 + [p]
        lib.fdb_lloyd_round_fast.restype = i
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="chiprun_out/profile_kbfast.json")
    args = ap.parse_args()

    import torch
    cs.setup(torch)
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.ops import lloyd
    libs = build(_kernels._nvcc(), _kernels.NVCC_FLAGS)
    gen = torch.Generator("cuda").manual_seed(args.seed)
    names = [n for n, _ in VARIANTS]
    order = names + names[1:][::-1] + names[:1]
    records = []
    for label, b, n, k, m in SHAPES:
        x = torch.randn((b, n, m), generator=gen, device="cuda")
        c = x[:, torch.randint(0, n, (k,), generator=gen, device="cuda")] \
            .contiguous()
        want, cs_, ccp = lloyd._assign_fast(x, c)
        t = lloyd.fast_tiling(b, n, k, m)
        idx = torch.empty_like(want)
        bms, by = cs.bound(x.numel() * 4 + 4 * (b * k * m + b * n),
                           2.0 * b * n * k * m, cs.BF16_FLOPS,
                           "operations (bf16 tensor cores)")
        for turn, name in enumerate(order):
            lib = libs[name]

            def call():
                rc = lib.fdb_lloyd_round_fast(
                    x.data_ptr(), c.data_ptr(), cs_.data_ptr(),
                    ccp.data_ptr(), idx.data_ptr(), b, n, k, m, t.kp, t.mp,
                    t.chunk, t.stages, _kernels.stream_of(x))
                _kernels.check(rc, f"variant {name}")
            ms = statistics.median(
                cs.kernel_device_ms(torch, call, "assign_fast_kernel")["ms"]
                for _ in range(3))
            if name == "kernel":
                cs.require(torch.equal(idx, want),
                           "the kernel built here differs from the library")
            records.append({"shape": label, "b": b, "n": n, "k": k, "m": m,
                            "variant": name, "turn": turn, "ms": ms,
                            "bound_ms": bms, "bound_by": by})
            cs.log(f"{label} B={b} N={n} K={k} M={m} {name}: {ms:.4f} ms "
                   f"device a launch, bound {bms:.4f} ms ({by})")
        del x, c, want, cs_, ccp, idx
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    print(json.dumps({"ok": True, "records": len(records),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
