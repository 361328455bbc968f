#!/usr/bin/env python3
"""Where K-C fast's time goes, on one NVIDIA GPU: builds variants of
``flechasdb_tpu_torch/csrc/lloyd_grouped_fast.cu`` (and, with ``--parent
DIR``, of the ``fast_math`` instance of ``DIR``'s
``flechasdb_tpu_torch/csrc/lloyd_grouped.cu``, the ``mma.sync`` K-C fast
it replaced) that each leave out one part of the work, and times each
beside the kernel, in turns, on the same tensors.

    python3 profile_kcfast.py [--parent DIR] [--seed N] [--out F]

There is no ``ncu`` on the card's machine, so this is how the kernel's
parts are weighed. The variants keep the launch, the tiling and the
copies of the centroids; their results are wrong by design except the
kernel's, ``serial``'s and ``index_tree``'s:

- ``kernel``: the kernel as it is (this tree's indices checked against
  the library's);
- ``no_fold``: the fold replaced by one add and one min a tile (the
  products, with two of their results read);
- ``no_products``: no MMA is issued; the fold runs on zeros the compiler
  cannot see (the fold, x and the centroids alone);
- ``no_x``: x is never copied to shared memory (this tree: the TMA is not
  issued and its barrier completed by a bare arrival; the parent: no
  ``cp.async``); the fragments are rounded from whatever the slot holds;
- ``no_reload`` (this tree): the centroid tiles are loaded from L2 only in
  a block's first row block, as ``profile_kbfast.py``'s variant;
- ``serial`` (this tree): a division's products are issued only after
  the last division is folded;
- ``index_tree`` (this tree): K-B fast's fold, a tree that carries each
  node's index by a compare and a select, in place of the descent.

Each variant's source and library go to ``build/profile_kcfast/``
(gitignored), built with the package's ``nvcc`` flags (all variants in
parallel). Times are the device time of one launch of the assignment
kernel (``grouped_fast_assign``, or the parent's ``grouped_round_kernel``;
``chip_smoke.kernel_device_ms``), median of three windows, in turns: each
tree's kernel, its variants, its variants again, its kernel, at each shape
(the SIFT PQ fit, B=8, N=1M, K=256, m=16, and m=8 at B=16, N=100k).
Then each kernel's SASS (``cuobjdump -sass`` of its library) is read for
the loop that issues the products: its instructions, those of the SM's
ALU pipe (compares, selects, min/max, logic, integer adds) apart, over
the distances a thread folds in one trip (a static count: the loop's
body once). A line a run is printed and all are written to ``--out``
(default ``chiprun_out/profile_kcfast.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from collections import Counter
from pathlib import Path

import chip_smoke as cs
from profile_kbfast import build_variants

SRC = Path("flechasdb_tpu_torch/csrc/lloyd_grouped_fast.cu")
PARENT_SRC = Path("flechasdb_tpu_torch/csrc/lloyd_grouped.cu")
BUILD = Path("build/profile_kcfast")

# (name, [(text of the source, its replacement), ...]).
VARIANTS = [
    ("kernel", []),
    ("no_fold", [(
        "                                     float (&best)[2], "
        "int (&bk)[2]) {\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {",
        "                                     float (&best)[2], "
        "int (&bk)[2]) {\n"
        "  best[0] = fminf(best[0], d[0] + d[31]);\n  bk[0] = k0t;\n"
        "  return;\n#pragma unroll\n  for (int r = 0; r < 2; ++r) {")]),
    ("no_products", [(
        "      mma_bf16(n8(d, 2 * jj), a[s], b[0], b[1]);\n"
        "      mma_bf16(n8(d, 2 * jj + 1), a[s], b[2], b[3]);\n",
        "      if (tile == 1) {\n"
        "        mma_bf16(n8(d, 2 * jj), a[s], b[0], b[1]);\n"
        "        mma_bf16(n8(d, 2 * jj + 1), a[s], b[2], b[3]);\n"
        "      }\n")]),
    ("no_x", [(
        "        mbar_expect_tx(x_full, kXBytes);\n"
        "        for (int i = 0; i < kNC; ++i) {",
        "        mbar_arrive(x_full);\n"
        "        if (N < 0)\n"
        "        for (int i = 0; i < kNC; ++i) {")]),
    ("no_reload", [(
        "            mbar_wait(empty + slot, phase ^ 1);\n"
        "            mbar_expect_tx(full + slot, kStage);\n",
        "            mbar_wait(empty + slot, phase ^ 1);\n"
        "            if (r != blockIdx.x) {\n"
        "              mbar_arrive(full + slot);\n"
        "              if (++slot == f.stages) {\n"
        "                slot = 0;\n"
        "                phase ^= 1;\n"
        "              }\n"
        "              continue;\n"
        "            }\n"
        "            mbar_expect_tx(full + slot, kStage);\n")]),
    ("serial", [("        // Division q + 1's products are issued before division q is\n        // folded, so the tensor cores work beside the fold (at m = 64, one\n        // division's four steps at a time: two sets spill there).\n        constexpr bool ahead = D::S <= 2;\n        float d0[32], d1[32];\n        if (ahead) products<M>(d0, a, at, p * D::P, lrow, khalf, rx);\n#pragma unroll\n        for (int q = 0; q < D::P; ++q) {\n          float(&d)[32] = q & 1 && ahead ? d1 : d0;\n          if (!ahead) {\n            products<M>(d, a, at, p * D::P + q, lrow, khalf, rx);\n          } else if (q + 1 < D::P) {\n            products<M>(q & 1 ? d0 : d1, a, at, p * D::P + q + 1, lrow,\n                        khalf, rx);\n          }\n          if (q + (ahead ? 2 : 1) == D::P) {  // the tile's last products\n            __syncwarp();\n            if (lane == 0) mbar_arrive(bars + 16 + 8 * (f.stages + slot));\n          }\n          float2 ck[8];\n          load_cc(ck, ccb + (size_t)q * f.kp + j * kTile, 0);\n          fold(d, ck, j * kTile + 2 * t, best[q], bk[q]);\n        }\n",
        '#pragma unroll\n        for (int q = 0; q < D::P; ++q) {\n          float d[32];\n          float2 ck[8];\n          products<M>(d, a, at, p * D::P + q, lrow, khalf, rx);\n          load_cc(ck, ccb + (size_t)q * f.kp + j * kTile, 0);\n          if (q + 1 == D::P) {\n            __syncwarp();\n            if (lane == 0) mbar_arrive(bars + 16 + 8 * (f.stages + slot));\n          }\n          fold(d, ck, j * kTile + 2 * t, best[q], bk[q]);\n        }\n')]),
    ("index_tree", [("    float v[16], w[8], y[4], z[2];\n#pragma unroll\n    for (int j = 0; j < 8; ++j) {\n      v[2 * j] = fmaf(-2.f, d[4 * j + 2 * r], ck[j].x);\n      v[2 * j + 1] = fmaf(-2.f, d[4 * j + 2 * r + 1], ck[j].y);\n    }\n#pragma unroll\n    for (int j = 0; j < 8; ++j) w[j] = fminf(v[2 * j], v[2 * j + 1]);\n#pragma unroll\n    for (int j = 0; j < 4; ++j) y[j] = fminf(w[2 * j], w[2 * j + 1]);\n    z[0] = fminf(y[0], y[1]);\n    z[1] = fminf(y[2], y[3]);\n    const float tm = fminf(z[0], z[1]);\n    // i = 8 b3 + 4 b2 + 2 b1 + b0, each bit set where the left subtree's\n    // minimum exceeds the tile's.\n    const bool b3 = z[0] != tm;\n    const bool b2 = (b3 ? y[2] : y[0]) != tm;\n    const float wl = b3 ? (b2 ? w[6] : w[4]) : (b2 ? w[2] : w[0]);\n    const bool b1 = wl != tm;\n    const float v0 = b1 ? (b2 ? v[6] : v[2]) : (b2 ? v[4] : v[0]);\n    const float v1 = b1 ? (b2 ? v[14] : v[10]) : (b2 ? v[12] : v[8]);\n    const bool b0 = (b3 ? v1 : v0) != tm;\n    // Column 8 j + h of the thread's 16: 32 b3 + 16 b2 + 8 b1 + b0.\n    const int col = (b3 ? 32 : 0) + (b2 ? 16 : 0) + (b1 ? 8 : 0) + b0;\n    bk[r] = select_lt(tm, best[r], k0t + col, bk[r]);\n    best[r] = fminf(tm, best[r]);\n",
        '    float v[16];\n    int ix[16];\n#pragma unroll\n    for (int j = 0; j < 8; ++j) {\n      v[2 * j] = fmaf(-2.f, d[4 * j + 2 * r], ck[j].x);\n      v[2 * j + 1] = fmaf(-2.f, d[4 * j + 2 * r + 1], ck[j].y);\n    }\n#pragma unroll\n    for (int i = 0; i < 16; ++i) ix[i] = 8 * (i >> 1) + (i & 1);\n#pragma unroll\n    for (int w = 1; w < 16; w *= 2) {\n#pragma unroll\n      for (int i = 0; i < 16; i += 2 * w) {\n        ix[i] = select_lt(v[i + w], v[i], ix[i + w], ix[i]);\n        v[i] = fminf(v[i], v[i + w]);\n      }\n    }\n    bk[r] = select_lt(v[0], best[r], k0t + ix[0], bk[r]);\n    best[r] = fminf(v[0], best[r]);\n')]),
]

# The parent's fast_math instance (its FAST template argument).
PARENT_VARIANTS = [
    ("kernel", []),
    ("no_fold", [(
        "      auto fold = [&](const float (&acc)[S::MT][S::NJ][4], int j0) {\n",
        "      auto fold = [&](const float (&acc)[S::MT][S::NJ][4], int j0) {\n"
        "        float sum = 0.f;\n"
        "        for (int i = 0; i < S::MT; ++i)\n"
        "          for (int j = 0; j < S::NJ; ++j)\n"
        "            for (int e = 0; e < 4; ++e) sum += acc[i][j][e];\n"
        "        if (sum < best[0][0]) {\n"
        "          best[0][0] = sum;\n"
        "          best_k[0][0] = j0;\n"
        "        }\n"
        "        return;\n")]),
    ("no_products", [(
        "                mma_bf16(acc[i][j], ah[i][s], bf[j].x, bf[j].y);",
        "                if (N < 0) mma_bf16(acc[i][j], ah[i][s], bf[j].x, "
        "bf[j].y);")]),
    ("no_x", [(
        "    cp_async<16>(slot + r * S::LD + q,",
        "    if (N < 0) cp_async<16>(slot + r * S::LD + q,")]),
]

# (label, B, N, K, m).
SHAPES = [("SIFT PQ", 8, cs.SIFT_N, cs.C, 16), ("m=8", 16, cs.N, cs.C, 8)]

# SASS opcodes issued to the ALU pipe (compares, selects, min/max, logic,
# integer adds and shifts).
ALU = {"FSETP", "FSEL", "SEL", "FMNMX", "ISETP", "PLOP3", "LOP3", "IADD3",
       "SHF", "PRMT", "IMNMX", "VIMNMX", "P2R", "R2P", "FSET", "ISET"}


def sass_loop(so: Path, kernel: str, mma: str) -> dict:
    """The instructions of the smallest loop (a backward branch's range)
    in ``kernel``'s SASS that issues an ``mma`` instruction: opcode counts,
    the total and the ALU pipe's."""
    text = subprocess.run(["cuobjdump", "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next((f for f in funcs[1:] if kernel in f.split("\n", 1)[0]),
                None)
    if body is None:
        return {"error": f"no function {kernel}"}
    insns = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                     r"([^;]*);", line)
        if m:
            op = m.group(3)
            target = None
            if op.split(".")[0] in ("BRA", "BRX"):
                t = re.search(r"0x([0-9a-f]+)", m.group(4))
                target = int(t.group(1), 16) if t else None
            insns.append((int(m.group(1), 16), op, target, line.strip()))
    best = None
    for addr, op, target, _ in insns:
        if target is None or target >= addr:
            continue
        loop = [(o, t) for a, o, _, t in insns if target <= a <= addr]
        if any(o.startswith(mma) for o, _ in loop) and \
                (best is None or len(loop) < len(best)):
            best = loop
    if best is None:
        return {"error": f"no loop issues {mma}"}
    ops = Counter(o.split(".")[0] for o, _ in best)
    return {"instructions": len(best),
            "alu": sum(v for k, v in ops.items() if k in ALU),
            "ops": dict(ops.most_common()),
            "listing": [t for _, t in best]}


def ptxas_lines(log: str, kernel: str) -> list:
    """``ptxas -v``'s registers and spills of each instance of
    ``kernel``, and its warnings about it."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
        elif name and ("spill" in line or "Used" in line):
            inst = re.search(r"ILi(\d+)E", name)
            out.append(f"M={inst.group(1) if inst else '?'}: "
                       + line.strip())
        if kernel in line and "Performance" in line:
            out.append(line.strip())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a tree whose mma.sync K-C fast "
                    "(lloyd_grouped.cu's fast_math instance) is profiled too")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="chiprun_out/profile_kcfast.json")
    args = ap.parse_args()

    import torch
    cs.setup(torch)
    from flechasdb_tpu_torch import _kernels
    from flechasdb_tpu_torch.ops import lloyd
    nvcc, flags = _kernels._nvcc(), _kernels.NVCC_FLAGS
    p, i = ctypes.c_void_p, ctypes.c_int
    trees = {}
    built = build_variants(nvcc, flags, SRC, VARIANTS, BUILD, "this_")
    libs = {}
    for name, (so, _) in built.items():
        lib = ctypes.CDLL(str(so))
        lib.fdb_lloyd_grouped_fast.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.fdb_lloyd_grouped_fast.restype = i
        libs[name] = lib
    trees["this"] = (libs, built, "grouped_fast_assign")
    if args.parent:
        pbuilt = build_variants(nvcc, flags,
                                Path(args.parent) / PARENT_SRC,
                                PARENT_VARIANTS, BUILD, "parent_")
        plibs = {}
        for name, (so, _) in pbuilt.items():
            lib = ctypes.CDLL(str(so))
            lib.fdb_lloyd_grouped.argtypes = [p] * 4 + [i] * 6 + [p]
            lib.fdb_lloyd_grouped.restype = i
            plibs[name] = lib
        trees["parent"] = (plibs, pbuilt, "grouped_round_kernel")

    records = []
    for tree, (_, blt, key) in trees.items():
        for name, (_, log) in blt.items():
            for line in ptxas_lines(log, key):
                cs.log(f"[{tree}] {name} ptxas {line}")
    # Static SASS of each tree's kernel at m = 16 and the distances a
    # thread folds in one trip of its product loop: this tree, a tile for
    # each division of a pass (32 each); the parent, two groups of 2 n8
    # tiles on 2 m16 tiles (2 x 16). The loop's listing goes beside --out.
    for tree, (_, blt, _) in trees.items():
        so = blt["kernel"][0]
        if tree == "this":
            r = sass_loop(so, "grouped_fast_assignILi16E", "HMMA")
            per_trip = 32 * lloyd.grouped_fast_tiling(8, 1, 256, 16).per_pass
        else:
            r = sass_loop(so, "grouped_round_kernelILi16ELb1E", "HMMA")
            per_trip = 32
        r.update(tree=tree, part="sass", m=16, distances_a_trip=per_trip)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).with_name(f"kcfast_loop_{tree}.sass").write_text(
            "\n".join(r.pop("listing", [])))
        if "instructions" in r:
            r["per_distance"] = r["instructions"] / per_trip
            r["alu_per_distance"] = r["alu"] / per_trip
            cs.log(f"[{tree}] SASS, the product loop at m=16: "
                   f"{r['instructions']} instructions, {r['alu']} on the ALU "
                   f"pipe, for {per_trip} distances a thread: "
                   f"{r['per_distance']:.2f} a distance "
                   f"({r['alu_per_distance']:.2f} ALU); {r['ops']}")
        else:
            cs.log(f"[{tree}] SASS: {r['error']}")
        records.append(r)

    gen = torch.Generator("cuda").manual_seed(args.seed)
    for label, b, n, k, m in SHAPES:
        x = torch.randn((b, n, m), generator=gen, device="cuda")
        c = x[:, torch.randint(0, n, (k,), generator=gen, device="cuda")] \
            .contiguous()
        xg = lloyd.regroup_divisions(x)
        want, cs_, ccp = lloyd._assign_grouped_fast(xg, c)
        cc = (c * c).sum(-1).contiguous()
        t = lloyd.grouped_fast_tiling(b, n, k, m)
        idx = torch.empty((b, n), dtype=torch.int32, device="cuda")
        bms, by = cs.bound(xg.numel() * 4 + 4 * (b * k * m + b * n),
                           2.0 * b * n * k * m, cs.BF16_FLOPS,
                           "operations (bf16 tensor cores)")
        for tree, (tlibs, _, key) in trees.items():
            names = list(tlibs)
            order = names + names[1:][::-1] + names[:1]
            for turn, name in enumerate(order):
                lib = tlibs[name]

                def call():
                    if tree == "this":
                        rc = lib.fdb_lloyd_grouped_fast(
                            xg.data_ptr(), c.data_ptr(), cs_.data_ptr(),
                            ccp.data_ptr(), idx.data_ptr(), b, t.groups, n,
                            k, m, t.kp, t.stages, _kernels.stream_of(x))
                    else:
                        rc = lib.fdb_lloyd_grouped(
                            xg.data_ptr(), c.data_ptr(), cc.data_ptr(),
                            idx.data_ptr(), b, t.groups, n, k, m, 1,
                            _kernels.stream_of(x))
                    _kernels.check(rc, f"{tree} variant {name}")
                ms = statistics.median(
                    cs.kernel_device_ms(torch, call, key)["ms"]
                    for _ in range(3))
                if name == "kernel" and tree == "this":
                    cs.require(torch.equal(idx, want), "the kernel built "
                               "here differs from the library")
                records.append({"shape": label, "b": b, "n": n, "k": k,
                                "m": m, "tree": tree, "variant": name,
                                "turn": turn, "ms": ms, "bound_ms": bms,
                                "bound_by": by})
                cs.log(f"{label} B={b} N={n} K={k} m={m} [{tree}] {name}: "
                       f"{ms:.4f} ms device a launch, bound {bms:.4f} ms "
                       f"({by})")
        del x, c, xg, want, cs_, ccp, cc, idx
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))
    print(json.dumps({"ok": True, "records": len(records),
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
