#!/usr/bin/env python3
"""Where the time of the rel-pos attention forward kernel (K3) goes, on
one NVIDIA GPU.

    python3 profile_torch_rel_fwd.py [--seed 0] [--shape training|served]
                                     [--parent-src DIR]

It builds variants of ``lasr_tpu_torch/csrc/rel_attention.cu`` (and its
headers), each with one part of the work taken out or changed by a text
edit of a copy of the committed sources (``profile_torch_rot_bwd.py``'s
``build_variants``), and times each at one of chip_smoke's shapes
(training: BH=256, T=388; served: BH=64, T=248; dk=40, H=8, ragged
kv_len) in f32 and bf16 with CUDA events:

  base         the committed kernel
  one_product  one TF32 product per tile instead of 3xTF32 (f32)
  no_scores    without the AC and W products
  no_pv        without the P·v product and the O update
  no_softmax   without the online softmax step (remap, P)
  no_compute   all three left out: tile copies, barriers, the epilogue
  one_block    one block per SM (the launch asks for 120,000 more bytes
               of shared memory than it uses)
  rows32       blocks of 2 warps, 32 query rows, instead of 4 and 64
  clocks       clock64() stamps around each phase of warp 0's key loop:
               SM cycles per key tile in each phase

It prints each variant's dynamic shared memory and resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  With ``--parent-src
DIR`` (a ``csrc`` directory of another commit) it also builds that
commit's K3 and times it beside ``base`` in the same process, in turns
(parent, base, ..., base, parent); at the training shape it also times
K1, K2 and K4 of both commits through their wrappers in turns.

Variants that leave work out give wrong outputs; only ``base`` and the
parent are checked against the plain version.  It needs a CUDA device
and nvcc, and fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

KERNEL = "rel_attention.cu"

# (file, anchor, replacement): each anchor must occur in the committed
# source, or the script stops (the kernel changed under it)
EDITS = {
    "one_product": [
        (KERNEL, "constexpr int NS = SplitsFor<T>::value;",
         "constexpr int NS = 1;")],
    "no_scores": [
        (KERNEL, "    scores<NS, NDSX>(fu", "    if (0) scores<NS, NDSX>(fu")],
    "no_pv": [
        (KERNEL, "    pv_step<NS, NDSX>(", "    if (0) pv_step<NS, NDSX>("),
        (KERNEL, "    o_update(o,", "    if (0) o_update(o,")],
    "no_softmax": [
        (KERNEL, "    softmax_step<T>(", "    if (0) softmax_step<T>(")],
    "one_block": [
        (KERNEL, "  return 4 * floats + (D.raw",
         "  return 120000 + 4 * floats + (D.raw")],
    "rows32": [
        (KERNEL, "constexpr int WARPS = 4;", "constexpr int WARPS = 2;")],
}
EDITS["no_compute"] = (EDITS["no_scores"] + EDITS["no_pv"]
                       + EDITS["no_softmax"])
# clock64() stamps around each phase of warp 0's key loop, summed over its
# tiles and written (as floats) over lse of the block's first rows
PHASES = ("wait+barrier", "copies", "scores", "softmax", "pv", "o_update")
EDITS["clocks"] = [
    (KERNEL, "  for (int t = 0; t < ntiles; ++t) {",
     "  long long tcy[6] = {0, 0, 0, 0, 0, 0};\n"
     "  for (int t = 0; t < ntiles; ++t) {"),
    (KERNEL, "    cp_async_wait(f32 && !WIDE ? 1 : 0);\n    __syncthreads();",
     "    long long c_0 = clock64();\n"
     "    cp_async_wait(f32 && !WIDE ? 1 : 0);\n"
     "    __syncthreads();\n    long long c_1 = clock64();\n"
     "    tcy[0] += c_1 - c_0;"),
    (KERNEL, "    cp_async_commit();\n    if (!active) continue;",
     "    cp_async_commit();\n    tcy[1] += clock64() - c_1;\n"
     "    if (!active) continue;"),
    (KERNEL, """      scores<NS, NDSX>(fu, fv, Kc, pw, sac, sw, D);
      __syncwarp();
      softmax_step<T>(sac, sw, D.LQ, m, l, alpha, k0, kvl, D);
      __syncwarp();
      pv_step<NS, NDSX>(sac, Vc, sw, D);
      __syncwarp();
      o_update(o, sw, alpha, D);""",
     """      long long c_2 = clock64();
      scores<NS, NDSX>(fu, fv, Kc, pw, sac, sw, D);
      __syncwarp();
      long long c_3 = clock64();
      softmax_step<T>(sac, sw, D.LQ, m, l, alpha, k0, kvl, D);
      __syncwarp();
      long long c_4 = clock64();
      pv_step<NS, NDSX>(sac, Vc, sw, D);
      __syncwarp();
      long long c_5 = clock64();
      o_update(o, sw, alpha, D);
      __syncwarp();
      long long c_6 = clock64();
      tcy[2] += c_3 - c_2;
      tcy[3] += c_4 - c_3;
      tcy[4] += c_5 - c_4;
      tcy[5] += c_6 - c_5;"""),
    (KERNEL, "lse[base + row0 + r] = m + logf(l);",
     "lse[base + row0 + r] = m + logf(l);\n  __syncwarp();\n"
     "  if (warp == 0 && lane == 0)\n    for (int i = 0; i < 6; ++i)\n"
     "      if (q0 + i < D.T) lse[base + q0 + i] = (float)tcy[i];")]
# the kernels that share K3's headers, timed against the parent's with
# --parent-src: chip_smoke's kernel name -> its source
SHARED = {"rot_attention_fwd": "rot_attention",
          "rot_attention_bwd": "rot_attention_bwd",
          "rel_attention_bwd": "rel_attention_bwd"}


def occupancy(lib_path, T, dk, bf16):
    """(dynamic shared memory bytes, resident blocks per SM) of the K3
    library at ``lib_path``, or None where it has no such query."""
    lib = ctypes.CDLL(lib_path)
    fn = getattr(lib, "lasr_rel_attention_fwd_occupancy", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(T, dk, int(bf16), ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query: CUDA error {rc}")
    return smem.value, blocks.value


def clock_line(lse, kv_len, T, bq=64, bk=32):
    """Warp 0's SM cycles per key tile in each phase (the ``clocks``
    variant's stamps in lse), averaged over the blocks with 6 rows."""
    stamps = lse.cpu().numpy()
    ntiles = -(-np.minimum(kv_len.cpu().numpy(), T) // bk)
    per = [stamps[bh, q0:q0 + 6] / ntiles[bh]
           for bh in range(stamps.shape[0]) if ntiles[bh] > 0
           for q0 in range(0, T - 5, bq)]
    mean = np.mean(per, axis=0)
    return "clocks per key tile, warp 0: " + ", ".join(
        f"{n} {c:.0f}" for n, c in zip(PHASES, mean)) + \
        f" (sum {mean.sum():.0f})"


def build_plain(tmp, csrc, names):
    """Each ``csrc/<name>.cu`` built unedited into ``tmp``; {name: path}."""
    from lasr_tpu_torch.ops import cuda_build
    procs = {}
    for name in names:
        lib = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
             os.path.join(csrc, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        out[name] = lib
    return out


def shared_ab(parent_src, rng, card):
    """K1, K2 and K4 of the parent and of this tree, through their
    wrappers (the parent's library swapped in for its turns), in turns
    parent, change, change, parent, at the training shape;
    {"<kernel> <dtype>": [ms x4]}."""
    import torch
    import chip_smoke
    from lasr_tpu_torch.ops import cuda_build
    specs = {s[0]: s for s in chip_smoke._kernel_specs()}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"parent": {n: ctypes.CDLL(p) for n, p in build_plain(
                    tmp, parent_src, SHARED.values()).items()},
                "change": {n: cuda_build.library(n)
                           for n in SHARED.values()}}
        dev = torch.device("cuda")
        for kname, source in SHARED.items():
            kern, make = specs[kname][1], specs[kname][3]
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[-1]
                args = make(rng, dtype, dev, chip_smoke.TRAINING)
                times = []
                for tag in ("parent", "change", "change", "parent"):
                    cuda_build._LIBS[source] = libs[tag][source]
                    times.append(chip_smoke.time_ms(lambda: kern(*args),
                                                    iters=10, warmup=2))
                cuda_build._LIBS[source] = libs["change"][source]
                key = f"{kname} {dn}"
                out[key] = times
                ratio = (times[1] + times[2]) / (times[0] + times[3])
                print(f"{key} training: parent / change / change / parent "
                      + " / ".join(f"{t * 1e3:.1f}" for t in times)
                      + f" us, change / parent {ratio:.4f} [{card}]",
                      flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", choices=("training", "served"),
                    default="training")
    ap.add_argument("--parent-src", default=None,
                    help="a csrc directory of another commit to time K3, "
                         "K1, K2 and K4 against in the same process")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_rel_fwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from lasr_tpu_torch.ops.rel_attention import rel_attention_reference
    from profile_torch_rot_bwd import build_variants, card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    others = ({"parent": os.path.abspath(args.parent_src)}
              if args.parent_src else {})
    rng = np.random.default_rng(args.seed)
    summary = {}
    with tempfile.TemporaryDirectory() as tmp:
        logs = {}
        libs = build_variants(tmp, KERNEL, EDITS, "lasr_rel_attention_fwd",
                              8, others, logs)
        if libs is None:
            return 1
        for name, log in logs.items():
            # ptxas: registers and spills per instantiation (type, NDSX)
            for line in log.splitlines():
                if "Compiling entry" in line:
                    ndsx = re.search(r"Li(\d+)E", line)
                    inst = ("bf16" if "bfloat16" in line else "f32") + (
                        f" NDSX {ndsx.group(1)}" if ndsx else "")
                elif "registers" in line or "spill stores" in line:
                    print(f"ptxas {name} {inst}: {line.strip()}")
        shape = getattr(chip_smoke, args.shape.upper())
        order = list(libs) + (["base", "parent"] if others else [])
        dev = torch.device("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            a = chip_smoke._rel_inputs(rng, dtype, dev, shape)
            q_u, p = a[0], a[4]
            BH, T, dk = q_u.shape
            H = p.shape[0]
            out = torch.empty_like(q_u)
            lse = torch.empty((BH, T), dtype=torch.float32, device=dev)
            ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (*a, out, lse)]
            want, want_lse = rel_attention_reference(*chip_smoke._f32(a))
            finite = torch.isfinite(want_lse)
            # clocks up before the first timed turn
            chip_smoke.time_ms(lambda: libs["base"](
                *ptrs, BH, T, dk, H, int(dtype == torch.bfloat16),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)),
                iters=50, warmup=10, repeats=4)
            for name in order:
                fn = libs[name]

                def call(fn=fn, name=name):
                    rc = fn(*ptrs, BH, T, dk, H, int(dtype == torch.bfloat16),
                            ctypes.c_void_p(
                                torch.cuda.current_stream().cuda_stream))
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                note = ""
                if name in ("base", "parent"):
                    err = max(float((out.float() - want).abs().max()),
                              float((lse[finite]
                                     - want_lse[finite]).abs().max()))
                    note = f", max_abs_err {err:.2e}"
                    chip_smoke.check(err <= chip_smoke.TOL[dn],
                                     f"{name} {dn}: error {err}")
                occ = occupancy(os.path.join(tmp, f"lib{name}.so"), T, dk,
                                dtype == torch.bfloat16)
                if occ is not None:
                    note += f", smem {occ[0]} B, {occ[1]} blocks/SM"
                if name == "clocks":
                    print(f"K3 {args.shape} {dn} {clock_line(lse, a[5], T)}",
                          flush=True)
                ms = chip_smoke.time_ms(call, iters=10, warmup=2)
                key = f"{dn} {name}"
                if key in summary:
                    key += " again"
                summary[key] = ms
                print(f"K3 {args.shape} {key}: {ms * 1e3:.1f} us{note}"
                      f" [{card}]", flush=True)
    result = {"card": card, "shape": args.shape, "ms": summary}
    if others and args.shape == "training":
        result["shared_ab_ms"] = shared_ab(others["parent"], rng, card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
