#!/usr/bin/env python3
"""Where the time of the rotated-fold forward kernel (K1) goes, on one
NVIDIA GPU.

    python3 profile_torch_rot_fwd.py [--seed 0] [--shape training|served]

It builds variants of ``lasr_tpu_torch/csrc/rot_attention.cu`` (and its
headers), each with one part of the work taken out or changed by a text
edit of a copy of the committed sources (``profile_torch_rot_bwd.py``'s
``build_variants``), and times each at one of chip_smoke's shapes
(training: BH=256, T=388; served: BH=64, T=248; dk=40, M=320, ragged
kv_len) in f32 and bf16 with CUDA events:

  base         the committed kernel
  one_product  one TF32 product per tile instead of 3xTF32 (f32)
  no_scores    without the S = [q_u ; u]·[k ; V]^T product
  no_pv        without the P·v product and the O update
  no_softmax   without the online softmax step
  no_compute   all three left out: tile copies, barriers, the epilogue

Variants that leave work out give wrong outputs; only ``base`` is checked
against the plain version.  It needs a CUDA device and nvcc, and fails
without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile

import numpy as np

KERNEL = "rot_attention.cu"

# (file, anchor, replacement): each anchor must occur in the committed
# source, or the script stops (the kernel changed under it)
EDITS = {
    "one_product": [
        (KERNEL, "constexpr int NS = SplitsFor<T>::value;",
         "constexpr int NS = 1;")],
    "no_scores": [
        (KERNEL, "    scores<NS>(sm.Q", "    if (0) scores<NS>(sm.Q")],
    "no_pv": [
        (KERNEL, "    if (owner) pv_step<NS>(", "    if (0) pv_step<NS>("),
        (KERNEL, "    o_update(o,", "    if (0) o_update(o,")],
    "no_softmax": [
        (KERNEL, "    softmax_step<T>(", "    if (0) softmax_step<T>(")],
}
EDITS["no_compute"] = (EDITS["no_scores"] + EDITS["no_pv"]
                       + EDITS["no_softmax"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shape", choices=("training", "served"),
                    default="training")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_rot_fwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from lasr_tpu_torch.ops.rot_attention import rot_attention_reference
    from profile_torch_rot_bwd import build_variants, card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, KERNEL, EDITS, "lasr_rot_attention_fwd", 8)
        if libs is None:
            return 1
        rng = np.random.default_rng(args.seed)
        dev = torch.device("cuda")
        summary = {}
        shape = getattr(chip_smoke, args.shape.upper())
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            a = chip_smoke._rot_inputs(rng, dtype, dev, shape)
            q_u, u = a[:2]
            BH, T, dk = q_u.shape
            out = torch.empty_like(q_u)
            lse = torch.empty((BH, T), dtype=torch.float32, device=dev)
            ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (*a, out, lse)]
            want, want_lse = rot_attention_reference(*chip_smoke._f32(a))
            for name, fn in libs.items():
                def call(fn=fn, name=name):
                    rc = fn(*ptrs, BH, T, dk, u.shape[-1],
                            int(dtype == torch.bfloat16), ctypes.c_void_p(
                                torch.cuda.current_stream().cuda_stream))
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                note = ""
                if name == "base":
                    err = max(float((out.float() - want).abs().max()),
                              float((lse - want_lse).abs().max()))
                    note = f", max_abs_err {err:.2e}"
                ms = chip_smoke.time_ms(call, iters=10, warmup=2)
                summary[f"{dn} {name}"] = ms
                print(f"K1 {args.shape} {dn} {name}: {ms * 1e3:.1f} us{note}"
                      f" [{card}]", flush=True)
    print(json.dumps({"card": card, "shape": args.shape, "ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
