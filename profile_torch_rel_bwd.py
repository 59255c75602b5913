#!/usr/bin/env python3
"""Where the time of the rel-pos attention backward kernel (K4) goes, on
one NVIDIA GPU.

    python3 profile_torch_rel_bwd.py [--seed 0]

It builds variants of ``lasr_tpu_torch/csrc/rel_attention_bwd.cu`` (and
its headers), each with one part of the work taken out or changed by a
text edit of a copy of the committed sources (``profile_torch_rot_bwd.py``'s
``build_variants``), and times each at chip_smoke's training shape
(BH=256, T=388, dk=40, H=8, ragged kv_len) in f32 and bf16 with CUDA
events:

  base         the committed kernel
  one_product  one TF32 product per tile instead of 3xTF32 (f32)
  no_scores    without the AC, W and dPa products
  no_products  without the dv, dk, dq_u, dq_v and dPwin products (and the
               dp rows' stores)
  no_softmax   without the elementwise step (remap, P, dz, dW scatter)
  no_compute   all three left out: tile copies, barriers and launches
  key_pass     the key pass (dk, dv) alone
  query_pass   the query pass (dq_u, dq_v, dp partials) alone
  dp_reduce    the dp reduction alone
  one_block    __launch_bounds__ for one block per SM instead of two (up
               to 255 registers a thread)

Every variant also runs the small delta kernel.  Variants that leave work
out give wrong gradients; only ``base`` is checked against the plain
version.  It needs a CUDA device and nvcc, and fails without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile

import numpy as np

KERNEL = "rel_attention_bwd.cu"
_OFF = {name: [(KERNEL, f"  {name}{args}<<<", f"  if (0) {name}{args}<<<")]
        for name, args in (("rel_bwd_dkdv_kernel", "<T, NDSX>"),
                           ("rel_bwd_dq_kernel", "<T, NDSX>"),
                           ("rel_bwd_dp_reduce_kernel", "<T>"))}

# (file, anchor, replacement): each anchor must occur in the committed
# source, or the script stops (the kernel changed under it)
EDITS = {
    "one_product": [
        (KERNEL, "constexpr int NS = SplitsFor<T>::value;",
         "constexpr int NS = 1;")],
    "no_scores": [
        (KERNEL, "      scores<NS, NDSX>(", "      if (0) scores<NS, NDSX>("),
        (KERNEL, "    scores<NS, NDSX>(sm.Qu[0]",
         "    if (0) scores<NS, NDSX>(sm.Qu[0]")],
    "no_products": [
        (KERNEL, "        if (!owner[s]) continue;\n        // dv",
         "        if (1) continue;\n        // dv"),
        (KERNEL, "      if (!owner[s]) continue;\n      const int rts",
         "      if (1) continue;\n      const int rts")],
    "no_softmax": [
        (KERNEL, "      softmax_step<false>(", "      if (0) softmax_step<false>("),
        (KERNEL, "    softmax_step<true>(", "    if (0) softmax_step<true>(")],
    "key_pass": _OFF["rel_bwd_dq_kernel"] + _OFF["rel_bwd_dp_reduce_kernel"],
    "query_pass": _OFF["rel_bwd_dkdv_kernel"]
    + _OFF["rel_bwd_dp_reduce_kernel"],
    "dp_reduce": _OFF["rel_bwd_dkdv_kernel"] + _OFF["rel_bwd_dq_kernel"],
    "one_block": [
        (KERNEL, "constexpr int MIN_BLOCKS = 2;",
         "constexpr int MIN_BLOCKS = 1;")],
}
EDITS["no_compute"] = (EDITS["no_scores"] + EDITS["no_products"]
                       + EDITS["no_softmax"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_rel_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from lasr_tpu_torch.ops.rel_attention import (
        TILE, rel_attention_backward_reference, rel_attention_forward)
    from profile_torch_rot_bwd import build_variants, card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, KERNEL, EDITS, "lasr_rel_attention_bwd",
                              16)
        if libs is None:
            return 1
        rng = np.random.default_rng(args.seed)
        dev = torch.device("cuda")
        make = chip_smoke._with_grad_inputs(chip_smoke._rel_inputs,
                                            rel_attention_forward)
        summary = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            a = make(rng, dtype, dev, chip_smoke.TRAINING)
            q_u, q_v, k, v, p, kv_len, out, lse, dout = a
            BH, T, dk = q_u.shape
            H = p.shape[0]
            nqt = -(-T // TILE)
            grads = [torch.empty_like(x) for x in (q_u, q_v, k, v, p)]
            delta = torch.empty((BH, T), dtype=torch.float32, device=dev)
            part = torch.empty((BH, nqt, TILE * (nqt + 1), dk),
                               dtype=torch.float32, device=dev)
            ptrs = [ctypes.c_void_p(x.data_ptr()) for x in
                    (*a, delta, part, *grads)]
            want = rel_attention_backward_reference(*chip_smoke._f32(a))
            for name, fn in libs.items():
                def call(fn=fn, name=name):
                    rc = fn(*ptrs, BH, T, dk, H, int(dtype == torch.bfloat16),
                            ctypes.c_void_p(
                                torch.cuda.current_stream().cuda_stream))
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                note = ""
                if name == "base":
                    err = max(float((g.float() - w).abs().max()
                                    / w.abs().max())
                              for g, w in zip(grads, want))
                    note = f", max_rel_err {err:.2e}"
                ms = chip_smoke.time_ms(call, iters=10, warmup=2)
                summary[f"{dn} {name}"] = ms
                print(f"K4 {dn} {name}: {ms * 1e3:.1f} us{note} [{card}]",
                      flush=True)
    print(json.dumps({"card": card, "ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
