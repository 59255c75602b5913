#!/usr/bin/env python3
"""Where the time of the rotated-fold backward kernel (K2) goes, on one
NVIDIA GPU.

    python3 profile_torch_rot_bwd.py [--seed 0]

It builds variants of ``lasr_tpu_torch/csrc/rot_attention_bwd.cu`` (and
its headers ``mma_tf32.cuh``, ``tile_io.cuh``), each with one part of the
work taken out or changed by a text edit of a copy of the committed
sources, and times each at chip_smoke's training shape (BH=256, T=388,
dk=40, M=320, ragged kv_len) in f32 and bf16 with CUDA events:

  base         the committed kernel
  one_product  one TF32 product per tile instead of 3xTF32 (f32)
  cvt_split    the 3xTF32 split by rounding conversion (cvt.rna.tf32.f32)
               instead of the bit mask
  no_scores    without the S and dP products
  no_products  without the [dq_u ; du], dk and dv products
  no_softmax   without the elementwise P / dz step
  no_compute   all three left out: tile copies, barriers and launches
  query_pass   the query pass (dq_u, du) alone
  key_pass     the key pass (dk, dv) alone

Variants that leave work out give wrong gradients; only ``base`` is
checked against the plain version.  The builds go to a temporary
directory.  It needs a CUDA device and nvcc, and fails without them.
``build_variants`` serves ``profile_torch_rot_fwd.py`` too.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

KERNEL = "rot_attention_bwd.cu"
HEADER = "mma_tf32.cuh"

# (file, anchor, replacement): each anchor must occur in the committed
# source, or the script stops (the kernel changed under it)
EDITS = {
    "one_product": [
        (KERNEL, "constexpr int NS = SplitsFor<T>::value;",
         "constexpr int NS = 1;")],
    "cvt_split": [
        (HEADER, "return __uint_as_float(__float_as_uint(x) & 0xffffe000u);",
         "return wmma::__float_to_tf32(x);"),
        (HEADER, "s.lo.x[t] = x - h;",
         "s.lo.x[t] = wmma::__float_to_tf32(x - h);")],
    "no_scores": [
        (KERNEL, "      scores<NS>(", "      if (0) scores<NS>("),
        (KERNEL, "    scores<NS>(sm.Q[0]", "    if (0) scores<NS>(sm.Q[0]")],
    "no_products": [
        (KERNEL, "      if (owner) {\n        // dv",
         "      if (0) {\n        // dv"),
        (KERNEL, "        if (ct < ct1) {", "        if (0) {")],
    "no_softmax": [
        (KERNEL, "      softmax_step(", "      if (0) softmax_step("),
        (KERNEL, "    softmax_step(sm.S0", "    if (0) softmax_step(sm.S0")],
    "query_pass": [
        (KERNEL, "  rot_bwd_dkdv_kernel<T><<<",
         "  if (0) rot_bwd_dkdv_kernel<T><<<")],
    "key_pass": [
        (KERNEL, "  rot_bwd_dq_kernel<T><<<",
         "  if (0) rot_bwd_dq_kernel<T><<<")],
}
EDITS["no_compute"] = (EDITS["no_scores"] + EDITS["no_products"]
                       + EDITS["no_softmax"])


def write_variant(csrc, out_dir, name, kernel, edits):
    """A copy of ``kernel`` and every shared header of ``csrc`` in
    ``out_dir/name``, with the variant's edits; returns the kernel's path."""
    files = [kernel, *sorted(f for f in os.listdir(csrc)
                             if f.endswith(".cuh"))]
    sources = {f: open(os.path.join(csrc, f)).read() for f in files}
    for fname, anchor, new in edits.get(name, []):
        if anchor not in sources[fname]:
            raise RuntimeError(f"{name}: anchor not found in {fname}: "
                               f"{anchor!r}")
        sources[fname] = sources[fname].replace(anchor, new)
    d = os.path.join(out_dir, name)
    os.makedirs(d)
    for fname, text in sources.items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    return os.path.join(d, kernel)


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def build_variants(tmp, kernel, edits, symbol, n_ptr, others=None,
                   logs=None):
    """Builds ``base`` and every variant of ``edits`` in parallel under
    ``tmp``, and each entry of ``others`` ({name: a csrc directory}, e.g.
    a parent commit's) unedited; returns {name: the C entry point
    ``symbol`` (n_ptr pointers, 5 ints, the stream)}, or None after
    printing nvcc's log of a failed build.  ``logs``, a dict, receives
    each build's nvcc output (ptxas's registers and spills)."""
    from lasr_tpu_torch.ops import cuda_build
    others = others or {}
    procs = {}
    for name in [*others, "base", *edits]:
        src = write_variant(str(others.get(name, cuda_build.CSRC)), tmp,
                            name, kernel, edits)
        lib = os.path.join(tmp, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return None
        if logs is not None:
            logs[name] = log
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_rot_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from lasr_tpu_torch.ops.rot_attention import (
        rot_attention_backward_reference, rot_attention_forward)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    names = ["base", *EDITS]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, KERNEL, EDITS, "lasr_rot_attention_bwd",
                              14)
        if libs is None:
            return 1

        rng = np.random.default_rng(args.seed)
        dev = torch.device("cuda")
        make = chip_smoke._with_grad_inputs(chip_smoke._rot_inputs,
                                            rot_attention_forward)
        summary = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            a = make(rng, dtype, dev, chip_smoke.TRAINING)
            q_u, u, k, v, vt, kv_len, out, lse, dout = a
            BH, T, dk = q_u.shape
            grads = [torch.empty_like(x) for x in (q_u, u, k, v)]
            delta = torch.empty((BH, T), dtype=torch.float32, device=dev)
            ptrs = [ctypes.c_void_p(x.data_ptr()) for x in
                    (*a, delta, *grads)]
            want = rot_attention_backward_reference(
                *chip_smoke._f32(a[:6]), out.float(), lse, dout.float())
            for name in names:
                def call(fn=libs[name]):
                    rc = fn(*ptrs, BH, T, dk, u.shape[-1],
                            int(dtype == torch.bfloat16), ctypes.c_void_p(
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
                print(f"K2 {dn} {name}: {ms * 1e3:.1f} us{note} [{card}]",
                      flush=True)
    import json
    print(json.dumps({"card": card, "ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
