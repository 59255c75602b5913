#!/usr/bin/env python3
"""Smoke run of the lasr_tpu_torch port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py [--seed 0]

Phases, always all of them, in this order:
  device   the card's name, count and power limit; TF32 off for matmuls
           and cuDNN convolutions (the port's numbers are full f32).
  build    compile every kernel of ``lasr_tpu_torch/csrc`` with nvcc
           (one process per source, in parallel) and print ptxas's
           registers / shared memory per kernel.
  kernels  each kernel at the served shape (B=8 x 10 s -> BH=64, T=248,
           dk=40, M=320, H=8, ragged kv_len >= 1) in f32 and bf16 against
           its plain PyTorch version; kernel, plain and library times
           (CUDA events) beside the least time the card could take.
  slice_a  the recipe Conformer at full width with encoder_rot_fold_pallas
           on: ASRProcess on one seeded 10 s wav, then a B=8 x 10 s batch
           through DeviceFrontend + CTCAttBeamDecoder(beam 10, ctc_beam 15,
           ctc_weight 0.5); the rot kernel must launch 12 times per encoder
           forward and the encoder output must match the plain path.
  slice_b  the same with encoder_use_pallas_attention on (the rel kernel).

Weights, waves and the token dictionary come from ``--seed``; nothing is
downloaded.  The second-to-last line is the kernel list as JSON, the last
line ``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.
It needs one CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# published H100 SXM peaks (dense): HBM bytes/s, f32 CUDA-core FLOP/s,
# bf16 tensor-core FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# served shape: 8 utterances x 10 s -> 248 encoder frames, 8 heads of 40
SERVED = dict(B=8, H=8, T=248, dk=40, M=320)


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def time_ms(fn, iters: int = 50, warmup: int = 5, repeats: int = 5) -> float:
    """Device time of one ``fn()`` call: the median, over ``repeats``
    blocks, of the mean of ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return float(np.median(means))


# ---------------------------------------------------------------- phases

def phase_device(state):
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("set torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    state["card"] = card
    state["device"] = {"platform": "gpu", "kind": name, "count": count}


def phase_build(state):
    from lasr_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build(force=True)
    log(f"build: {len(logs)} sources in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                log(f"  {name}: {line.strip()}")


def _rot_inputs(rng, dtype, dev):
    import torch
    B, H, T, dk, M = (SERVED[k] for k in ("B", "H", "T", "dk", "M"))
    BH = B * H
    f = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev, dtype)
    lens = rng.integers(T // 2, T + 1, size=B)
    kv_len = torch.from_numpy(np.repeat(lens, H).astype(np.int32)).to(dev)
    return (f(BH, T, dk), f(BH, T, M, sc=0.3), f(BH, T, dk), f(BH, T, dk),
            f(T, M, sc=0.3), kv_len)


def _rel_inputs(rng, dtype, dev):
    import torch
    B, H, T, dk = (SERVED[k] for k in ("B", "H", "T", "dk"))
    BH = B * H
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    lens = rng.integers(T // 2, T + 1, size=B)
    kv_len = torch.from_numpy(np.repeat(lens, H).astype(np.int32)).to(dev)
    return (f(BH, T, dk), f(BH, T, dk), f(BH, T, dk), f(BH, T, dk),
            f(H, 2 * T - 1, dk), kv_len)


def _rot_cost(args):
    """(bytes, flops) this call needs: inputs read once (keys and table
    rows only up to each row's kv_len), outputs written once."""
    q_u, u, k, v, vt, kv_len = args
    BH, T, dk = q_u.shape
    M = u.shape[-1]
    es = q_u.element_size()
    kvl = kv_len.cpu().numpy().astype(np.int64)
    nbytes = es * (q_u.numel() + u.numel() + int(kvl.sum()) * 2 * dk
                   + int(kvl.max()) * M + q_u.numel()) + 4 * BH * T + 4 * BH
    flops = int((2 * T * kvl * (dk + M) + 2 * T * kvl * dk).sum())
    return nbytes, flops


def _rel_cost(args):
    q_u, q_v, k, v, p, kv_len = args
    BH, T, dk = q_u.shape
    es = q_u.element_size()
    kvl = kv_len.cpu().numpy().astype(np.int64)
    nbytes = es * (2 * q_u.numel() + int(kvl.sum()) * 2 * dk + p.numel()
                   + q_u.numel()) + 4 * BH * T + 4 * BH
    flops = int((3 * 2 * T * kvl * dk).sum())
    return nbytes, flops


def _bound_ms(nbytes, flops, dtype_name):
    return max(nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype_name]) * 1e3, \
        ("bytes" if nbytes / HBM_BPS >= flops / PEAK_FLOPS[dtype_name]
         else "operations")


def _rot_library(args):
    """One PyTorch call computing the same function (the yardstick; the
    port never calls it): SDPA over the concatenated [q_u ; u] / [k ; V]."""
    import torch
    import torch.nn.functional as F
    q_u, u, k, v, vt, kv_len = args
    BH, T, dk = q_u.shape
    q = torch.cat([q_u, u], dim=-1)
    kk = torch.cat([k, vt[None].expand(BH, -1, -1)], dim=-1)
    mask = (torch.arange(T, device=q.device)[None, None, :]
            < kv_len[:, None, None])
    return lambda: F.scaled_dot_product_attention(
        q, kk, v, attn_mask=mask, scale=1.0 / math.sqrt(dk))


def phase_kernels(state):
    import torch
    from lasr_tpu_torch.ops.rel_attention import (
        rel_attention_forward, rel_attention_reference)
    from lasr_tpu_torch.ops.rot_attention import (
        rot_attention_forward, rot_attention_reference)
    dev = torch.device("cuda")
    rng = np.random.default_rng(state["seed"])
    specs = [
        ("rot_attention_fwd", rot_attention_forward, rot_attention_reference,
         _rot_inputs, _rot_cost, _rot_library,
         "lasr_tpu_torch/csrc/rot_attention.cu",
         "lasr_tpu/ops/rot_attention.py:41"),
        ("rel_attention_fwd", rel_attention_forward, rel_attention_reference,
         _rel_inputs, _rel_cost, None,
         "lasr_tpu_torch/csrc/rel_attention.cu",
         "lasr_tpu/ops/rel_attention.py:72"),
    ]
    for name, kern, plain, make, cost, library, src, tpu in specs:
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": tpu, "status": "ported"}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            args = make(rng, dtype, dev)
            out, lse = kern(*args)
            torch.cuda.synchronize()
            # the plain version in f32 on the same (possibly bf16) inputs
            f32 = [a.float() if a.is_floating_point() else a for a in args]
            want, want_lse = plain(*f32)
            err = float((out.float() - want).abs().max())
            lse_err = float((lse - want_lse).abs().max())
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name} {dn}: non-finite output")
            ms = time_ms(lambda: kern(*args))
            plain_ms = time_ms(lambda: plain(*args), iters=20)
            lib_ms = time_ms(library(args)) if library else None
            nbytes, flops = cost(args)
            bound, bound_by = _bound_ms(nbytes, flops, dn)
            log(f"kernel {name} {dn}: max_abs_err {err:.3e} (lse "
                f"{lse_err:.3e}, tol {TOL[dn]:g}), {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us, library "
                f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}, "
                f"bound {bound * 1e3:.2f} us ({bound_by}: {nbytes / 1e6:.2f}"
                f" MB, {flops / 1e9:.3f} GFLOP) [{state['card']}]")
            check(err <= TOL[dn], f"{name} {dn}: max_abs_err {err} > "
                  f"{TOL[dn]}")
            check(lse_err <= TOL[dn], f"{name} {dn}: lse error {lse_err}")
            numbers = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by,
                           library_ms=lib_ms)
            # the served model computes in f32: its numbers are the
            # entry's own, the bf16 ones ride beside them
            if dtype == torch.float32:
                entry.update(numbers)
            else:
                entry[dn] = numbers
        state["kernels"][name] = entry


# the recipe model: example/asr_en/conf/config_baseline.yaml at full width,
# odim 5000 (a 5000-entry vocabulary)
RECIPE = dict(
    idim=80, odim=5000, encoder_attention_dim=320, encoder_attention_heads=8,
    encoder_linear_units=2048, encoder_num_blocks=12,
    encoder_input_layer="conv2d", encoder_dropout_rate=0.1,
    encoder_attention_dropout_rate=0.0, decoder_attention_dim=320,
    decoder_attention_heads=8, decoder_linear_units=2048,
    decoder_input_layer="embed", decoder_num_block=6,
    decoder_dropout_rate=0.1, decoder_src_attention_dropout_rate=0.0,
    decoder_self_attention_dropout_rate=0.0, ctc_dropout=0.1,
    encoder_pos_enc_layer_type="rel_pos",
    encoder_selfattention_layer_type="rel_selfattn", encoder_remat_attend=1)
DECODE = dict(decode_method="ctc_att", beam=10, ctc_beam=15, ctc_weight=0.5,
              lm_path=None, lm_rate=0)
SECS, BATCH, SR = 10.0, 8, 16000


def _write_recipe(tmp, flags, seed):
    """Seeded random weights as a reference-format .pt, hparams.yaml and
    decode.yaml naming the JAX package's classes (the port translates
    them), and a 5000-entry CharTokenizer dictionary."""
    import torch
    import yaml
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
    torch.manual_seed(seed)
    model = E2E_Conformer_CTC(**RECIPE, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
        elif name.endswith("running_var"):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    torch.save(model.state_dict(), os.path.join(tmp, "model.pt"))
    with open(os.path.join(tmp, "dict.txt"), "w") as f:
        f.write("\n".join(f"T{i}" for i in range(RECIPE["odim"] - 6)) + "\n")
    with open(os.path.join(tmp, "hparams.yaml"), "w") as f:
        yaml.safe_dump({
            "model_config": {
                "name": "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC",
                "kwargs": dict(RECIPE, **flags)},
            "tokenizer_config": {
                "name": "lasr_tpu.data.tokenizer:CharTokenizer",
                "kwargs": {"dict_path": os.path.join(tmp, "dict.txt")}}}, f)
    with open(os.path.join(tmp, "decode.yaml"), "w") as f:
        yaml.safe_dump({"decode_config": DECODE, "test_data_config": {
            "kwargs": {"audio_trans": ["norm", "fbank:80"]}}}, f)


def make_waves(seed, n):
    """n seeded 10 s waves: a few harmonics under noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SECS * SR)) / SR
    out = []
    for _ in range(n):
        f0 = rng.uniform(90, 250)
        w = sum(rng.uniform(0.05, 0.3) * np.sin(2 * np.pi * f0 * h * t)
                for h in range(1, 6))
        out.append((w * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t))
                    + 0.05 * rng.standard_normal(t.shape)) * 0.3)
    # the PCM16 grid write_wav stores and read_wav returns
    return (np.round(np.clip(np.stack(out), -1, 1) * 32767.0)
            / 32768.0).astype(np.float32)


def _slice(state, label, flags, kernel_name, counter):
    """One main-path run of the served recipe model with ``flags``."""
    import torch
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.data.reader import write_wav
    from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
    from lasr_tpu_torch.ops.rel_attention import rel_attention_forward
    from lasr_tpu_torch.ops.rot_attention import rot_attention_forward
    from lasr_tpu_torch.process.asrprocess import ASRProcess
    from lasr_tpu_torch.utils.weights import load_model_weights

    counters = (rot_attention_forward, rel_attention_forward)
    with tempfile.TemporaryDirectory() as tmp:
        _write_recipe(tmp, flags, state["seed"])
        waves = make_waves(state["seed"] + 1, BATCH)
        wav_path = os.path.join(tmp, "x.wav")
        write_wav(wav_path, waves[0], SR)

        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asr = ASRProcess(os.path.join(tmp, "hparams.yaml"),
                         os.path.join(tmp, "decode.yaml"),
                         os.path.join(tmp, "model.pt"))
        t1 = time.perf_counter()
        tokens, text = asr(wav_path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        frontend = DeviceFrontend(["norm", "fbank:80"])
        decoder = CTCAttBeamDecoder(asr.model, beam=10, ctc_beam=15,
                                    ctc_weight=0.5)
        wav = torch.from_numpy(waves).cuda()
        wav_len = torch.full((BATCH,), wav.shape[1], dtype=torch.int32,
                             device=wav.device)
        feats, feat_len = frontend(wav, wav_len)
        hs, hs_len, lpz = decoder.encode(feats, feat_len)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        hyps = decoder.search(hs, hs_len, lpz, decoder.max_len(hs.shape[1]))
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        launches = {c.__name__: c.launches for c in counters}

        forwards = 2   # ASRProcess's utterance, then the batch
        log(f"{label}: ASRProcess build+load {t1 - t0:.2f} s, decode "
            f"{t2 - t1:.2f} s -> {len(tokens)} tokens; batch B={BATCH} x "
            f"{SECS:g} s: frontend+encode {t3 - t2:.3f} s, search "
            f"{t4 - t3:.2f} s (T={hs.shape[1]}, tokens per utterance "
            f"{[len(hyps.best_ids(b)) for b in range(BATCH)]}) "
            f"[{state['card']}]")
        log(f"{label}: launches in the main path {launches} over {forwards} "
            f"encoder forwards")
        n = launches[counter.__name__]
        check(n == RECIPE["encoder_num_blocks"] * forwards,
              f"{label}: {counter.__name__} launched {n} times, expected "
              f"{RECIPE['encoder_num_blocks']} per encoder forward")
        state["launches"][kernel_name] = n
        same = asr.backend(hyps.best_ids(0))[0] == tokens
        log(f"{label}: batch row 0 (same wave as the ASRProcess utterance) "
            f"gives the same tokens: {same}")
        check(same, f"{label}: batch row 0 decodes to other tokens than "
              f"ASRProcess on the same wave")
        V = RECIPE["odim"]
        check(bool(torch.isfinite(hs).all()) and hs.shape == (
            BATCH, hs.shape[1], RECIPE["encoder_attention_dim"]),
            f"{label}: encoder output not finite / wrong shape")
        check(all(0 <= t < V for b in range(BATCH) for t in hyps.best_ids(b))
              and np.isfinite(hyps.scores).all(),
              f"{label}: hypotheses out of range or non-finite scores")

        # the same weights with the kernel flag off: the plain rotated fold
        plain = E2E_Conformer_CTC(**RECIPE)
        load_model_weights(plain, asr.model.state_dict())
        with torch.no_grad():
            hs_plain, len_plain = plain.encode(feats, feat_len, solo_pad=True)
        err = float((hs - hs_plain).abs().max())
        log(f"{label}: encoder output vs plain rotated fold: max_abs "
            f"{err:.3e} (tol 1e-3)")
        check(torch.equal(hs_len, len_plain) and err <= 1e-3,
              f"{label}: encoder output differs from the plain path by "
              f"{err}")
        state["timings"][label] = dict(encode_s=t3 - t2, search_s=t4 - t3,
                                       asr_decode_s=t2 - t1)


def phase_slice_a(state):
    from lasr_tpu_torch.ops.rot_attention import rot_attention_forward
    _slice(state, "slice_a", {"encoder_rot_fold_pallas": True},
           "rot_attention_fwd", rot_attention_forward)


def phase_slice_b(state):
    from lasr_tpu_torch.ops.rel_attention import rel_attention_forward
    _slice(state, "slice_b", {"encoder_use_pallas_attention": True},
           "rel_attention_fwd", rel_attention_forward)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lasr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the lasr_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    state = {"seed": args.seed, "kernels": {}, "launches": {}, "timings": {},
             "card": "not measured"}
    phases = [("device", phase_device), ("build", phase_build),
              ("kernels", phase_kernels), ("slice_a", phase_slice_a),
              ("slice_b", phase_slice_b)]
    t_start = time.perf_counter()
    for name, run in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            run(state)
        except Failed as e:
            print(f"chip_smoke: phase {name} FAILED: {e}", file=sys.stderr)
            return 1
        log(f"== phase {name} done in {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, entry in state["kernels"].items():
        entry = dict(entry, launches=state["launches"].get(name, 0))
        if entry["launches"] <= 0:
            print(f"chip_smoke: {name} was not launched on the main path",
                  file=sys.stderr)
            return 1
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": state["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
