#!/usr/bin/env python3
"""Where the time of the port's decode goes on one NVIDIA GPU.

    python3 profile_torch_decode.py [--steps 16] [--seed 0]

Builds the served recipe Conformer (example/asr_en/conf/config_baseline.yaml
at full width, odim 5000, ``encoder_rot_fold_pallas`` on) with seeded
random weights, makes a B=8 x 10 s batch of seeded waves, and times, with
host clocks around work that ends in ``torch.cuda.synchronize()``: the
frontend, frontend + encoder, and the first ``--steps`` beam-search steps
(beam 10, ctc_beam 15, ctc_weight 0.5), with the host time spent inside
the CTC prefix recursion and inside the cached decoder step.  Then it
profiles the encode and the search each in its own ``torch.profiler``
window and prints, per window, the share of its wall time the device was
busy and the busiest device kernels, and one JSON summary line last.
It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.decode import beam
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    torch.manual_seed(args.seed)
    model = E2E_Conformer_CTC(**chip_smoke.RECIPE,
                              encoder_rot_fold_pallas=True)
    decoder = beam.CTCAttBeamDecoder(model, beam=10, ctc_beam=15,
                                     ctc_weight=0.5)
    frontend = DeviceFrontend(["norm", "fbank:80"])
    wav = torch.from_numpy(
        chip_smoke.make_waves(args.seed + 1, chip_smoke.BATCH)).cuda()
    wav_len = torch.full((wav.shape[0],), wav.shape[1], dtype=torch.int32,
                         device=wav.device)

    def encode():
        feats, feat_len = frontend(wav, wav_len)
        return decoder.encode(feats, feat_len)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    hs, hs_len, lpz = encode()                      # warm-up
    decoder.search(hs, hs_len, lpz, 2)
    _, front_s = timed(lambda: frontend(wav, wav_len))
    (hs, hs_len, lpz), enc_s = timed(encode)

    # host seconds spent inside the two halves of a search step
    host_s = {"ctc_prefix_step": 0.0, "decoder_step": 0.0}
    prefix_step, decoder_step = beam._ctc_prefix_step, model.decoder_step

    def host_timed(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host_s[name] += time.perf_counter() - t0
            return out
        return wrapped

    beam._ctc_prefix_step = host_timed("ctc_prefix_step", prefix_step)
    model.decoder_step = host_timed("decoder_step", decoder_step)
    _, search_s = timed(lambda: decoder.search(hs, hs_len, lpz, args.steps))
    beam._ctc_prefix_step, model.decoder_step = prefix_step, decoder_step
    print(f"frontend {front_s * 1e3:.2f} ms, frontend+encode "
          f"{enc_s * 1e3:.2f} ms, search {args.steps} steps "
          f"{search_s * 1e3:.1f} ms ({search_s / args.steps * 1e3:.2f} ms "
          f"per step; host inside the CTC prefix recursion "
          f"{host_s['ctc_prefix_step'] * 1e3:.1f} ms, inside the decoder "
          f"step {host_s['decoder_step'] * 1e3:.1f} ms), T={hs.shape[1]} "
          f"[{card}]", flush=True)

    def device_window(name, fn):
        """Profile ``fn`` alone: wall ms, device-busy ms (the union of the
        kernels' and copies' intervals), device ops, busiest kernels."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall_s = timed(fn)
        dev = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
        if not dev:
            raise RuntimeError(f"{name}: the profiler saw no device activity")
        busy_us, end = 0.0, -float("inf")
        for e in sorted(dev, key=lambda e: e.time_range.start):
            start = max(e.time_range.start, end)
            busy_us += max(e.time_range.end - start, 0.0)
            end = max(end, e.time_range.end)
        by_name = {}
        for e in dev:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        print(f"{name}: window {wall_s * 1e3:.1f} ms, device busy "
              f"{busy_us / 1e3:.1f} ms ({busy_us / 1e4 / wall_s:.1f}%), "
              f"{len(dev)} device ops; busiest kernels:")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        for kname, (n, us) in top:
            print(f"  {us / 1e3:9.2f} ms  {n:7d} calls  {kname[:90]}")
        return {"window_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
                "device_busy_share": busy_us / 1e6 / wall_s,
                "device_ops": len(dev),
                "top_kernels_ms": [[k[:90], us / 1e3] for k, (n, us) in top[:5]]}

    summary = {
        "card": card, "batch": int(hs.shape[0]), "T": int(hs.shape[1]),
        "steps": args.steps, "frontend_ms": front_s * 1e3,
        "encode_ms": enc_s * 1e3,
        "search_ms_per_step": search_s / args.steps * 1e3,
        "ctc_prefix_host_share": host_s["ctc_prefix_step"] / search_s,
        "decoder_step_host_share": host_s["decoder_step"] / search_s,
        "encode": device_window("encode", encode),
        "search": device_window(
            "search", lambda: decoder.search(hs, hs_len, lpz, args.steps)),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
