#!/usr/bin/env python3
"""Where the time of the port's train step goes on one NVIDIA GPU.

    python3 profile_torch_train.py [--seed 0] [--configs table,A-plain,A,B]

For each configuration of the recipe Conformer (example/asr_en/conf/
config_baseline.yaml at full width, odim 5000, seeded random weights):

  table    the recipe's own default: table-mode positional dropout,
           scored through the skewed-table fold (no kernel);
  A-plain  encoder_pos_dropout_mode "rotated", the rotated fold in plain
           PyTorch;
  A        the same through the rot kernels (encoder_rot_fold_pallas);
  B        encoder_use_pallas_attention: the rel kernels;

it runs the Trainer's step on chip_smoke's training batch (B=32 x 15.6 s,
L=64, norm + fbank:80 + specaug, E2E_Loss, Noam, clip 5, EMA): one
warm-up step, ``--steps`` steps timed with host clocks around work that
ends in ``torch.cuda.synchronize()`` (the greedy-CTC CER runs every
``--log-interval`` steps, 50 by default, so on none of them), then one
step in a
``torch.profiler`` window.  It prints the step time, the share of the
profiled window the device was busy, the device time of each of the
port's own kernels (and their share of the step), and the busiest device
kernels; one JSON summary line last.  It needs a CUDA device and fails
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

CONFIGS = {
    "table": {},
    "A-plain": {"encoder_pos_dropout_mode": "rotated"},
    "A": {"encoder_rot_fold_pallas": True,
          "encoder_pos_dropout_mode": "rotated"},
    "B": {"encoder_use_pallas_attention": True},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--log-interval", type=int, default=50,
                    help="steps between greedy-CTC CER computations, as the "
                    "Trainer's log_interval (the JAX trainer's default)")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    batch = chip_smoke._train_batch(args.seed + 2)

    def owner(kernel_name):
        for label, parts in chip_smoke.PORT_KERNELS.items():
            if any(p in kernel_name for p in parts):
                return label
        return None

    def short(kernel_name):
        m = re.search(r"\w*kernel\w*(<[^>]*>)?", kernel_name)
        return m.group(0) if m else kernel_name[:60]

    summary = {"card": card, "configs": {}}
    for name in args.configs.split(","):
        torch.manual_seed(args.seed)
        model = E2E_Conformer_CTC(**chip_smoke.RECIPE, **CONFIGS[name])
        trainer = chip_smoke._trainer(model, ["norm", "fbank:80", "specaug"],
                                      args.seed, args.log_interval)
        state = trainer.init_state()
        state, _ = trainer.train_step(state, batch)          # warm-up
        times = []
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
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
        by_name, ours, parts = {}, {}, {}
        for e in dev:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
            label = owner(e.name)
            if label:
                n, t = ours.get(label, (0, 0.0))
                ours[label] = (n + 1, t + us)
                key = (label, short(e.name))
                n, t = parts.get(key, (0, 0.0))
                parts[key] = (n + 1, t + us)
        step_s = sum(times) / len(times)
        print(f"{name}: step {step_s * 1e3:.1f} ms (mean of {len(times)}: "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times)}); profiled step "
              f"{wall_s * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
              f"({busy_us / 1e4 / wall_s:.1f}%), {len(dev)} device ops "
              f"[{card}]", flush=True)
        for label, (n, us) in sorted(ours.items()):
            print(f"  {label}: {us / 1e3:.2f} ms device over {n} device "
                  f"functions, {us / 1e4 / wall_s:.1f}% of the profiled step")
            for (owner_label, fn), (m, fus) in sorted(parts.items()):
                if owner_label == label:
                    print(f"    {fn}: {fus / 1e3:.2f} ms over {m} calls")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        for kname, (n, us) in top:
            print(f"  {us / 1e3:9.2f} ms  {n:7d} calls  {kname[:90]}")
        summary["configs"][name] = {
            "step_ms": step_s * 1e3, "profiled_step_ms": wall_s * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall_s,
            "device_ops": len(dev),
            "port_kernels_ms": {k: us / 1e3 for k, (n, us) in ours.items()},
            "port_functions_ms": {f"{k} {fn}": us / 1e3
                                  for (k, fn), (n, us) in parts.items()},
            "top_kernels_ms": [[k[:90], us / 1e3] for k, (n, us) in top[:5]]}
        del model, trainer, state
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
