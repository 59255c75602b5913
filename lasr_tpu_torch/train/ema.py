"""Exponential moving average of the parameters (counterpart of
``lasr_tpu/train/ema.py``): shadow copies moved once per train step with
the warmup-capped decay ``min(decay, (1+n)/(10+n))``, n counted first.
BatchNorm running statistics are buffers, not parameters, and get no
shadow (as in the reference's ``LitEma``).  The update is elementwise, so
under FSDP each rank moves its shards (the ``Trainer``'s masters)."""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def ema_init(params: Sequence[torch.Tensor]) -> Dict:
    return {"shadow": [p.detach().clone() for p in params],
            "num_updates": 0}


@torch.no_grad()
def ema_update(ema: Dict, params: Sequence[torch.Tensor],
               decay: float = 0.9999) -> Dict:
    """Moves ``ema``'s shadow towards ``params`` in place; returns it."""
    ema["num_updates"] += 1
    n = ema["num_updates"]
    d = min(decay, (1.0 + n) / (10.0 + n))
    diff = torch._foreach_sub(ema["shadow"], [p.detach() for p in params])
    torch._foreach_mul_(diff, 1.0 - d)
    torch._foreach_sub_(ema["shadow"], diff)
    return ema
