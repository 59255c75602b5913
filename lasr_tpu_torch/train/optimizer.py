"""Optimizers and learning-rate schedules (counterpart of
``lasr_tpu/train/optimizer.py``, which builds optax transforms).

The update is written out to match optax step for step:
``clip_by_global_norm`` scales by ``max/norm`` only when ``norm >= max``
(no epsilon in the norm); Adam's moments are bias-corrected with the
incremented count and the update is ``mu_hat / (sqrt(nu_hat) + eps)``;
the schedule is called with a count that starts at 0, and
``WarmupScheduler`` adds 1 to it (the reference's step count starts at
1).  ``Noam`` is Adam(0.9, 0.98, eps 1e-9) with its own Noam schedule.
The update is elementwise, so it runs on FSDP shards as it runs on
whole parameters (``Trainer`` hands it the ``ShardLayout`` masters).

Config usage (the reference recipes' YAML shape)::

    opti_config:
      name: 'lasr_tpu.train.optimizer:Adam'
      kwargs: {betas: [0.9, 0.98]}
      scheduler:
        name: 'lasr_tpu.train.optimizer:WarmupScheduler'
        kwargs: {factor: 3, warm_step: 25000, model_size: 320, offset: 0}
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch


class WarmupScheduler:
    """Noam curve ``offset + factor · d^-0.5 · min(s^-0.5, s · warm^-1.5)``
    with s = count + 1 + offstep."""

    def __init__(self, model_size: int, factor: float, warm_step: int,
                 offset: float = 0.0, offstep: int = 0):
        self.model_size = model_size
        self.factor = factor
        self.warm_step = warm_step
        self.offset = offset
        self.offstep = offstep

    def __call__(self, count: int) -> float:
        step = max(float(count + 1 + self.offstep), 1.0)
        return (self.offset + self.factor * self.model_size ** -0.5
                * min(step ** -0.5, step * self.warm_step ** -1.5))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when ``norm < max_norm``, else
    each gradient times ``max_norm / norm``.  ``norm``: the gradients'
    global norm where it is known (shards: ``ShardLayout.norm``), else
    ``global_norm(grads)``."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


class AdamTransform:
    """optax.adam / adamw as an explicit update of a list of parameters.
    ``lr`` is a float or a schedule ``count -> float``."""

    def __init__(self, lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def learning_rate(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], state: dict) -> None:
        """Updates ``params`` and ``state`` in place."""
        b1, b2 = self.b1, self.b2
        lr = self.learning_rate(state["count"])
        state["count"] += 1
        n = state["count"]
        torch._foreach_mul_(state["mu"], b1)
        torch._foreach_add_(state["mu"], list(grads), alpha=1.0 - b1)
        sq = torch._foreach_mul(list(grads), list(grads))
        torch._foreach_mul_(state["nu"], b2)
        torch._foreach_add_(state["nu"], sq, alpha=1.0 - b2)
        mu_hat = torch._foreach_div(state["mu"], 1.0 - b1 ** n)
        nu_hat = torch._foreach_div(state["nu"], 1.0 - b2 ** n)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, list(params), alpha=self.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(list(params), upd)


class Adam:
    """Adam descriptor; ``make(schedule)`` builds the update."""

    def __init__(self, lr: float = 1e-3,
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay

    def make(self, schedule=None) -> AdamTransform:
        return AdamTransform(schedule if schedule is not None else self.lr,
                             self.betas[0], self.betas[1], self.eps,
                             self.weight_decay)


class Noam(Adam):
    """Adam(0.9, 0.98, eps=1e-9) with a built-in Noam schedule."""

    def __init__(self, model_size: int, factor: float, warm_step: int,
                 offset: float = 0.0, offstep: int = 0):
        super().__init__(lr=0.0, betas=(0.9, 0.98), eps=1e-9)
        self.schedule = WarmupScheduler(model_size, factor, warm_step,
                                        offset, offstep)

    def make(self, schedule=None) -> AdamTransform:
        return super().make(schedule if schedule is not None
                            else self.schedule)


def build_optimizer(opti_config: dict
                    ) -> Tuple[AdamTransform, Optional[Callable]]:
    """An ``opti_config`` YAML block (with an optional nested
    ``scheduler``) → (update, schedule or None)."""
    from lasr_tpu_torch.utils.registry import BaseConfig
    desc = BaseConfig(name=opti_config["name"],
                      kwargs=opti_config.get("kwargs", {})).generateExample()
    schedule = None
    if opti_config.get("scheduler"):
        schedule = BaseConfig(**opti_config["scheduler"]).generateExample()
    if not hasattr(desc, "make"):
        raise TypeError(f"optimizer {opti_config['name']!r} must provide "
                        f".make(schedule) (got {type(desc)})")
    return desc.make(schedule), schedule or getattr(desc, "schedule", None)
