"""Dropout that draws from a caller-owned ``torch.Generator``.

Counterpart of Flax's ``nn.Dropout`` under the ``"dropout"`` rng stream:
keep with probability ``1 - rate``, scale the kept entries by
``1 / (1 - rate)``.  The bits come from the generator that the innermost
``dropout_generator(...)`` block installs (the ``Trainer`` owns one per
step), never from torch's global RNG; a train-mode forward with a nonzero
rate outside such a block raises.  A rate of 0, or eval mode, is the
identity and draws nothing.  ``standard_normal`` draws the train-time
Gaussian noise of the same stream (the monotonic attention's sigmoid
noise) from the same generator, under the same rule.  ``shared_randint``
draws what must agree across data-parallel ranks (the dual encoder's
chunk size) from the block's ``shared`` generator, which every rank
holds in the same state (the ``Trainer``'s SpecAugment generator).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
from torch import nn

from lasr_tpu_torch.parallel import dist

_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "lasr_tpu_torch_dropout_generator", default=None)
_SHARED: contextvars.ContextVar = contextvars.ContextVar(
    "lasr_tpu_torch_shared_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator,
                      shared: Optional[torch.Generator] = None):
    """Train-mode dropout inside the block draws from ``generator``, and
    ``shared_randint`` from ``shared`` (or, without it, from
    ``generator``)."""
    token = _GENERATOR.set(generator)
    shared_token = _SHARED.set(shared)
    try:
        yield generator
    finally:
        _SHARED.reset(shared_token)
        _GENERATOR.reset(token)


def generator_states():
    """(dropout generator, shared generator) of the innermost block, each
    None where absent."""
    return _GENERATOR.get(), _SHARED.get()


def _generator() -> torch.Generator:
    gen = _GENERATOR.get()
    if gen is None:
        raise RuntimeError("train-mode dropout and noise draw from a "
                           "generator: run the forward inside "
                           "dropout_generator(...)")
    return gen


def standard_normal(like: torch.Tensor) -> torch.Tensor:
    """N(0, 1) draws of ``like``'s shape, dtype and device from the
    block's generator."""
    return torch.randn(like.shape, generator=_generator(),
                       device=like.device, dtype=like.dtype)


def shared_randint(high: int) -> int:
    """An integer in [0, high) from the block's shared generator (its
    dropout generator when it has none)."""
    gen = _SHARED.get()
    if gen is None:
        gen = _generator()
    return int(torch.randint(high, (1,), generator=gen, device=gen.device))


def _shards(shard):
    """``shard`` as a list of (dim, rank, size): one triple, or a sequence
    of triples and Nones."""
    if shard is None:
        return []
    if isinstance(shard[0], int):
        return [shard]
    return [s for s in shard if s is not None]


def time_shard(dim: int):
    """``dropout``'s ``shard`` for a time axis ``dim`` that the seq ranks
    split (``parallel.dist.seq_split``); None outside such a split."""
    split = dist.current_seq_split()
    return None if split is None else (dim, split.rank, split.size)


def keep_mask(x: torch.Tensor, rate: float, shard=None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The boolean keep mask ``dropout`` draws for ``x`` (from the block's
    generator unless one is given)."""
    shards = _shards(shard)
    shape = list(x.shape)
    for dim, _, size in shards:
        shape[dim] *= size
    gen = _generator() if generator is None else generator
    keep = torch.rand(shape, generator=gen, device=x.device) >= rate
    for dim, rank, _ in shards:
        keep = keep.narrow(dim, rank * x.shape[dim], x.shape[dim])
    return keep


def dropout(x: torch.Tensor, rate: float, training: bool,
            shard=None) -> torch.Tensor:
    """``shard`` = (dim, rank, size), or a sequence of such (Nones
    skipped): ``x`` is part ``rank`` of ``size`` equal parts along ``dim``
    of a whole tensor (a tensor-parallel split, ``parallel.tensor``, or
    the seq ranks' time split, ``time_shard``); the whole tensor's mask is
    drawn and the part's kept, so the draw is the one the whole tensor
    would take."""
    if not training or rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    return torch.where(keep_mask(x, rate, shard), x / (1.0 - rate), 0.0)


class Dropout(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
