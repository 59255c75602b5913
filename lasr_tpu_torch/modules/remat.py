"""Activation checkpointing (counterpart of ``nn.remat`` in
``lasr_tpu``'s encoders): ``checkpointed(fn, *args)`` runs ``fn`` keeping
none of its intermediates and runs it again in the backward pass
(``torch.utils.checkpoint``, non-reentrant).

The recomputation replays the forward's random draws.  Train-mode dropout
and noise draw from the explicit generator of ``modules.dropout``'s
context, which ``torch.utils.checkpoint`` does not restore, and the
backward runs outside that context (on another thread, on a GPU).  So
the generator's state is saved when ``fn`` starts, and the recompute
draws from a copy of the generator in that state (and of the block's
shared generator), inside its own ``dropout_generator`` block: its
masks are the forward's, and the caller's generator advances once, as
without remat.  The recompute runs in a copy of the forward's context
variables, so a seq split (``parallel.dist.seq_split``) holds there too.
During a recompute
``recomputing()`` is true, and BatchNorm leaves its running statistics
alone (the forward moved them already).  Custom autograd functions (the
attention kernels' wrappers) inside ``fn`` run again in the recompute,
and their kernels launch again.
"""

from __future__ import annotations

import contextvars

import torch
from torch.utils.checkpoint import checkpoint

from lasr_tpu_torch.modules.dropout import (dropout_generator,
                                            generator_states)

_RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar(
    "lasr_tpu_torch_recomputing", default=False)


def recomputing() -> bool:
    """Whether the code runs inside a checkpoint's backward recompute."""
    return _RECOMPUTING.get()


def checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward with the
    forward's draws.  Without autograd (eval, ``no_grad``) a plain
    call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    gens = generator_states()
    saved = [None if g is None else (g.device, g.get_state()) for g in gens]
    calls = [0]

    def replay(kept):
        if kept is None:
            return None
        gen = torch.Generator(device=kept[0])
        gen.set_state(kept[1])
        return gen

    context = contextvars.copy_context()

    def recompute(*a):
        _RECOMPUTING.set(True)
        if saved[0] is None:
            return fn(*a)
        with dropout_generator(*map(replay, saved)):
            return fn(*a)

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*a)
        return context.copy().run(recompute, *a)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)
