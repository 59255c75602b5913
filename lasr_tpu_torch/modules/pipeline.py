"""GPipe pipeline parallelism over the Conformer encoder's blocks
(counterpart of ``lasr_tpu/modules/pipeline.py``).

``encoder_pipeline_stages = P`` cuts the N blocks into P stages of N/P
consecutive blocks (block p·N/P + l is stage p's layer l, the order of
``lasr_tpu``'s ``[P, N/P, ...]`` ``pipe_stages`` leaves, which the weight
bridge unstacks into the port's per-block modules).  In training the
blocks run ``lasr_tpu``'s tick schedule, which changes a step's numbers:

  - the batch splits into M = ``pick_microbatches(B, microbatches or
    2P)`` microbatches;
  - M + P - 1 ticks; at tick t stage s runs on its slot, then every slot
    moves one stage down and slot 0 takes microbatch t mod M;
  - the slots start as zeros with all-False masks, so stage s runs on
    the zeros that went through the stages before it at ticks t < s, and
    at the drain ticks on the microbatches the refill cycles in again;
  - BatchNorm normalizes with each call's (one microbatch's) statistics
    and moves its running statistics at every call, warm-up and drain
    ticks included (``variable_carry="batch_stats"``);
  - the output is microbatch k's from stage P-1 at tick k + P - 1.

The calls whose output reaches no emitted microbatch (stage s at ticks
t < s or t - s >= M) run without autograd: they only move BatchNorm's
statistics and draw their dropout.  Each stage draws its dropout from a
generator of its own, seeded from one draw of the step's generator, so a
stage's masks are the same whichever rank runs it.  In eval the
pipelined forward equals the plain one, and one process runs the blocks
in turn.

Across ranks (``-pipeline_parallel``, the grid's pipe axis of
``parallel.dist``) pipe rank q holds stages q·P/Q to (q+1)·P/Q - 1 of the
Q pipe ranks (``stages % Q == 0``) and runs the same ticks: its first
slot comes from rank q - 1 (``pipe_send`` / ``pipe_recv``), its last
stage's output goes to rank q + 1, and the last rank's emits are
broadcast to every pipe rank, which all run the rest of the model alike.
The backward (``_PipeFunction``) goes microbatch by microbatch from the
last rank down, each rank differentiating its stages and sending the
input's gradient to the rank before it; rank 0's gradient of the
encoder's input is broadcast, so the layers before the stack (and those
after it) get the same gradient on every pipe rank.  Under data ranks each
rank cuts its own rows into the M microbatches and BatchNorm sums over the
data ranks, so microbatch k is every data rank's k-th slice (``lasr_tpu``'s
one program cuts the global batch into contiguous ones): an N-rank step
equals the one-process pipelined step on the batch with its rows in that
order.

``lasr_tpu``'s pipelined stack runs its convs as ``TapConv1d``
(``lasr_tpu/modules/convops.py``), a tap-wise matmul form with
``nn.Conv``'s parameters, to dodge an XLA SPMD miscompile of a conv whose
stage dim is sharded.  The port has no such partitioner: its stages run
the ordinary depthwise / pointwise ``Conv1d``, which computes the same
function of the same parameters.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

from lasr_tpu_torch.modules.dropout import (dropout_generator,
                                            generator_states)
from lasr_tpu_torch.modules.remat import checkpointed
from lasr_tpu_torch.parallel import dist

def pick_microbatches(batch: int, requested: int) -> int:
    """Largest divisor of ``batch`` <= ``requested`` (a prime batch
    degenerates to one microbatch)."""
    m = max(1, min(requested, batch))
    while batch % m:
        m -= 1
    return m


def _stage_generators(stages: int):
    """One dropout generator per stage, seeded from one draw of the
    block's generator (None without one)."""
    gen, _ = generator_states()
    if gen is None:
        return None
    base = int(torch.randint(2 ** 62, (1,), generator=gen,
                             device=gen.device))
    return [torch.Generator(device=gen.device).manual_seed(
        (base + 0x9E3779B97F4A7C15 * (s + 1)) % 2 ** 63)
        for s in range(stages)]


class _Pipe:
    """The schedule of one encoder forward."""

    def __init__(self, encoder, pos_emb, pos_table, training: bool):
        self.enc = encoder
        self.P = encoder.pipeline_stages
        self.per = len(encoder.encoders) // self.P
        self.pos_emb, self.pos_table = pos_emb, pos_table
        self.training = training
        self.q, self.Q = dist.pipe_rank(), dist.pipe_size()
        k = self.P // self.Q
        self.local = list(range(self.q * k, (self.q + 1) * k))
        self.gens = _stage_generators(self.P) if training else None
        self.shared = generator_states()[1]

    def params(self) -> List[torch.Tensor]:
        """The parameters of this rank's stages."""
        blocks = self.enc.encoders[self.local[0] * self.per:
                                   (self.local[-1] + 1) * self.per]
        return [p for p in blocks.parameters() if p.requires_grad]

    def stage(self, s: int, x, mask, czm):
        gen = contextlib.nullcontext() if self.gens is None else \
            dropout_generator(self.gens[s], shared=self.shared)
        with gen:
            for layer in self.enc.encoders[s * self.per:(s + 1) * self.per]:
                args = (x, mask, self.pos_emb, czm, self.pos_table)
                x = checkpointed(layer, *args) if self.enc.remat \
                    else layer(*args)
        return x

    def ticks(self, xs, masks, czms, grad: bool):
        """Run the ticks on microbatches ``xs`` (with their masks and
        conv zero masks); returns (emits on the last pipe rank, else
        Nones; {microbatch: [its input, its output]} of this rank's
        stages when ``grad`` across ranks)."""
        P, M = self.P, len(xs)
        zero = torch.zeros_like(xs[0])
        off_mask = torch.zeros_like(masks[0])
        off_czm = None if czms is None else torch.zeros_like(czms[0])
        last = self.q == self.Q - 1
        slots = [zero] * len(self.local)
        emits, chains = [None] * M, {}
        n_ticks = M + P - 1
        for t in range(n_ticks):
            if self.q == 0:
                slots[0] = xs[t % M]
            outs = []
            for j, s in enumerate(self.local):
                k = t - s
                valid = 0 <= k < M
                x = slots[j]
                if not valid and not self.training:
                    outs.append(x)
                    continue
                if j == 0 and valid and grad and self.Q > 1:
                    if self.q:
                        x = x.detach().requires_grad_()
                    chains[k] = [x]
                mask, czm = ((masks[k % M], None if czms is None
                              else czms[k % M]) if t >= s
                             else (off_mask, off_czm))
                with torch.set_grad_enabled(grad and valid):
                    out = self.stage(s, x, mask, czm)
                if j == len(self.local) - 1 and k in chains and valid:
                    chains[k].append(out)
                outs.append(out)
            if last and t >= P - 1:
                emits[t - P + 1] = outs[-1]
            if t == n_ticks - 1:
                break
            work = None
            if not last:
                work = dist.pipe_send(outs[-1], 1)
            head = dist.pipe_recv(zero, -1) if self.q else zero
            if work is not None:
                work.wait()
            slots = [head] + outs[:-1]
        return emits, chains


class _PipeFunction(torch.autograd.Function):
    """The ticks across pipe ranks as one differentiable step: forward
    returns the encoder stack's output (B, T, D) on every pipe rank, the
    backward runs the microbatches' backward from the last rank down (see
    the module docstring)."""

    @staticmethod
    def forward(ctx, pipe, masks, czms, M, h, *params):
        leaf = h.detach().requires_grad_()
        with torch.enable_grad():
            emits, chains = pipe.ticks(list(leaf.chunk(M)), masks, czms,
                                       grad=True)
        out = torch.cat(emits).detach() if pipe.q == pipe.Q - 1 \
            else torch.empty_like(h)
        ctx.pipe, ctx.chains, ctx.M = pipe, chains, M
        ctx.leaf_shape = h.shape
        return dist.pipe_broadcast(out, pipe.Q - 1)

    @staticmethod
    def backward(ctx, grad):
        pipe, chains, M = ctx.pipe, ctx.chains, ctx.M
        params = pipe.params()
        sums = [None] * len(params)
        h_grad = grad.new_zeros(ctx.leaf_shape)
        rows = list(h_grad.chunk(M))
        g_parts = list(grad.chunk(M))
        for k in range(M):
            inp, out = chains[k]
            g = g_parts[k] if pipe.q == pipe.Q - 1 \
                else dist.pipe_recv(out, 1)
            got = torch.autograd.grad(out, [inp] + params, g,
                                      allow_unused=True)
            for i, p_g in enumerate(got[1:]):
                if p_g is not None:
                    sums[i] = p_g if sums[i] is None else sums[i] + p_g
            if pipe.q:
                dist.pipe_send(got[0], -1).wait()
            else:
                rows[k].copy_(got[0])
        dist.pipe_broadcast(h_grad, 0)
        return (None, None, None, None, h_grad, *sums)


def run_pipeline(encoder, h, mask, czm, pos_emb, pos_table):
    """The encoder's blocks over h (B, T, D) under ``mask`` (B, 1, T) and
    the conv zero mask ``czm`` (B, T) or None, pipelined over
    ``encoder.pipeline_stages`` stages (see the module docstring)."""
    training = encoder.training
    Q = dist.pipe_size()
    if not training and Q == 1:
        for layer in encoder.encoders:
            h = layer(h, mask, pos_emb, czm, pos_table)
        return h
    P = encoder.pipeline_stages
    M = pick_microbatches(h.shape[0], encoder.pipeline_microbatches or 2 * P) \
        if training else 1
    pipe = _Pipe(encoder, pos_emb, pos_table, training)
    masks = list(mask.chunk(M))
    czms = None if czm is None else list(czm.chunk(M))
    if Q == 1:
        emits, _ = pipe.ticks(list(h.chunk(M)), masks, czms,
                              grad=torch.is_grad_enabled())
        return torch.cat(emits)
    if not (training and torch.is_grad_enabled()):
        with torch.no_grad():
            emits, _ = pipe.ticks(list(h.chunk(M)), masks, czms,
                                  grad=False)
        out = torch.cat(emits) if pipe.q == Q - 1 else torch.empty_like(h)
        return dist.pipe_broadcast(out, Q - 1)
    params = pipe.params()
    return _PipeFunction.apply(pipe, masks, czms, M, h, *params)
