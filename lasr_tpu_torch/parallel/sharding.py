"""Which part of each parameter a rank holds (counterpart of
``lasr_tpu/parallel/sharding.py``), and the FSDP mechanics over the data
ranks.

The rules, on the reference torch names (a Linear's weight is (out, in),
Flax's kernel (in, out)):

  - tensor parallelism over the model ranks (``model_size`` > 1):
    column-parallel (the output dim, torch dim 0) for the attention
    q / k / v / pos projections, the feed-forward ``w_1``, the decoder's
    ``output_layer`` and the CTC head; row-parallel (the input dim, torch
    dim 1) for ``linear_out`` and ``w_2``; the decoder's token embedding
    by vocabulary rows (dim 0).  A leaf whose dim does not divide by the
    model ranks stays whole (replicated), as ``sharding.py`` falls back;
  - FSDP (``fsdp``) over the data ranks: every leaf of >= 2 dims and >=
    ``FSDP_MIN_SIZE`` elements is split on its first dim, in Flax's order
    of dims, that the model axis left free and the data ranks divide.

So a rank's shard of every leaf has the shape ``lasr_tpu``'s
``_leaf_spec`` gives that leaf on a ``make_mesh(data, model)`` mesh.  An
int8 feed-forward stays whole (``ops.quant.QuantLinear.splittable``):
its absmax scales span the contraction that a row split would cut.

Two more axes (``parallel.dist``'s grid):

  - pipeline (``pipe_size`` > 1, a model with ``encoder_pipeline_stages``
    stages): the encoder's blocks belong to the pipe rank of their stage
    (``pipe_owner``, ``lasr_tpu``'s ``pipe_stages`` rule); the other
    pipe ranks hold nothing of them (empty parameters and masters), and
    every other leaf is whole on every pipe rank, with the same gradient
    there;
  - sequence (``seq_split``: the encoder's time split over the seq ranks):
    every rank's gradient of an encoder leaf is its rows' share, summed
    over the seq ranks (``Spec.seq``); the decoder's and the CTC head's
    are whole on every seq rank already (they read the gathered encoder
    output), and summing them would count them S times.

``ShardLayout`` keeps, for a model whose tensor-parallel layers already
hold their model rank's part (``parallel.tensor``), the FSDP leaves as
shards (``masters``: what the optimizer, the EMA and the gradient
accumulator see) and the module's parameters empty between steps:
``gather`` puts the full weights in for a step, ``release`` frees them,
``reduce`` turns the step's gradients into the shards' sums over the data
ranks (reduce-scatter; an all-reduce for the other leaves), and ``norm``
takes the global gradient norm counting every distinct shard once.
``full`` / ``local`` convert between a rank's part and the whole leaf, for
checkpoints written in the reference format at any layout.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from lasr_tpu_torch.parallel import dist

# leaves smaller than this stay whole under FSDP (lasr_tpu's FSDP_MIN_SIZE)
FSDP_MIN_SIZE = 32768

_COL = ("linear_q.weight", "linear_k.weight", "linear_v.weight",
        "linear_pos.weight", "feed_forward.w_1.weight",
        "output_layer.weight", "ctc.1.weight")
_ROW = ("linear_out.weight", "feed_forward.w_2.weight")
_VOCAB = ("decoder.embed.0.weight",)
_BLOCK = re.compile(r"(?:^|\.)encoder\.encoders\.(\d+)\.")


class Spec(NamedTuple):
    """The torch dim split over the model ranks and the one split over the
    data ranks (None: whole); the pipe rank that holds the leaf (None:
    every one); whether the gradient sums over the seq ranks too."""
    tp: Optional[int]
    fsdp: Optional[int]
    pipe: Optional[int] = None
    seq: bool = False


def tp_dim(name: str, shape: Sequence[int], model_size: int
           ) -> Optional[int]:
    """The dim of ``name`` that tensor parallelism splits, or None."""
    if model_size <= 1:
        return None
    dim = None
    if name.endswith(_COL) or name.endswith(_VOCAB):
        dim = 0
    elif name.endswith(_ROW):
        dim = 1
    if dim is None or shape[dim] % model_size:
        return None
    return dim


def pipe_owner(name: str, num_blocks: int, stages: int,
               pipe_size: int) -> Optional[int]:
    """The pipe rank that holds parameter ``name`` (a model's state_dict
    name): the owner of its block's stage for the encoder's blocks, None
    for everything else (whole on every pipe rank)."""
    m = _BLOCK.search(name)
    if m is None or stages <= 1 or pipe_size <= 1:
        return None
    stage = int(m.group(1)) // (num_blocks // stages)
    return stage // (stages // pipe_size)


# a kernel's dims in Flax's order, as torch dims (the weight bridge's
# transposes, utils/weights.py flax_to_state_dict)
_FLAX_ORDER = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flax_order(module: nn.Module, leaf: str, ndim: int) -> Sequence[int]:
    if leaf == "weight" and isinstance(
            module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return _FLAX_ORDER[ndim]
    return tuple(range(ndim))


def param_specs(model: nn.Module, model_size: int = 1, data_size: int = 1,
                fsdp: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE,
                pipe_size: int = 1, seq_split: bool = False
                ) -> Dict[str, Spec]:
    """Every parameter's ``Spec`` on the full (unsplit) ``model``."""
    encoder = getattr(model, "encoder", None)
    stages = getattr(encoder, "pipeline_stages", 1)
    out = {}
    for mname, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            tp = tp_dim(name, p.shape, model_size) \
                if getattr(module, "splittable", True) else None
            dp = None
            if fsdp and data_size > 1 and p.ndim >= 2 \
                    and p.numel() >= fsdp_min_size:
                for dim in _flax_order(module, leaf, p.ndim):
                    if dim != tp and p.shape[dim] % data_size == 0:
                        dp = dim
                        break
            owner = None if stages <= 1 else pipe_owner(
                name, len(encoder.encoders), stages, pipe_size)
            out[name] = Spec(tp, dp, owner,
                             seq_split and name.startswith("encoder."))
    return out


def part(x: torch.Tensor, dim: Optional[int], rank: int, size: int
         ) -> torch.Tensor:
    """Rank ``rank``'s 1/size of ``x`` along ``dim`` (x itself for None)."""
    if dim is None or size == 1:
        return x
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n)


class ShardLayout:
    """The parameters of a model whose tensor-parallel layers hold their
    part, with the FSDP leaves kept as shards.  ``names`` / ``params`` are
    ``named_parameters`` order; ``masters[i]`` is the rank's shard of
    leaf i (the parameter itself where FSDP leaves it whole, an empty
    tensor where another pipe rank holds it)."""

    def __init__(self, model: nn.Module, specs: Dict[str, Spec]):
        g = dist.grid()
        self.grid = g
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.specs = [specs[n] for n in self.names]
        # a pipeline block's module prefix -> its pipe rank (for the
        # blocks' buffers)
        self._owners = {n.rsplit(".", 1)[0]: s.pipe
                        for n, s in zip(self.names, self.specs)
                        if s.pipe is not None}
        self.full_shapes = []
        for p, s in zip(self.params, self.specs):
            shape = list(p.shape)
            if s.tp is not None:
                shape[s.tp] *= g.model_size
            self.full_shapes.append(tuple(shape))
        self.fsdp = any(s.fsdp is not None for s in self.specs)
        self.seq = any(s.seq for s in self.specs)
        self.sharded = self.fsdp or any(
            s.tp is not None or s.pipe is not None for s in self.specs)
        self.held = [s.pipe is None or s.pipe == g.pipe_rank
                     for s in self.specs]
        for p, held in zip(self.params, self.held):
            if not held:
                p.data = p.data.new_empty((0,))
        self.masters: List[torch.Tensor] = [
            part(p.detach(), s.fsdp, g.data_rank, g.data_size).clone()
            if s.fsdp is not None and held else p
            for p, s, held in zip(self.params, self.specs, self.held)]
        self.release()

    # ---- the module's parameters ----

    @torch.no_grad()
    def gather(self, source: Optional[Sequence[torch.Tensor]] = None
               ) -> None:
        """Put the whole leaves of ``source`` (shard-shaped, default the
        masters) in the module's parameters: FSDP leaves gathered over the
        data ranks, the others copied where they are not the parameter
        itself."""
        source = self.masters if source is None else source
        for p, s, x, held in zip(self.params, self.specs, source,
                                 self.held):
            if not held:
                continue
            if s.fsdp is not None:
                p.data = dist.gather_dim(x, s.fsdp, "data")
            elif x is not p:
                p.data.copy_(x)

    def release(self) -> None:
        """Free the FSDP leaves' whole copies (until the next gather)."""
        for p, s, held in zip(self.params, self.specs, self.held):
            if s.fsdp is not None and held:
                p.data = p.data.new_empty((0,))

    # ---- gradients ----

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the data ranks of each leaf's gradient, as the
        rank's shard: reduce-scatter for FSDP leaves, one flat all-reduce
        for the rest; then over the seq ranks for the ``Spec.seq``
        leaves."""
        out = list(grads)
        whole = [i for i, s in enumerate(self.specs) if s.fsdp is None]
        for i, g in zip(whole, dist.all_reduce_flat([grads[i]
                                                     for i in whole])):
            out[i] = g
        for i, s in enumerate(self.specs):
            if s.fsdp is not None and self.held[i]:
                out[i] = dist.reduce_scatter_dim(grads[i], s.fsdp, "data")
        seq = [i for i, s in enumerate(self.specs) if s.seq]
        for i, g in zip(seq, dist.all_reduce_flat([out[i] for i in seq],
                                                  "seq")):
            out[i] = g
        return out

    def norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of reduced gradients (``optimizer.global_norm``
        of the whole gradient): each distinct shard counted once (a leaf
        FSDP leaves whole by data rank 0, one tensor parallelism leaves
        whole by model rank 0, one whole on every pipe rank by pipe rank
        0, every leaf by seq rank 0), summed over every rank."""
        g = self.grid
        # (in the squares' dtype, so that a rank that counts nothing
        # sends what the others send)
        sq = torch.zeros((), device=grads[0].device).float()
        for x, s in zip(grads, self.specs):
            if (s.fsdp is None and g.data_rank) or \
                    (s.tp is None and g.model_rank) or g.seq_rank or \
                    (s.pipe is None and g.pipe_rank):
                continue
            sq = sq + torch.sum(x.float() * x.float())
        return torch.sqrt(dist.all_reduce_flat([sq], "world")[0])

    # ---- whole leaves ----

    @torch.no_grad()
    def full(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf i from this rank's shard-shaped ``x`` (every rank
        calls it, in the same order)."""
        s = self.specs[i]
        if s.fsdp is not None and self.held[i]:
            x = dist.gather_dim(x, s.fsdp, "data")
        if s.tp is not None and self.held[i]:
            x = dist.gather_dim(x, s.tp, "model")
        if s.pipe is not None:
            if not self.held[i]:
                x = x.new_empty(self.full_shapes[i])
            x = dist.pipe_broadcast(x.contiguous(), s.pipe)
        return x

    @torch.no_grad()
    def full_buffers(self, state: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """``state`` (a model's state_dict) with each pipeline block's
        buffers (BatchNorm statistics) taken from its pipe rank (every
        rank calls it)."""
        out = dict(state)
        params = set(self.names)
        for name, v in state.items():
            owner = self._owners.get(name.rsplit(".", 1)[0])
            if owner is not None and name not in params:
                out[name] = dist.pipe_broadcast(v.clone(), owner)
        return out

    def local(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole leaf i ``x`` (empty where
        another pipe rank holds the leaf)."""
        s, g = self.specs[i], self.grid
        if not self.held[i]:
            return x.new_empty((0,))
        x = part(x, s.tp, g.model_rank, g.model_size)
        return part(x, s.fsdp, g.data_rank, g.data_size)

    def full_list(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [self.full(i, x) for i, x in enumerate(xs)]

    def local_list(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [self.local(i, x).clone() for i, x in enumerate(xs)]

    @torch.no_grad()
    def load_full(self, state: Dict[str, torch.Tensor]) -> None:
        """Every parameter's whole value from ``state`` (name → tensor)
        into its rank's part: the masters, and the module parameters of
        the leaves FSDP leaves whole."""
        for i, (name, p, s) in enumerate(zip(self.names, self.params,
                                              self.specs)):
            if not self.held[i]:
                continue
            x = self.local(i, state[name].to(p.device, p.dtype))
            if s.fsdp is not None:
                self.masters[i] = x.clone()
            else:
                p.data.copy_(x)
