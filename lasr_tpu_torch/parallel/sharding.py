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
``_leaf_spec`` gives that leaf on a ``make_mesh(data, model)`` mesh.

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


class Spec(NamedTuple):
    """The torch dim split over the model ranks and the one split over the
    data ranks (None: whole)."""
    tp: Optional[int]
    fsdp: Optional[int]


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


# a kernel's dims in Flax's order, as torch dims (the weight bridge's
# transposes, utils/weights.py flax_to_state_dict)
_FLAX_ORDER = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flax_order(module: nn.Module, leaf: str, ndim: int) -> Sequence[int]:
    if leaf == "weight" and isinstance(
            module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return _FLAX_ORDER[ndim]
    return tuple(range(ndim))


def param_specs(model: nn.Module, model_size: int = 1, data_size: int = 1,
                fsdp: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE
                ) -> Dict[str, Spec]:
    """Every parameter's ``Spec`` on the full (unsplit) ``model``."""
    out = {}
    for mname, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            tp = tp_dim(name, p.shape, model_size)
            dp = None
            if fsdp and data_size > 1 and p.ndim >= 2 \
                    and p.numel() >= fsdp_min_size:
                for dim in _flax_order(module, leaf, p.ndim):
                    if dim != tp and p.shape[dim] % data_size == 0:
                        dp = dim
                        break
            out[name] = Spec(tp, dp)
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
    leaf i (the parameter itself where FSDP leaves it whole)."""

    def __init__(self, model: nn.Module, specs: Dict[str, Spec]):
        g = dist.grid()
        self.grid = g
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.specs = [specs[n] for n in self.names]
        self.full_shapes = []
        for p, s in zip(self.params, self.specs):
            shape = list(p.shape)
            if s.tp is not None:
                shape[s.tp] *= g.model_size
            self.full_shapes.append(tuple(shape))
        self.fsdp = any(s.fsdp is not None for s in self.specs)
        self.sharded = self.fsdp or any(s.tp is not None
                                        for s in self.specs)
        self.masters: List[torch.Tensor] = [
            part(p.detach(), s.fsdp, g.data_rank, g.data_size).clone()
            if s.fsdp is not None else p
            for p, s in zip(self.params, self.specs)]
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
        for p, s, x in zip(self.params, self.specs, source):
            if s.fsdp is not None:
                p.data = dist.gather_dim(x, s.fsdp, "data")
            elif x is not p:
                p.data.copy_(x)

    def release(self) -> None:
        """Free the FSDP leaves' whole copies (until the next gather)."""
        for p, s in zip(self.params, self.specs):
            if s.fsdp is not None:
                p.data = p.data.new_empty((0,))

    # ---- gradients ----

    @torch.no_grad()
    def reduce(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the data ranks of each leaf's gradient, as the
        rank's shard: reduce-scatter for FSDP leaves, one flat all-reduce
        for the rest."""
        out = list(grads)
        whole = [i for i, s in enumerate(self.specs) if s.fsdp is None]
        for i, g in zip(whole, dist.all_reduce_flat([grads[i]
                                                     for i in whole])):
            out[i] = g
        for i, s in enumerate(self.specs):
            if s.fsdp is not None:
                out[i] = dist.reduce_scatter_dim(grads[i], s.fsdp, "data")
        return out

    def norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of reduced gradients (``optimizer.global_norm``
        of the whole gradient): each distinct shard counted once (a leaf
        FSDP leaves whole by data rank 0, one tensor parallelism leaves
        whole by model rank 0), summed over every rank."""
        g = self.grid
        sq = torch.zeros((), device=grads[0].device)
        for x, s in zip(grads, self.specs):
            if (s.fsdp is None and g.data_rank) or \
                    (s.tp is None and g.model_rank):
                continue
            sq = sq + torch.sum(x.float() * x.float())
        return torch.sqrt(dist.all_reduce_flat([sq], "world")[0])

    # ---- whole leaves ----

    @torch.no_grad()
    def full(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The whole leaf i from this rank's shard-shaped ``x`` (every rank
        calls it, in the same order)."""
        s = self.specs[i]
        if s.fsdp is not None:
            x = dist.gather_dim(x, s.fsdp, "data")
        if s.tp is not None:
            x = dist.gather_dim(x, s.tp, "model")
        return x

    def local(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole leaf i ``x``."""
        s, g = self.specs[i], self.grid
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
            x = self.local(i, state[name].to(p.device, p.dtype))
            if s.fsdp is not None:
                self.masters[i] = x.clone()
            else:
                p.data.copy_(x)
