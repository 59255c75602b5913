"""Tensor parallelism over the model ranks of the grid (the ``model`` axis
of ``lasr_tpu/parallel/mesh.py``), Megatron-style, on the rules of
``parallel/sharding.py``.

``apply_tensor_parallel(model, specs)`` turns a full model, in place, into
its model rank's part:

  - a column-parallel Linear keeps its rank's output rows; its input
    enters through ``copy_to_model`` (identity forward, the backward sums
    the input gradient over the model ranks) and its whole bias is taken
    through ``slice_replicated`` (the backward puts the part's gradient in
    place and sums over the model ranks, so every rank holds the whole
    gradient of the replicated bias);
  - a row-parallel Linear keeps its rank's input columns; the partial
    products are summed over the model ranks (``reduce_from_model``,
    identity backward) before the whole bias is added;
  - the vocabulary-split embedding looks up the ids in its rank's rows
    (zeros elsewhere) and sums over the model ranks;
  - the decoder's output layer and the CTC head are column-parallel and
    gather their logits (``gather_from_model``), so the loss sees whole
    logits;
  - an attention module attends over its rank's H / N heads (its q, k,
    v, pos projections column-parallel, ``linear_out`` row-parallel,
    ``pos_bias_u`` / ``pos_bias_v`` sliced), so the rel kernels run on
    BH = B·H/N with the positional table of the local heads; a
    feed-forward runs its rank's hidden units;
  - the monotonic attention (``MTMultiHeadedAttention``, one head in the
    streaming decoder), and any attention whose heads the model ranks do
    not divide, splits the same projections by columns, inside a head
    (``column_shard``): the ranks gather the projections' columns, compute
    the energies, the probabilities (the sigmoid noise drawn alike from
    the shared generator) or a kernel whole, and each takes its columns
    of the context into its rows of ``linear_out``
    (``modules.attention``).

Everything else (norms, the conv module, subsampling, BatchNorm) is
computed whole on every model rank, on the same inputs, so its gradient
is the same there.  Dropout in a split region draws the whole tensor's
mask and keeps the rank's part (``modules.dropout``'s ``shard``), so the
model ranks of a data index, which share a generator, draw what one
process would.  Collectives run in float32 (bf16 values cast exactly).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from lasr_tpu_torch.modules.attention import (MTMultiHeadedAttention,
                                              MultiHeadedAttention)
from lasr_tpu_torch.modules.feed_forward import PositionwiseFeedForward
from lasr_tpu_torch.modules.layers import Embedding, Linear
from lasr_tpu_torch.parallel import dist
from lasr_tpu_torch.parallel.dist import (copy_to_model, gather_from_model,
                                          reduce_from_model, slice_replicated)
from lasr_tpu_torch.parallel.sharding import Spec, part


def _meta_linear(cls, lin: Linear, in_f: int, out_f: int, weight):
    new = cls(in_f, out_f, bias=lin.bias is not None, device="meta")
    new.dtype = lin.dtype
    new.weight = nn.Parameter(weight.detach().clone())
    if lin.bias is not None:
        new.bias = nn.Parameter(lin.bias.detach().clone())
    return new


class ColumnParallelLinear(Linear):
    """The rank's output rows of a Linear; ``gather`` concatenates the
    ranks' outputs (the logits heads)."""

    gather = False

    @classmethod
    def of(cls, lin: Linear, gather: bool):
        r, n = dist.model_rank(), dist.model_size()
        new = _meta_linear(cls, lin, lin.in_features, lin.out_features // n,
                           part(lin.weight, 0, r, n))
        new.gather = gather
        return new

    def forward(self, x):
        b = None if self.bias is None else slice_replicated(self.bias, 0)
        y = F.linear(*self._cast(copy_to_model(x), self.weight, b))
        return gather_from_model(y) if self.gather else y


class RowParallelLinear(Linear):
    """The rank's input columns of a Linear; the partial products summed
    over the model ranks, then the whole bias."""

    @classmethod
    def of(cls, lin: Linear):
        r, n = dist.model_rank(), dist.model_size()
        return _meta_linear(cls, lin, lin.in_features // n, lin.out_features,
                            part(lin.weight, 1, r, n))

    def forward(self, x):
        x, w, b = self._cast(x, self.weight, self.bias)
        y = reduce_from_model(F.linear(x, w))
        return y if b is None else y + b


class VocabParallelEmbedding(Embedding):
    """The rank's rows of the token table; ids elsewhere look up zeros,
    and the ranks' lookups are summed."""

    @classmethod
    def of(cls, emb: Embedding):
        r, n = dist.model_rank(), dist.model_size()
        rows = emb.num_embeddings // n
        new = cls(rows, emb.embedding_dim, device="meta")
        new.dtype = emb.dtype
        new.start = r * rows
        new.weight = nn.Parameter(part(emb.weight, 0, r, n).detach().clone())
        return new

    def forward(self, ids):
        local = ids - self.start
        inside = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(torch.where(inside, local, 0), self.weight)
        rows = rows * inside[..., None].to(rows.dtype)
        return reduce_from_model(rows).to(self.dtype)


def _split(parent: nn.Module, child: str, spec: Spec, gather: bool):
    mod = getattr(parent, child)
    if isinstance(mod, Embedding):
        new = VocabParallelEmbedding.of(mod)
    elif spec.tp == 0:
        new = ColumnParallelLinear.of(mod, gather)
    else:
        new = RowParallelLinear.of(mod)
    setattr(parent, child, new)


@torch.no_grad()
def apply_tensor_parallel(model: nn.Module, specs: Dict[str, Spec]) -> None:
    """Replace, in place, every layer that ``specs`` splits over the model
    ranks by its rank's part (see the module docstring).  Raises where the
    rules split some of an attention's projections and not the others."""
    n, r = dist.model_size(), dist.model_rank()
    if n == 1:
        return
    for name, mod in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(mod, MultiHeadedAttention):
            split = [specs[prefix + f"{c}.weight"].tp is not None
                     for c in ("linear_q", "linear_k", "linear_v",
                               "linear_out")]
            if not any(split):
                continue
            if not all(split):
                raise NotImplementedError(
                    f"{name}: the projections of {mod.n_feat} features do "
                    f"not all split over {n} model ranks")
            for c in ("linear_q", "linear_k", "linear_v", "linear_pos",
                      "linear_out"):
                if hasattr(mod, c):
                    _split(mod, c, specs[prefix + f"{c}.weight"], False)
            if isinstance(mod, MTMultiHeadedAttention) or mod.n_head % n:
                mod.column_shard = (r, n)
            else:
                mod.n_head //= n
                mod.head_shard = (r, n)
        elif isinstance(mod, PositionwiseFeedForward):
            if specs[prefix + "w_1.weight"].tp is None:
                continue
            _split(mod, "w_1", specs[prefix + "w_1.weight"], False)
            _split(mod, "w_2", specs[prefix + "w_2.weight"], False)
            mod.hidden_shard = (r, n)
        else:
            # the logits heads and the token embedding: whole outputs
            for child, sub in list(mod.named_children()):
                key = prefix + child + ".weight"
                if isinstance(sub, (Linear, Embedding)) and key in specs \
                        and specs[key].tp is not None:
                    _split(mod, child, specs[key], True)
