"""Sequence distance criteria (counterpart of
``lasr_tpu/models/distances.py``): plain callables over (B, T, D) pairs
of tensors, each returning a scalar (``SeqCEDistance(reduction='none')``
the flattened per-step values)."""

from __future__ import annotations

import torch


class SeqCrossEntropy:
    """Flattened CE: x (B, T, V) logits vs y (B, T) ids."""

    def __call__(self, x, y):
        logp = torch.log_softmax(x.reshape(-1, x.shape[-1]), dim=-1)
        picked = torch.gather(logp, 1, y.reshape(-1, 1).long())[:, 0]
        return -picked.mean()


class SeqCosineSimilarity:
    """Mean (1 - cosine) over flattened time steps."""

    def __call__(self, f1, f2):
        a = f1.reshape(-1, f1.shape[-1])
        b = f2.reshape(-1, f2.shape[-1])
        num = (a * b).sum(-1)
        den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
        return (1.0 - num / torch.clamp(den, min=1e-8)).mean()


class SeqPairwiseDistance:
    """Mean p-norm distance over flattened steps."""

    def __init__(self, p: float = 2.0, eps: float = 1e-6):
        self.p = p
        self.eps = eps

    def __call__(self, x, y):
        a = x.reshape(-1, x.shape[-1])
        b = y.reshape(-1, y.shape[-1])
        d = ((a - b + self.eps).abs() ** self.p).sum(-1) ** (1 / self.p)
        return d.mean()


class SeqKLDistance:
    """Symmetric KL over probability sequences; 'batchmean' semantics of
    the reference's transposed views: sum / D."""

    def __call__(self, x, y):
        x = torch.clamp(x.reshape(-1, x.shape[-1]), min=1e-30)
        y = torch.clamp(y.reshape(-1, y.shape[-1]), min=1e-30)
        d = x.shape[-1]
        kl_xy = (y * (torch.log(y) - torch.log(x))).sum() / d
        kl_yx = (x * (torch.log(x) - torch.log(y))).sum() / d
        return (kl_xy + kl_yx) / 2.0


class SeqCEDistance:
    """Cross entropy between probability sequences."""

    def __init__(self, reduction: str = "mean"):
        self.reduction = reduction

    def __call__(self, x, y):
        x = torch.clamp(x, min=1e-30)
        ce = -(y * torch.log(x)).sum(-1).reshape(-1)
        if self.reduction == "mean":
            return ce.mean()
        if self.reduction == "sum":
            return ce.sum()
        return ce
