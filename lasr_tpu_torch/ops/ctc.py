"""CTC loss as the log-semiring forward recursion (counterpart of
``lasr_tpu/ops/ctc.py``).

The JAX package owns this DP (``lax.scan``) rather than calling a library
CTC, and its gradient comes from autodiff; here the same recursion is a
Python loop over the frames, differentiated by autograd.  Impossible
states carry the finite ``_NEG_INF = -1e30`` as in ``lasr_tpu``, so an
infeasible alignment gives a log-likelihood near -1e30 (``F.ctc_loss``
would give -inf).

Formulation (Graves et al. 2006): extended labels ``[b, y1, b, ..., yL,
b]`` of length S = 2L+1; alpha frozen past each row's ``input_len``; the
result read at the two final states ``2*label_len`` and ``2*label_len-1``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def _logsumexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=_NEG_INF)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + torch.exp(c - m_safe))
    return torch.where(m <= _NEG_INF, _NEG_INF, out)


def _ctc_forward(scores, lse, input_len, labels, label_len, blank):
    """Emissions are ``gather(scores) - lse`` (``lse=None``: scores are
    already log-probabilities).  Returns (B,) log-likelihoods."""
    B, T, V = scores.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = scores.device
    s_idx = torch.arange(S, device=dev)
    is_lbl = (s_idx % 2) == 1
    lbl_pos = torch.clamp((s_idx - 1) // 2, 0, max(L - 1, 0))
    if L:
        ext = torch.where(is_lbl[None, :],
                          labels.long().gather(1, lbl_pos[None].expand(B, S)),
                          blank)
    else:
        ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    label_len = label_len.long()
    state_ok = s_idx[None, :] < (2 * label_len[:, None] + 1)
    ext_m2 = F.pad(ext, (2, 0), value=blank)[:, :S]
    can_skip = is_lbl[None, :] & (ext != ext_m2) & (s_idx[None, :] >= 2)

    emit = scores.gather(2, ext[:, None, :].expand(B, T, S)).float()
    if lse is not None:
        emit = emit - lse[:, :, None]
    has_lbl = label_len > 0
    alpha = torch.full((B, S), _NEG_INF, device=dev)
    alpha = torch.cat([emit[:, 0, :1],
                       torch.where(has_lbl, emit[:, 0, 1], _NEG_INF)[:, None]
                       if S > 1 else emit[:, 0, :0],
                       alpha[:, 2:]], dim=1)
    alpha = torch.where(state_ok, alpha, _NEG_INF)

    input_len = input_len.to(dev).long()
    t_max = int(input_len.max()) if B else 0
    for t in range(1, min(T, t_max)):
        prev1 = F.pad(alpha, (1, 0), value=_NEG_INF)[:, :S]
        prev2 = F.pad(alpha, (2, 0), value=_NEG_INF)[:, :S]
        prev2 = torch.where(can_skip, prev2, _NEG_INF)
        new = _logsumexp3(alpha, prev1, prev2) + emit[:, t]
        new = torch.where(state_ok, new, _NEG_INF)
        alpha = torch.where((t < input_len)[:, None], new, alpha)

    a_end1 = alpha.gather(1, (2 * label_len)[:, None])[:, 0]
    a_end2 = alpha.gather(1, torch.clamp(2 * label_len - 1, min=0)[:, None])
    a_end2 = torch.where(has_lbl, a_end2[:, 0], _NEG_INF)
    m = torch.maximum(a_end1, a_end2)
    m_safe = torch.clamp(m, min=_NEG_INF)
    ll = m_safe + torch.log(torch.exp(a_end1 - m_safe)
                            + torch.exp(a_end2 - m_safe))
    return torch.where(m <= _NEG_INF, _NEG_INF, ll)


def ctc_forward_logprob(log_probs, input_len, labels, label_len,
                        blank: int = 0):
    """Per-utterance CTC log-likelihood log p(labels | log_probs):
    log_probs (B, T, V) log-softmaxed; input_len (B,); labels (B, L)
    (padding masked by label_len); label_len (B,).  Returns (B,) <= 0."""
    return _ctc_forward(log_probs, None, input_len, labels, label_len, blank)


def ctc_forward_from_logits(logits, input_len, labels, label_len,
                            blank: int = 0):
    """``ctc_forward_logprob`` from raw logits: the log-softmax is folded
    into the lattice (a (B, T) logsumexp), so no (B, T, V) log-prob tensor
    is written."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    return _ctc_forward(logits, lse, input_len, labels, label_len, blank)


def ctc_loss(logits, input_len, labels, label_len, blank: int = 0):
    """Sum over the batch / B, the reference reduction."""
    ll = ctc_forward_logprob(torch.log_softmax(logits, dim=-1), input_len,
                             labels, label_len, blank)
    return -ll.sum() / logits.shape[0]


def ctc_labels_from_padded(padded, ignore_id: int = -1):
    """(labels, label_len) from an ignore_id-padded label matrix: each
    row's valid labels compacted to the left (stable), the rest 0."""
    valid = padded != ignore_id
    label_len = valid.sum(dim=1).to(torch.int32)
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    labels = padded.gather(1, order)
    keep = (torch.arange(padded.shape[1], device=padded.device)[None, :]
            < label_len[:, None])
    return torch.where(keep, labels, 0), label_len
