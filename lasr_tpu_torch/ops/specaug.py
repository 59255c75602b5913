"""SpecAugment on the device (counterpart of ``lasr_tpu/ops/specaug.py``).

The random draws are split from their application:
``spec_augment_draws`` takes, from a caller-owned ``torch.Generator``, the
time-warp centre and warp point of each row and the bound, width and start
of each frequency and time mask; ``apply_spec_augment`` applies them.  The
JAX package draws from its PRNG key, whose bits torch cannot reproduce, so
the parity tests hand JAX's own draws to ``apply_spec_augment``.

The reference's quirks are kept, as in ``lasr_tpu``:
  - each mask draws (bound, width) ~ randint(0, F)²; the bound only limits
    the start and skips the mask when it is 0, the width sets the run;
  - the fill is the mean over the valid frames, recomputed after each
    mask (``replace_with_zero`` fills zeros);
  - the time warp is bilinear with PIL's pixel-centre mapping, skipped when
    ``t_len - W <= W``;
  - padding frames stay zero.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _randint(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """``lasr_tpu``'s uniform integer in [lo, hi) from u ~ U[0, 1)."""
    return (lo + torch.floor(u * (hi - lo))).to(torch.int32)


def spec_augment_draws(feat_len: torch.Tensor, n_freq: int,
                       generator: torch.Generator, max_time_warp: int = 5,
                       max_freq_width: int = 27, n_freq_mask: int = 2,
                       max_time_width: int = 40,
                       n_time_mask: int = 2) -> Dict[str, torch.Tensor]:
    """Per-row draws: ``center``, ``warped`` (B,), and ``freq_bound``,
    ``freq_width``, ``freq_start`` (B, n_freq_mask), ``time_*`` (B,
    n_time_mask), all int32 on ``feat_len``'s device."""
    B = feat_len.shape[0]
    dev = feat_len.device
    t_len = feat_len.to(torch.float32)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def width(n, top):
        if top <= 0:
            return torch.zeros((B, n), dtype=torch.int32, device=dev)
        return torch.randint(0, top, (B, n), generator=generator,
                             device=dev, dtype=torch.int32)

    W = float(max_time_warp)
    center = _randint(uniform(B), W, torch.clamp(t_len - W, min=W + 1))
    warped = _randint(uniform(B), center - W, center + W) + 1
    freq_bound = width(n_freq_mask, max_freq_width)
    freq_width = width(n_freq_mask, max_freq_width)
    freq_start = _randint(uniform(B, n_freq_mask), 0.0,
                          torch.clamp(n_freq - freq_bound, min=1))
    time_bound = width(n_time_mask, max_time_width)
    time_width = width(n_time_mask, max_time_width)
    time_start = _randint(uniform(B, n_time_mask), 0.0,
                          torch.clamp(feat_len[:, None] - time_bound, min=1))
    return dict(center=center, warped=warped, freq_bound=freq_bound,
                freq_width=freq_width, freq_start=freq_start,
                time_bound=time_bound, time_width=time_width,
                time_start=time_start)


def _time_warp(x, t_len, center, warped, window: int):
    """Warp each row (T, F) around its centre, length preserved."""
    T = x.shape[1]
    do_warp = t_len - window > window
    out_pos = torch.arange(T, dtype=torch.float32, device=x.device)[None]
    cf = center.to(torch.float32)[:, None]
    wf = warped.to(torch.float32)[:, None]
    tf = t_len.to(torch.float32)[:, None]
    left = (out_pos + 0.5) * cf / torch.clamp(wf, min=1.0) - 0.5
    right = cf + (out_pos - wf + 0.5) * (tf - cf) \
        / torch.clamp(tf - wf, min=1.0) - 0.5
    src = torch.where(out_pos < wf, left, right)
    src = torch.where(out_pos < tf, src, out_pos)    # identity on padding
    src = torch.minimum(torch.clamp(src, min=0.0), tf - 1.0)
    lo = torch.floor(src)
    frac = (src - lo)[..., None]
    lo = torch.clamp(lo.to(torch.int64), 0, T - 1)
    hi = torch.clamp(lo + 1, max=T - 1)
    index = lambda i: i[..., None].expand(x.shape)  # noqa: E731
    out = (torch.gather(x, 1, index(lo)) * (1.0 - frac)
           + torch.gather(x, 1, index(hi)) * frac)
    return torch.where(do_warp[:, None, None], out.to(x.dtype), x)


def apply_spec_augment(feats: torch.Tensor, feat_len: torch.Tensor,
                       draws: Dict[str, torch.Tensor],
                       max_time_warp: int = 5,
                       replace_with_zero: bool = False) -> torch.Tensor:
    """feats (B, T, F), zero past each ``feat_len``; ``draws`` from
    ``spec_augment_draws`` (or the JAX package's own).  Returns the
    augmented (B, T, F), padding zero."""
    B, T, F = feats.shape
    t_len = feat_len.to(torch.int64)
    x = feats
    if max_time_warp > 0:
        x = _time_warp(x, t_len, draws["center"], draws["warped"],
                       max_time_warp)
    valid = (torch.arange(T, device=x.device)[None, :]
             < t_len[:, None])[..., None]                   # (B, T, 1)
    n_valid = torch.clamp(t_len * F, min=1).to(torch.float32)

    def fill(cur):
        if replace_with_zero:
            return torch.zeros((), dtype=cur.dtype, device=cur.device)
        return (torch.where(valid, cur, 0.0).sum(dim=(1, 2))
                / n_valid)[:, None, None]

    cols = torch.arange(F, device=x.device)[None]
    for i in range(draws["freq_bound"].shape[1]):
        bound = draws["freq_bound"][:, i, None]
        start = draws["freq_start"][:, i, None]
        stop = start + draws["freq_width"][:, i, None]
        hit = (cols >= start) & (cols < stop) & (bound > 0)
        x = torch.where(hit[:, None, :] & valid, fill(x), x)
    rows = torch.arange(T, device=x.device)[None]
    for i in range(draws["time_bound"].shape[1]):
        bound = draws["time_bound"][:, i, None]
        start = draws["time_start"][:, i, None]
        stop = start + draws["time_width"][:, i, None]
        hit = ((rows >= start) & (rows < stop) & (bound > 0)
               & (t_len[:, None] - bound > 0))
        x = torch.where(hit[:, :, None] & valid, fill(x), x)
    return torch.where(valid, x, 0.0)


def spec_augment(feats: torch.Tensor, feat_len: torch.Tensor,
                 generator: torch.Generator, max_time_warp: int = 5,
                 max_freq_width: int = 27, n_freq_mask: int = 2,
                 max_time_width: int = 40, n_time_mask: int = 2,
                 replace_with_zero: bool = False,
                 rows: Optional[Tuple[int, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """SpecAugment of a padded batch with draws from ``generator``.

    ``rows = (row0, global_feat_len)``: the batch is rows ``row0`` on of a
    global batch whose feature lengths are ``global_feat_len``; the draws
    are the global batch's, and the batch gets its rows' (a data-parallel
    rank augments its rows as the one-process step does)."""
    draw_len, row0 = (feat_len, 0) if rows is None else (rows[1], rows[0])
    draws = spec_augment_draws(draw_len, feats.shape[-1], generator,
                               max_time_warp, max_freq_width, n_freq_mask,
                               max_time_width, n_time_mask)
    if rows is not None:
        draws = {k: v[row0: row0 + feats.shape[0]] for k, v in draws.items()}
    return apply_spec_augment(feats, feat_len, draws, max_time_warp,
                              replace_with_zero)
