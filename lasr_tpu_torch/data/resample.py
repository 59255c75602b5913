"""First-party Kaiser-windowed-sinc polyphase resampler (a copy of
``lasr_tpu/data/resample.py``; numpy only).

The reference resamples with ``librosa.resample(..., res_type="kaiser_fast")``
(lasr/data/datatrans.py:16-20), i.e. resampy's Kaiser-windowed sinc.
So that the port needs none of librosa, resampy or scipy, the polyphase
filter bank is implemented directly over numpy: zero-stuff
by L, FIR with a Kaiser-windowed sinc low-pass at the tighter Nyquist,
decimate by M — evaluated phase-by-phase as strided matmuls
(sliding_window_view @ taps), never materializing the upsampled signal.

Quality presets mirror resampy's published filters:
  kaiser_best: 64 zero crossings, beta 14.7697, rolloff 0.9476
  kaiser_fast: 16 zero crossings, beta  8.5555, rolloff 0.85

Held against ``lasr_tpu``'s copy in ``tests/test_torch_port_data.py``.
"""

from __future__ import annotations

from math import gcd

import numpy as np

PRESETS = {
    # (zero crossings per side, kaiser beta, rolloff)
    "kaiser_best": (64, 14.769656459379492, 0.9475937167399596),
    "kaiser_fast": (16, 8.555504641634386, 0.85),
}


def design_kaiser_sinc(L: int, M: int, zeros: int, beta: float,
                       rolloff: float) -> np.ndarray:
    """FIR low-pass for an L-up / M-down polyphase resampler, at the
    L-upsampled rate: cutoff ``rolloff / max(L, M)`` (normalized frequency,
    1.0 = Nyquist), ``zeros`` sinc zero-crossings per side, Kaiser window.
    Gain L compensates the zero-stuffing."""
    cutoff = rolloff / max(L, M)
    half = zeros * max(L, M)
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(2 * half + 1, beta)
    return (L * h).astype(np.float64)


def upfirdn_poly(h: np.ndarray, x: np.ndarray, L: int, M: int,
                 n_out: int) -> np.ndarray:
    """Polyphase ``decimate(conv(h, zerostuff(x, L)), M)`` centered so that
    output m corresponds to input position m·M/L (the filter's group delay
    is removed).  Equivalent to scipy.signal.resample_poly(x, L, M,
    window=h/L) up to length convention."""
    K = len(h)
    half = (K - 1) // 2
    x = np.asarray(x, np.float64)
    N = len(x)
    # xu index of output m's filter center: c_m = m*M; taps cover
    # [c_m - half, c_m + half] in upsampled coords; xu[i] = x[i/L] when L|i
    # pad x so every gather is in range
    pad = half // L + 2
    xpad = np.concatenate([np.zeros(pad), x, np.zeros(pad + M // L + 2)])
    y = np.empty(n_out, np.float64)
    for p in range(L):
        # outputs m with (m*M + half) % L == (L - p) % L ... solve directly:
        # tap j (in upsampled coords) hits input samples where
        # (c_m + half - j) % L == 0.  Collect per-residue taps.
        # residue r = (c_m + half) % L selects the tap subset
        # h[j] with j ≡ r (mod L); input index = (c_m + half - j)/L.
        ms = np.arange(0, n_out)
        sel = ms[(ms * M + half) % L == p]
        if len(sel) == 0:
            continue
        taps = h[p::L][::-1]               # ascending input index order
        Kp = len(taps)
        # lowest input index touched by output m:
        # (m*M + half - (p + (Kp-1)*L))/L
        lo = (sel * M + half - (p + (Kp - 1) * L)) // L
        start = lo + pad
        if len(sel) > 1:
            step = start[1] - start[0]
            sw = np.lib.stride_tricks.sliding_window_view(xpad, Kp)
            # all starts are start[0] + k*step (sel is arithmetic in m)
            y[sel] = sw[start[0]::step][: len(sel)] @ taps
        else:
            y[sel] = xpad[start[0] : start[0] + Kp] @ taps
    return y


def resample_kaiser(wav: np.ndarray, src_rate: int, dst_rate: int,
                    quality: str = "kaiser_fast") -> np.ndarray:
    """Resample 1-D (or (N, C)) audio with the named quality preset."""
    if src_rate == dst_rate:
        return wav
    if wav.ndim == 2:
        return np.stack([resample_kaiser(wav[:, c], src_rate, dst_rate,
                                         quality)
                         for c in range(wav.shape[1])], axis=-1)
    zeros, beta, rolloff = PRESETS[quality]
    g = gcd(int(src_rate), int(dst_rate))
    L, M = dst_rate // g, src_rate // g
    h = design_kaiser_sinc(L, M, zeros, beta, rolloff)
    n_out = int(np.ceil(len(wav) * L / M))
    return upfirdn_poly(h, wav, L, M, n_out)


def resample_ratio(wav: np.ndarray, num: int, den: int,
                   quality: str = "kaiser_fast") -> np.ndarray:
    """Resample by the exact rational factor num/den (speed perturbation:
    rate r = 0.9/1.1 → num/den = 10/9, 10/11 at fixed sample rate)."""
    if num == den:
        return wav
    zeros, beta, rolloff = PRESETS[quality]
    g = gcd(num, den)
    L, M = num // g, den // g
    h = design_kaiser_sinc(L, M, zeros, beta, rolloff)
    n_out = int(np.ceil(len(wav) * L / M))
    return upfirdn_poly(h, wav, L, M, n_out)
