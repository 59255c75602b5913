"""Kaldi-compatible log-mel filterbank, batched on the device (counterpart
of ``lasr_tpu/ops/fbank.py``).

Kaldi semantics (src/feat/feature-window.cc + mel-computations.cc), as in
the JAX package: snip_edges framing (F = 1 + (S - 400) // 160), per-frame
DC removal, preemphasis with the first sample replicated, povey window,
zero-pad 400 → 512, power spectrum, mel banks on fft-bin centres with a
zero nyquist column, log(max(mel, FLT_EPSILON)).  The real DFT is two f32
matmuls against cos/sin bases, then the mel projection matmul.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

_FLT_EPS = float(np.finfo(np.float32).eps)


def _round_up_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class KaldiFbankConfig:
    sample_frequency: float = 16000.0
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 80
    low_freq: float = 20.0
    high_freq: float = 0.0          # <=0: offset from nyquist
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    window_type: str = "povey"
    blackman_coeff: float = 0.42
    use_power: bool = True
    use_log_fbank: bool = True
    snip_edges: bool = True
    audio_scale: float = 32768.0    # the reference scales by 2^(bits-1)

    @property
    def window_size(self) -> int:
        return int(self.sample_frequency * self.frame_length_ms / 1000.0)

    @property
    def window_shift(self) -> int:
        return int(self.sample_frequency * self.frame_shift_ms / 1000.0)

    @property
    def padded_window_size(self) -> int:
        return (_round_up_pow2(self.window_size)
                if self.round_to_power_of_two else self.window_size)


def fbank_num_frames(num_samples, cfg: KaldiFbankConfig = KaldiFbankConfig()):
    """Frame count under snip_edges framing; ints or tensors."""
    ws, sh = cfg.window_size, cfg.window_shift
    if isinstance(num_samples, (int, np.integer)):
        return 0 if num_samples < ws else 1 + (num_samples - ws) // sh
    n = 1 + torch.div(num_samples - ws, sh, rounding_mode="floor")
    return torch.where(num_samples < ws, 0, n).to(torch.int32)


def _feature_window(cfg: KaldiFbankConfig) -> np.ndarray:
    n = cfg.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if cfg.window_type == "povey":
        return (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    if cfg.window_type == "hanning":
        return 0.5 - 0.5 * np.cos(a * i)
    if cfg.window_type == "hamming":
        return 0.54 - 0.46 * np.cos(a * i)
    if cfg.window_type == "blackman":
        return (cfg.blackman_coeff - 0.5 * np.cos(a * i)
                + (0.5 - cfg.blackman_coeff) * np.cos(2 * a * i))
    if cfg.window_type == "rectangular":
        return np.ones(n)
    raise ValueError(f"unknown window type {cfg.window_type!r}")


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_banks(cfg: KaldiFbankConfig) -> np.ndarray:
    """Kaldi triangular mel filterbank (num_mel_bins, n_fft//2 + 1); the
    nyquist column is zero."""
    n_fft = cfg.padded_window_size
    num_fft_bins = n_fft // 2
    nyquist = 0.5 * cfg.sample_frequency
    high_freq = (cfg.high_freq if cfg.high_freq > 0.0
                 else nyquist + cfg.high_freq)
    if not (0.0 <= cfg.low_freq < nyquist
            and cfg.low_freq < high_freq <= nyquist):
        raise ValueError(f"bad frequency range [{cfg.low_freq}, {high_freq}]")
    fft_bin_width = cfg.sample_frequency / n_fft
    mel_low, mel_high = _mel_scale(cfg.low_freq), _mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (cfg.num_mel_bins + 1)
    bin_idx = np.arange(cfg.num_mel_bins, dtype=np.float64)[:, None]
    left = mel_low + bin_idx * mel_delta
    center = mel_low + (bin_idx + 1.0) * mel_delta
    right = mel_low + (bin_idx + 2.0) * mel_delta
    fft_mels = _mel_scale(
        fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up = (fft_mels - left) / (center - left)
    down = (right - fft_mels) / (right - center)
    out = np.zeros((cfg.num_mel_bins, num_fft_bins + 1), dtype=np.float64)
    out[:, :num_fft_bins] = np.maximum(0.0, np.minimum(up, down))
    return out


def _rdft_bases(cfg: KaldiFbankConfig):
    """cos/sin bases (window_size, n_fft//2+1) of the zero-padded real DFT,
    angles reduced mod n_fft in integer arithmetic."""
    n_fft = cfg.padded_window_size
    n = np.arange(cfg.window_size, dtype=np.int64)[:, None]
    k = np.arange(n_fft // 2 + 1, dtype=np.int64)[None, :]
    ang = 2.0 * math.pi * ((n * k) % n_fft).astype(np.float64) / n_fft
    return np.cos(ang), -np.sin(ang)


def log_mel_fbank(wav: torch.Tensor, wav_len: torch.Tensor,
                  cfg: KaldiFbankConfig = KaldiFbankConfig(),
                  max_frames=None):
    """Batched Kaldi log-mel fbank.

    wav: (B, S) float waveform in [-1, 1] (scaled by ``cfg.audio_scale``
    inside); wav_len: (B,) valid sample counts.  Returns feats
    (B, F, num_mel_bins) f32, zero past each utterance's length, and
    feat_len (B,) int32."""
    B, S = wav.shape
    ws, sh = cfg.window_size, cfg.window_shift
    F = fbank_num_frames(S, cfg)
    if max_frames is not None:
        F = min(F, max_frames)
    if F <= 0:
        raise ValueError(f"waveform too short for one frame: {S} < {ws}")
    dev = wav.device
    x = wav.to(torch.float32) * cfg.audio_scale
    frames = x.unfold(1, ws, sh)[:, :F]                      # (B, F, ws)
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis_coefficient != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis_coefficient * prev
    window = torch.tensor(_feature_window(cfg), dtype=torch.float32,
                          device=dev)
    frames = frames * window
    cos_b, sin_b = (torch.tensor(b, dtype=torch.float32, device=dev)
                    for b in _rdft_bases(cfg))
    re = frames @ cos_b
    im = frames @ sin_b
    spec = re * re + im * im
    if not cfg.use_power:
        spec = torch.sqrt(spec)
    mel = torch.tensor(mel_banks(cfg).T, dtype=torch.float32, device=dev)
    feats = spec @ mel
    if cfg.use_log_fbank:
        feats = torch.log(torch.clamp(feats, min=_FLT_EPS))
    feat_len = torch.clamp(fbank_num_frames(wav_len.to(dev), cfg), max=F)
    valid = torch.arange(F, device=dev)[None, :] < feat_len[:, None]
    return torch.where(valid[..., None], feats, 0.0), feat_len


def peak_normalize(wav: torch.Tensor) -> torch.Tensor:
    """Per-utterance peak normalization (the reference's ``norm``); zero
    padding does not change max|x|, so padded batches are safe."""
    peak = wav.abs().amax(dim=-1, keepdim=True)
    return wav / (peak + 1e-9)
