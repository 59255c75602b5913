"""Long-form decoding (counterpart of ``lasr_tpu/decode/longform.py``):
windowed linear-compute encoding, blank-aligned segmentation, and the
same joint beam search per segment.

The offline encoder attends over the whole utterance: at an hour of audio
(T_enc ≈ 90,000) one layer's scores alone would not fit the card.  Here:

  1. the input features are split into fixed-shape windows, each a
     center of ``encoder_window_frames`` encoder frames with a halo of
     ``encoder_halo_frames`` on each side; only the centers are kept, so
     compute and memory are linear in the audio's length.  The stride-4
     conv stack is translation-equivariant, so the centers align with the
     full forward; only attention context is cut at ± halo.  Windows of
     absolute-PE models get their true positions (``pos_offset``).
     Inputs no longer than one window take the plain full forward;
  2. segments are cut at the most blank-dominated frame within
     ``window_frames`` of each multiple of ``segment_frames`` (the CTC
     blank posterior is a silence detector);
  3. each segment is padded to ``segment_frames`` (dummy rows of length
     1 fill the last batch) and decoded by the decoder's own
     ``search(..., max_len=segment_frames)``, ``segment_batch`` at a time;
  4. the token streams are concatenated.

Everything stays on the decoder's device but the blank column the cut
search reads.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from lasr_tpu_torch import resolve_device

_SUB = 4  # Conv2dSubsampling stride


def _enc_len(n_in: int) -> int:
    """Encoder frames for ``n_in`` input frames under the
    ``[:, :-2:2][:, :-2:2]`` subsampling contract."""
    return ((n_in - 1) // 2 - 1) // 2


def pick_cut_frames(blank_lp: np.ndarray, n_frames: int, segment: int,
                    window: int) -> List[int]:
    """Cut points (frame indices) near multiples of ``segment``, each at
    the max-blank-log-prob frame within ±``window``."""
    cuts = []
    pos = segment
    while pos < n_frames:
        lo = max(pos - window, (cuts[-1] + 1) if cuts else 1)
        hi = min(pos + window, n_frames - 1)
        if lo >= hi:
            break
        w = blank_lp[lo:hi]
        cuts.append(lo + int(np.argmax(w)))
        pos = cuts[-1] + segment
    return cuts


class LongFormCTCAttDecoder:
    """Wraps an offline ``CTCAttBeamDecoder`` for unbounded-length audio.

    ``segment_frames``: encoder frames per segment bucket (768 ≈ 30 s at
    the 25 Hz encoder rate); ``window_frames``: the search radius for a
    silence cut; ``encoder_window_frames``: one window's kept center (0:
    2 × ``segment_frames``); ``encoder_halo_frames``: attention context
    on each side (128 ≈ 5 s); ``encoder_window_batch``: windows per
    encoder call.  ``device=None`` means CUDA (raises without a GPU) and
    must be the decoder's device."""

    def __init__(self, decoder, segment_frames: int = 768,
                 window_frames: int = 125, segment_batch: int = 4,
                 encoder_window_frames: int = 0,
                 encoder_halo_frames: int = 128,
                 encoder_window_batch: int = 4, device=None):
        device = resolve_device(device)
        if device != decoder.device:
            raise ValueError(f"the long-form decoder runs on {device}, its "
                             f"beam decoder on {decoder.device}")
        if decoder.online:
            raise ValueError("long-form decoding wraps the offline search")
        if encoder_halo_frames < 1:
            # the stride-4 conv margin needs >= 1 halo frame, or each
            # window yields one center frame too few
            raise ValueError("encoder_halo_frames must be >= 1 "
                             f"(got {encoder_halo_frames})")
        self.dec = decoder
        self.device = device
        self.segment_frames = segment_frames
        self.window_frames = window_frames
        self.segment_batch = segment_batch
        self.encoder_window_frames = (encoder_window_frames
                                      or 2 * segment_frames)
        self.encoder_halo_frames = encoder_halo_frames
        self.encoder_window_batch = encoder_window_batch

    @torch.no_grad()
    def encode_windowed(self, feats, feat_len):
        """Linear-compute encoder forward in fixed-shape halo windows.

        feats: (1, T_in, D).  Returns (hs (T_enc, D'), T_enc, lpz (T_enc,
        V)) on the device: what ``dec.encode`` gives for the kept centers,
        with attention context cut at ± halo."""
        T_in = int(feat_len[0])
        W = self.encoder_window_frames * _SUB       # center, input frames
        H = self.encoder_halo_frames * _SUB         # halo, input frames
        Lw = W + 2 * H + 2                          # + conv margin (RF 7)
        x = feats[0, :T_in]
        starts = list(range(0, T_in, W))            # center starts
        WB = self.encoder_window_batch
        T_enc = _enc_len(T_in)
        hs_parts, lpz_parts = [], []
        for g in range(0, len(starts), WB):
            group = starts[g: g + WB]
            win = x.new_zeros(WB, Lw, x.shape[-1])
            win_len = torch.ones(WB, dtype=torch.int32)
            offs = torch.zeros(WB, dtype=torch.int32)
            for i, a in enumerate(group):
                lo, hi = max(0, a - H), min(T_in, a + W + H + 2)
                win[i, : hi - lo] = x[lo:hi]
                win_len[i], offs[i] = hi - lo, lo
            # per-row absolute-PE offsets in encoder frames: a window's
            # start is a multiple of _SUB, so its local frame j is global
            # frame lo / _SUB + j
            hs_w, hs_len_w, lpz_w = self.dec.encode(
                win, win_len.to(self.device),
                pos_offset=(offs // _SUB).to(self.device))
            hs_len_w = hs_len_w.cpu()
            for i, a in enumerate(group):
                j0 = (a - int(offs[i])) // _SUB
                j1 = min(j0 + self.encoder_window_frames, int(hs_len_w[i]),
                         T_enc - a // _SUB + j0)
                hs_parts.append(hs_w[i, j0:j1])
                lpz_parts.append(lpz_w[i, j0:j1])
        hs = torch.cat(hs_parts)
        lpz = torch.cat(lpz_parts)
        # the last window sees the true tail, so the lengths line up
        assert hs.shape[0] == T_enc, (hs.shape, T_enc)
        return hs, T_enc, lpz

    @torch.no_grad()
    def encode(self, feats, feat_len):
        """(hs (T, D'), T, lpz (T, V)) of one stream: windowed when it is
        longer than one window with its halos, else the full forward."""
        win_in = (self.encoder_window_frames
                  + 2 * self.encoder_halo_frames) * _SUB
        if int(feat_len[0]) > win_in:
            return self.encode_windowed(feats, feat_len)
        hs, hs_len, lpz = self.dec.encode(feats, feat_len)
        return hs[0], int(hs_len[0]), lpz[0]

    def segments(self, lpz, T: int) -> List[Tuple[int, int]]:
        """Blank-aligned [a, b) segments, hard-split at the bucket size
        where no silence was found."""
        if T <= self.segment_frames:
            segs = [(0, T)]
        else:
            blank = lpz[:T, self.dec.blank].float().cpu().numpy()
            cuts = pick_cut_frames(blank, T, self.segment_frames,
                                   self.window_frames)
            bounds = [0] + cuts + [T]
            segs = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        S = self.segment_frames
        flat: List[Tuple[int, int]] = []
        for a, b in segs:
            while b - a > S:
                flat.append((a, a + S))
                a += S
            flat.append((a, b))
        return flat

    def padded_segments(self, hs, lpz, group):
        """One search batch: (hs (B, S, D'), lens (B,), lpz (B, S, V)) of
        the segments ``group``, dummy rows of length 1 after them."""
        B, S = self.segment_batch, self.segment_frames
        V = lpz.shape[-1]
        hs_pad = hs.new_zeros(B, S, hs.shape[-1])
        lpz_pad = torch.full((B, S, V), -float(np.log(V)),
                             dtype=torch.float32, device=lpz.device)
        lens = torch.ones(B, dtype=torch.long)
        for i, (a, b) in enumerate(group):
            hs_pad[i, : b - a] = hs[a:b]
            lpz_pad[i, : b - a] = lpz[a:b]
            lens[i] = b - a
        return hs_pad, lens.to(hs.device), lpz_pad

    @torch.no_grad()
    def __call__(self, feats, feat_len) -> Tuple[List[int], List[List[int]]]:
        """feats: (1, T_in, D).  Returns (token_ids, per-segment ids)."""
        feats = torch.as_tensor(feats).to(self.device)
        feat_len = torch.as_tensor(feat_len)
        assert feats.shape[0] == 1, "long-form decodes one stream"
        hs, T, lpz = self.encode(feats, feat_len)
        segs = self.segments(lpz, T)
        all_tokens: List[int] = []
        per_seg: List[List[int]] = []
        for g in range(0, len(segs), self.segment_batch):
            group = segs[g: g + self.segment_batch]
            hyp = self.dec.search(*self.padded_segments(hs, lpz, group),
                                  max_len=self.segment_frames)
            for i in range(len(group)):
                ids = hyp.best_ids(i)
                per_seg.append(ids)
                all_tokens.extend(ids)
        return all_tokens, per_seg
