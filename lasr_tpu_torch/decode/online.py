"""Chunk-incremental streaming recognition (counterpart of the serving
path of ``lasr_tpu/decode/online.py``).

``StreamingRecognizer`` feeds raw samples through an
``E2E_Transformer_CTC_Online`` model one encoder chunk at a time: the
log-mel fbank runs over only the new frames' sample region (a frame
depends on its own 400-sample window alone), each ready chunk goes
through ``ChunkEncoder.encode_chunk`` against the carried memories
(whose sequence equals the batch forward) and the CTC head, and greedy
CTC tokens are committed as they come.  Device results are harvested one
chunk behind the dispatch front, so a mid-stream call only waits for a
chunk the card has had a chunk's worth of audio to finish.

With a ``beam_decoder`` (a ``CTCAttBeamDecoder(online=True)``) every
``beam_interval`` chunks the encoder states so far are searched: by
default (``beam_incremental=True``) through an ``IncrementalBeamSession``,
which keeps the search's state on the decoder's device and extends it
over only the frames that arrived since the last refresh, so the prefix
is never decoded again; with ``beam_incremental=False`` from scratch (the
reference's ``decode_feat_online`` on the audio prefix, the hypothesis
length capped at ``beam_maxlen_ratio`` of the frames).  ``finalize``
returns the full search over the stream, which both modes give.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from lasr_tpu_torch.ops.fbank import KaldiFbankConfig, log_mel_fbank


class ServingEngine:
    """The eval-mode model and the fbank config one server shares across
    its streams (nothing is compiled: the JAX engine's jits have no
    counterpart).  A recognizer given an engine must serve the engine's
    own model."""

    def __init__(self, model, cfg: KaldiFbankConfig):
        self.model = model.eval()
        self.cfg = cfg


class IncrementalBeamSession:
    """The resumable online joint beam search of one stream.

    Wraps a ``CTCAttBeamDecoder(online=True)``: the search state lives on
    the decoder's device between refreshes, and each ``refresh`` extends
    it over only the new encoder frames, then runs token steps until the
    frame horizon pauses the search (``CTCAttBeamDecoder._resume``).
    ``refresh(..., final=True)`` completes it: the from-scratch search
    over the whole stream's states.  A refresh costs the steps its new
    frames allow over the frames so far, where the from-scratch refresh
    re-runs every step.  The frames are padded to a multiple of
    ``bucket`` (``Lmax`` = that + 2), so the partials equal
    ``lasr_tpu``'s at the same refresh points."""

    def __init__(self, decoder, bucket: int = 64):
        if not decoder.online:
            raise ValueError("IncrementalBeamSession needs online=True")
        if decoder.maxlenratio != 0.0 or decoder.minlenratio != 0.0:
            raise ValueError(
                "incremental search supports maxlenratio == minlenratio "
                "== 0 only (their row caps need the final length, which "
                "is unknown mid-stream)")
        self.decoder = decoder
        self.bucket = max(1, bucket)
        self._state = None
        self._n = 0

    def reset(self):
        self._state = None
        self._n = 0

    @torch.no_grad()
    def refresh(self, hs: torch.Tensor, final: bool = False):
        """``hs``: (T, D) every encoder state of the stream so far (only
        the frames past the previous refresh are new).  Returns (token ids
        with sos (and eos when ended), score, from a live hypothesis)
        mid-stream, or the ``BeamHypotheses`` at ``final``."""
        dec = self.decoder
        n_new, D = hs.shape
        Tb = max(self.bucket, -(-n_new // self.bucket) * self.bucket)
        hs_pad = hs.new_zeros(1, Tb, D, device=dec.device)
        hs_pad[0, :n_new] = hs
        if self._state is None:
            K = dec.beam
            self._state = dec._init_state(
                1, K, 2 * K, Tb + 2,
                torch.zeros(1, Tb, dec.blank + 1, device=dec.device),
                track_bands=True)
        self._state, out = dec._resume(self._state, hs_pad, self._n, n_new,
                                       final=final)
        self._n = n_new
        if final:
            return dec._hypotheses(*out)
        tok, length, score, live = out
        return (tok[0, : int(length[0])].tolist(), float(score[0]),
                bool(live[0]))


class StreamingRecognizer:
    """Greedy streaming CTC recognizer over an E2E_Transformer_CTC_Online
    model (one utterance per instance), on the model's device."""

    def __init__(self, model, tokenizer=None, blank: int = 0,
                 fbank: Optional[KaldiFbankConfig] = None,
                 peak_norm_fallback: float = 1.0,
                 beam_decoder=None, beam_interval: int = 4,
                 beam_bucket: int = 64, beam_maxlen_ratio: float = 0.5,
                 beam_incremental: bool = True,
                 engine: Optional[ServingEngine] = None):
        if engine is None:
            engine = ServingEngine(model, fbank or KaldiFbankConfig())
        elif engine.model is not model:
            raise ValueError("engine was built for a different model")
        self.model = engine.model
        self.cfg = engine.cfg
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.blank = blank
        self.cur = model.encoder_center_chunk
        self.chunk_frames = self.cur + model.encoder_right_chunk + 6
        self.idim = model.idim
        # peak normalization needs the whole utterance; a fixed gain
        # stands in for it
        self.gain = peak_norm_fallback
        self.beam_decoder = beam_decoder
        self.beam_interval = max(1, beam_interval)
        self.beam_bucket = beam_bucket
        self.beam_maxlen_ratio = beam_maxlen_ratio
        self.beam_session = None
        if beam_decoder is not None and beam_incremental:
            self.beam_session = IncrementalBeamSession(beam_decoder,
                                                       bucket=beam_bucket)
        self._hs: List[torch.Tensor] = []     # per-chunk (cur/4, D) states
        self._lpz: List[torch.Tensor] = []    # per-chunk (cur/4, V) log-probs
        self._beam_tokens: Optional[List[int]] = None
        self._greedy_since_beam: List[int] = []
        self._samples = np.zeros(0, np.float32)
        self._sample_off = 0          # absolute index of _samples[0]
        self._frames = np.zeros((0, self.idim), np.float32)
        self._n_frames_done = 0
        self._chunk_idx = 0
        self._mems = None
        self._tokens: List[int] = []
        self._prev_emit = blank
        self._pending = None
        self._n_harvested = 0

    @torch.no_grad()
    def accept_waveform(self, samples: np.ndarray) -> List[int]:
        """Feed new samples; returns the tokens newly committed."""
        self._samples = np.concatenate(
            [self._samples, np.asarray(samples, np.float32) * self.gain])
        # frame i reads samples [160i, 160i+400): only the new frames'
        # region goes through the fbank
        sh, ws = self.cfg.window_shift, self.cfg.window_size
        total = max(0, 1 + (self._sample_off + len(self._samples) - ws)
                    // sh)
        if total > self._n_frames_done:
            lo = self._n_frames_done * sh - self._sample_off
            hi = (total - 1) * sh + ws - self._sample_off
            region = torch.from_numpy(self._samples[lo:hi]).to(self.device)
            feats, _ = log_mel_fbank(
                region[None], torch.tensor([len(region)], device=self.device),
                self.cfg)
            self._frames = np.concatenate(
                [self._frames, feats[0].cpu().numpy()])
            self._n_frames_done = total
            # drop samples no future frame reads
            consumed = total * sh - self._sample_off
            if consumed > 0:
                self._samples = self._samples[consumed:]
                self._sample_off += consumed
        return self._drain_chunks()

    def _drain_chunks(self, final: bool = False) -> List[int]:
        """Dispatch every ready chunk, harvesting each chunk's results when
        the next one has been dispatched; ``final`` dispatches the
        zero-padded tail and drains."""
        new_tokens: List[int] = []
        while True:
            start = self._chunk_idx * self.cur
            end = start + self.chunk_frames
            if end > len(self._frames) and not (
                    final and start < len(self._frames)):
                break
            avail = self._frames[start: min(end, len(self._frames))]
            chunk = np.zeros((1, self.chunk_frames, self.idim), np.float32)
            chunk[0, : len(avail)] = avail
            enc = self.model.encoder
            if self._mems is None:
                self._mems = enc.init_stream_state(1)
            # keys past the stream's end are masked only at finalize
            # (mid-stream, a chunk is covered by audio)
            n_valid = len(self._frames) if final else end
            hs, self._mems = enc.encode_chunk(
                torch.from_numpy(chunk).to(self.device), self._chunk_idx,
                self._mems, torch.tensor([n_valid], device=self.device))
            logits = self.model.ctc_logits(hs)
            self._chunk_idx += 1
            n_out = min(self.cur // 4, max(0, (len(avail) + 3) // 4))
            if self._pending is not None:
                new_tokens += self._harvest(*self._pending, draining=final)
            self._pending = (logits, hs, n_out)
        if final and self._pending is not None:
            new_tokens += self._harvest(*self._pending, draining=True)
            self._pending = None
        self._tokens.extend(new_tokens)
        return new_tokens

    def _harvest(self, logits, hs, n_out: int,
                 draining: bool = False) -> List[int]:
        if self.beam_decoder is not None and n_out > 0:
            # the beam keeps every frame of every chunk (the reference
            # decoder's convention, tail conv margin included); greedy
            # emission below stays on the n_out real-audio frames
            n_ref = self.cur // 4
            self._hs.append(hs[0, :n_ref])
            if self.beam_session is None:
                self._lpz.append(torch.log_softmax(
                    logits[0, :n_ref].float(), dim=-1))
        toks: List[int] = []
        for t in logits[0].argmax(dim=-1)[:n_out].tolist():
            if t != self._prev_emit and t != self.blank:
                toks.append(t)
            self._prev_emit = t
        if self.beam_decoder is not None:
            self._greedy_since_beam += toks
        self._n_harvested += 1
        # no mid-stream search while finalize drains: its full search
        # follows
        if self.beam_decoder is not None and not draining and \
                self._n_harvested % self.beam_interval == 0:
            if self.beam_session is not None:
                self._beam_tokens = self._refresh_incremental()
            else:
                self._beam_tokens = self._run_beam(final=False)
            self._greedy_since_beam = []
        return toks

    def _refresh_incremental(self) -> Optional[List[int]]:
        """A mid-stream refresh of the persisted search over the new
        chunks' states."""
        if not self._hs:
            return None
        toks, _, live = self.beam_session.refresh(torch.cat(self._hs))
        if len(toks) <= 1:
            return None
        # a live prefix carries sos only, an ended hypothesis sos...eos
        return toks[1:] if live else toks[1:-1]

    def _run_beam(self, final: bool = True) -> Optional[List[int]]:
        """The online beam search over the encoder states so far, padded
        to a ``beam_bucket`` multiple of frames as the JAX recognizer pads
        them (the bucket sets the partials' length cap)."""
        if not self._hs:
            return None
        hs = torch.cat(self._hs)
        T, D = hs.shape
        Tb = -(-T // self.beam_bucket) * self.beam_bucket
        hs_pad = hs.new_zeros(1, Tb, D)
        hs_pad[0, :T] = hs
        cat = torch.cat(self._lpz)
        lpz = cat.new_zeros(1, Tb, cat.shape[-1])   # the search masks the pad
        lpz[0, :T] = cat
        max_len = Tb if final else max(8, int(Tb * self.beam_maxlen_ratio))
        hyps = self.beam_decoder.search(
            hs_pad, torch.tensor([T], device=self.device), lpz, max_len)
        if int(hyps.lengths[0, 0]) <= 0:
            return None
        return hyps.best_ids(0)

    def partial_result(self) -> Tuple[List[int], str]:
        """The last beam search's tokens with the greedy tokens committed
        since appended, or (no beam) the greedy stream."""
        if self._beam_tokens is not None:
            toks = list(self._beam_tokens) + list(self._greedy_since_beam)
        else:
            toks = list(self._tokens)
        return toks, self._text(toks)

    @torch.no_grad()
    def finalize(self) -> Tuple[List[int], str]:
        """Flush the remaining frames; returns (tokens, text): the full
        online beam search with a ``beam_decoder``, else greedy CTC."""
        self._drain_chunks(final=True)
        tokens = list(self._tokens)
        if self.beam_decoder is not None:
            if self.beam_session is not None and self._hs:
                hyp = self.beam_session.refresh(torch.cat(self._hs),
                                                final=True)
                beam_tokens = hyp.best_ids(0) if hyp.lengths[0, 0] > 0 \
                    else None
            else:
                beam_tokens = self._run_beam()
            if beam_tokens is not None:
                tokens = beam_tokens
        return tokens, self._text(tokens)

    def _text(self, tokens) -> str:
        if self.tokenizer is None:
            return ""
        return self.tokenizer.decode(list(tokens), no_special=True)[1]
