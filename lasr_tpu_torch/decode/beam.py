"""Joint CTC/attention beam search, batched with fixed-shape state
(counterpart of ``lasr_tpu/decode/beam.py``).

The whole batch of beams advances one token per step:
  - hypothesis state is fixed-shape tensors (tokens [B,K,Lmax], scores
    [B,K], CTC prefix DP state r^n/r^b [B,K,T,2], per-layer decoder KV
    caches);
  - each step: one cached decoder call for all B·K hyps → top-``ctc_beam``
    attention candidates (blank excluded) → the CTC prefix recursion over
    the frames for all B·K·C candidates → joint rescoring
    ``(1-λ)·att + λ·Δctc`` → global top-K with eos-splitting into a
    fixed ended pool;
  - Hybrid CTC/attention end detection (Watanabe Eq. 50) per utterance
    from a best-score-by-length table.

``online=True`` is the reference's streaming decode (``ctc_att_online``):
the model's chunked encoder under the reference's length convention
(``ref_tail``), the online decoder step whose monotonic-attention
endpoints ride the cache per beam slot and chain across same-parent
siblings (``decoder_step_ep``), the attention prescreen over the full
vocabulary (blank included), truncated CTC scoring (each hypothesis
carries a frontier, the first frame at or after its parent's where no
candidate's prefix score improves; candidates are read there),
online end detection, and a final rescore of ended hypotheses whose
frontier stopped short of the utterance (``w·ctc_full + att``, the length
bonus dropped).

Shallow RNNLM fusion (``lm``, ``lm_weight``): one LM step over the B·K
hypotheses' last tokens each token step, its log-softmax (f32) at each
candidate added as ``lm_weight·lm`` to the attention part of the joint
score; the candidate prescreen stays attention-only, and the LM state is
reordered by parent with the KV cache.  ``nbest`` hypotheses come back
from the ended pool, best first.

The CTC prefix recursion is a loop over the frames by default (the JAX
package's default too).  ``parallel_scan=True`` evaluates the same
recursion as a doubling scan of 3x3 log-semiring products, about
log2(T) batched steps in place of T (``_ctc_prefix_parallel``).  The
step index is a host integer here, so the frames before the prefix
length, which the JAX scan masks, are simply not visited in either form.

Ties: every top-k is a stable descending sort, so among equal scores the
lower index wins — the rule of ``lax.top_k``.  Entries at ``LOG_ZERO`` tie
often, and the order decides which hypotheses fill the pools.

The search is a state dict and a step over it (``_init_state``,
``_make_step``), driven from the host until every row is done.  The
online search also resumes: ``decode.online.IncrementalBeamSession``
persists its state between partial refreshes of a stream and extends it
over only the new frames (``_resume``); its final result equals the
from-scratch search over the whole stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from lasr_tpu_torch import resolve_device
from lasr_tpu_torch.modules.rnn import select_state

LOG_ZERO = -1e10
D_END = -10.0
M_END = 3


@dataclass
class BeamHypotheses:
    """Host-side decode result for one batch."""
    tokens: np.ndarray   # (B, nbest, Lmax) incl. sos/eos, -1 padded
    lengths: np.ndarray  # (B, nbest)
    scores: np.ndarray   # (B, nbest)

    def best_ids(self, b: int, strip: bool = True) -> List[int]:
        n = int(self.lengths[b, 0])
        seq = self.tokens[b, 0, :n].tolist()
        return seq[1:-1] if strip else seq

    def nbest_ids(self, b: int, strip: bool = True):
        """[(token_ids, score)] for utterance ``b``, best first; empty
        pool entries (LOG_ZERO scores) are dropped."""
        out = []
        for k in range(self.tokens.shape[1]):
            n = int(self.lengths[b, k])
            if n <= 0 or self.scores[b, k] <= LOG_ZERO / 2:
                continue
            seq = self.tokens[b, k, :n].tolist()
            out.append((seq[1:-1] if strip else seq, float(self.scores[b, k])))
        return out


def _logaddexp(a, b):
    """log(e^a + e^b) with LOG_ZERO as an absorbing floor."""
    m = torch.maximum(a, b)
    out = torch.clamp(m, min=LOG_ZERO) + torch.log1p(torch.exp(-(a - b).abs()))
    return torch.where(m <= LOG_ZERO, LOG_ZERO, out)


def _top_k(x, k: int):
    """Top-k along the last axis, lower index first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x, idx):
    """x: (B, N, ...); idx: (B, K) → (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _ctc_initial_state(lpz, blank: int):
    """(r^n, r^b) of the empty prefix: the cumulative blank path (B, T, 2)."""
    r_b = torch.cumsum(lpz[:, :, blank], dim=1)
    return torch.stack([torch.full_like(r_b, LOG_ZERO), r_b], dim=-1)


def _semimat(a, b):
    """Log-semiring (logsumexp, +) matrix product a ⊙ b over the last two
    axes: out[i, j] = LSE_k(a[i, k] + b[k, j]), with LOG_ZERO kept as an
    absorbing floor (contributions at or below it collapse exactly)."""
    s = a[..., :, :, None] + b[..., None, :, :]
    m = s.amax(dim=-2)
    m_safe = torch.clamp(m, min=LOG_ZERO)
    out = m_safe + torch.log(torch.exp(s - m_safe[..., None, :]).sum(dim=-2))
    return torch.where(m <= LOG_ZERO, LOG_ZERO, out)


# bytes of the doubling scan's largest intermediate, (frames, B, K, C, 3,
# 3, 3) float32, above which the candidates are scanned in slices (the
# online prescreen over the whole vocabulary)
_SCAN_BYTES = 1 << 28


def _ctc_prefix_parallel(xs, log_phi, blank_lp, start: int, r0_n, r0_b,
                         psi0):
    """The prefix recursion over the frames [start, T) in O(log T) depth.

    Once log_phi is known the recursion is affine in the (logsumexp, +)
    semiring: [r^n, r^b, 1]_t = M_t ⊙ [r^n, r^b, 1]_{t-1} with
    M_t = [[x_t, -inf, x_t + phi_{t-1}], [blk_t, blk_t, -inf],
    [-inf, -inf, 0]], so every frame's state comes from the cumulative
    products P_t = M_t ⊙ … ⊙ M_start, taken by a doubling scan
    (ceil(log2(T - start)) batched products, composed as ``lasr_tpu``'s
    ``_semimat(later, earlier)``); psi is psi0 ⊕ the cumulative log-add
    of phi_{t-1} + x_t.  Frames before ``start`` keep (r0_n, r0_b, psi0),
    as the loop's repeated initial values and the JAX scan's identity
    matrices give them.  Returns (rn, rb, psi) over all T frames, each
    (B, K, C, T)."""
    T = xs.shape[-1]
    x_t = xs[..., start:].movedim(-1, 0)                    # (n, B, K, C)
    phi = log_phi[..., start - 1:T - 1].movedim(-1, 0)
    blk = blank_lp[:, start:].T[:, :, None, None].expand_as(x_t)
    lz = torch.full_like(x_t, LOG_ZERO)
    P = torch.stack([torch.stack([x_t, lz, x_t + phi], dim=-1),
                     torch.stack([blk, blk, lz], dim=-1),
                     torch.stack([lz, lz, torch.zeros_like(x_t)], dim=-1)],
                    dim=-2)                                 # (n, ..., 3, 3)
    d = 1
    while d < P.shape[0]:
        P = torch.cat([P[:d], _semimat(P[d:], P[:-d])])
        d *= 2
    s0 = torch.stack([r0_n, r0_b, torch.zeros_like(r0_n)], dim=-1)
    s = _semimat(P[..., :2, :], s0[None, ..., None])[..., 0]  # (n, ..., 2)
    cum = torch.logcumsumexp(x_t + phi, dim=0)
    psi = _logaddexp(psi0, torch.where(cum <= LOG_ZERO, LOG_ZERO, cum))

    def frames(first, rest):
        return torch.cat([first[None].expand(start, *first.shape), rest]
                         ).movedim(0, -1)
    return frames(r0_n, s[..., 0]), frames(r0_b, s[..., 1]), \
        frames(psi0, psi)


def _ctc_prefix_step(lpz, r_prev, last_tok, cand, out_len: int, blank: int,
                     want_psi_all: bool = False, parallel_scan: bool = False):
    """CTC prefix scores of every (B, K, C) candidate extension.

    lpz: (B, T, V) log-probs with frames past each utterance neutralized
    (blank free, labels impossible); r_prev: (B, K, T, 2); last_tok:
    (B, K); cand: (B, K, C); out_len: current prefix length.  Returns
    (psi (B, K, C), r_new (B, K, C, T, 2)), and with ``want_psi_all`` also
    psi_all (B, K, C, T), the prefix score after each frame (the truncated
    CTC frontier rule reads it).  ``parallel_scan``: the same recursion by
    ``_ctc_prefix_parallel`` instead of the loop over frames."""
    B, T, V = lpz.shape
    K, C = cand.shape[1:]
    xs = torch.gather(lpz.transpose(1, 2), 1,
                      cand.reshape(B, K * C, 1).expand(B, K * C, T)
                      ).reshape(B, K, C, T)
    r_sum = _logaddexp(r_prev[..., 0], r_prev[..., 1])          # (B, K, T)
    if out_len == 0:
        log_phi = r_sum[:, :, None, :].expand(B, K, C, T)
    else:
        same = cand == last_tok[:, :, None]
        log_phi = torch.where(same[..., None], r_prev[:, :, None, :, 1],
                              r_sum[:, :, None, :])
    blank_lp = lpz[:, :, blank]
    start = max(out_len, 1)
    rn = xs[..., 0] if out_len == 0 else torch.full_like(xs[..., 0], LOG_ZERO)
    rb = torch.full_like(rn, LOG_ZERO)
    psi = rn
    if parallel_scan and start < T:
        step = max(1, _SCAN_BYTES // (27 * 4 * (T - start) * B * K))
        rn_all, rb_all, psi_all = (torch.cat(parts, dim=2) for parts in zip(
            *(_ctc_prefix_parallel(
                xs[:, :, c:c + step], log_phi[:, :, c:c + step], blank_lp,
                start, rn[..., c:c + step], rb[..., c:c + step],
                psi[..., c:c + step]) for c in range(0, C, step))))
        r_new = torch.stack([rn_all, rb_all], dim=-1)
        if want_psi_all:
            return psi_all[..., -1], r_new, psi_all
        return psi_all[..., -1], r_new
    rn_seq, rb_seq, psi_seq = [rn] * start, [rb] * start, [psi] * start
    for t in range(start, T):
        phi, x = log_phi[..., t - 1], xs[..., t]
        rn, rb = (_logaddexp(rn, phi) + x,
                  _logaddexp(rn, rb) + blank_lp[:, t, None, None])
        psi = _logaddexp(psi, phi + x)
        rn_seq.append(rn)
        rb_seq.append(rb)
        psi_seq.append(psi)
    r_new = torch.stack([torch.stack(rn_seq, dim=-1),
                         torch.stack(rb_seq, dim=-1)], dim=-1)
    if want_psi_all:
        return psi, r_new, torch.stack(psi_seq, dim=-1)
    return psi, r_new


class CTCAttBeamDecoder:
    """Batched joint CTC/attention beam search over a model's decode hooks.

    Constructor parameters mirror the JAX ``CTCAttBeamDecoder`` (which
    mirrors the reference ``CTC_ATT_Decoder``); the model carries its own
    weights.  ``online=True`` needs a streaming model (``encode_online``,
    ``decoder_step_ep``).  ``lm`` is an ``RNNLM`` (or its
    ``RNNCellStack``) for shallow fusion at ``lm_weight``.
    ``parallel_scan`` runs the CTC prefix recursion as a doubling scan
    (``_ctc_prefix_parallel``) in every search: offline, online,
    long-form and the resumable session's.  ``device=None`` means CUDA
    (raises without a GPU); the model and the LM are moved there."""

    def __init__(self, model, sos: int = 1, eos: int = 2, beam: int = 10,
                 ctc_beam: int = 15, nbest: int = 1, ctc_weight: float = 0.5,
                 penalty: float = 0.0, lm_weight: float = 0.0, blank: int = 0,
                 maxlenratio: float = 0.0, minlenratio: float = 0.0,
                 online: bool = False, lm=None, parallel_scan: bool = False,
                 device=None):
        if not getattr(model, "joint_beam_search", True):
            raise ValueError(
                f"{type(model).__name__} has no joint CTC/attention beam "
                f"search (lasr_tpu's decoder fails on it too): decode it "
                f"with ctc_greedy, ctc_bs, ctc_kenlm or wfst")
        if online and not hasattr(model, "encode_online"):
            raise ValueError(f"online decoding needs a streaming model; "
                             f"{type(model).__name__} has no encode_online")
        if lm_weight and lm is None:
            raise ValueError("lm_weight set but no lm provided")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        lm = getattr(lm, "module", lm)
        self.lm = None if lm is None else lm.to(self.device).eval()
        self.lm_weight = lm_weight if lm is not None else 0.0
        self.sos, self.eos, self.blank = sos, eos, blank
        self.beam, self.ctc_beam, self.nbest = beam, ctc_beam, nbest
        self.ctc_weight = ctc_weight
        self.penalty = penalty
        self.maxlenratio = maxlenratio
        self.minlenratio = minlenratio
        self.online = online
        self.parallel_scan = parallel_scan

    @torch.no_grad()
    def encode(self, feats, feat_len, pos_offset=0):
        """Decode-time encoder forward → (hs, hs_len, lpz): per-row solo
        lengths (``solo_pad``) offline, the reference decoder's length
        convention (``ref_tail``) online; the CTC log-probs are f32
        whatever the model's compute type.  ``pos_offset``: the offline
        encoder's absolute start position(s) (long-form windows)."""
        if self.online:
            hs, hs_len = self.model.encode_online(feats, feat_len,
                                                  ref_tail=True)
        else:
            hs, hs_len = self.model.encode(feats, feat_len, solo_pad=True,
                                           pos_offset=pos_offset)
        lpz = torch.log_softmax(self.model.ctc_logits(hs).float(), dim=-1)
        return hs, hs_len, lpz

    def max_len(self, T: int) -> int:
        return T if self.maxlenratio == 0.0 \
            else max(1, int(self.maxlenratio * T))

    @torch.no_grad()
    def __call__(self, feats, feat_len) -> BeamHypotheses:
        """feats: (B, T_in, D); feat_len: (B,).  Encoder + beam search."""
        feats = torch.as_tensor(feats).to(self.device)
        feat_len = torch.as_tensor(feat_len).to(self.device)
        hs, hs_len, lpz = self.encode(feats, feat_len)
        return self.search(hs, hs_len, lpz, self.max_len(hs.shape[1]))

    def _masked_lpz(self, lpz, hs_len):
        """Frames past hs_len: blank is free, labels impossible."""
        pad_t = (torch.arange(lpz.shape[1], device=lpz.device)[None, :]
                 >= hs_len[:, None])
        out = lpz.masked_fill(pad_t[:, :, None], LOG_ZERO)
        out[:, :, self.blank] = torch.where(pad_t, 0.0, lpz[:, :, self.blank])
        return out

    def _num_cand(self, V: int) -> int:
        if self.online:
            # the online prescreen spans the vocabulary, blank included
            return V if self.ctc_weight == 1.0 else min(self.ctc_beam, V)
        return min(self.ctc_beam, V - 1)


    # ---- the search: a state dict and a step over it ----

    @torch.no_grad()
    def search(self, hs, hs_len, lpz, max_len: int) -> BeamHypotheses:
        """The full search over (hs (B, T, D), hs_len (B,), lpz (B, T, V)):
        token steps until ``max_len`` or every row is done."""
        B, T, _ = hs.shape
        K = self.beam
        lpz = self._masked_lpz(lpz, hs_len)
        state = self._init_state(B, K, 2 * K, max_len + 2, lpz,
                                 track_bands=False)
        step = self._make_step(
            self._num_cand(lpz.shape[-1]), lpz,
            *self._build_memory(hs, hs_len, K), hs_len,
            torch.clamp(hs_len, max=max_len),
            # ended hyps are kept only when len(yseq) > minlen
            (self.minlenratio * hs_len).to(torch.long),
            mid_stream=False, track_bands=False)
        while state["i"] < max_len and not state["done"]:
            state = step(state)
        return self._hypotheses(*self._final_outputs(state,
                                                     band_rescore=False))

    @staticmethod
    def _hypotheses(tokens, lengths, scores) -> BeamHypotheses:
        return BeamHypotheses(tokens=tokens.cpu().numpy(),
                              lengths=lengths.cpu().numpy(),
                              scores=scores.cpu().numpy())

    def _build_memory(self, hs, hs_len, K: int):
        """Beam-expanded projected memory: K and V (layers, B·K, T, H, dk)
        and the key mask (B·K, 1, T)."""
        mem_k, mem_v = self.model.decoder_project_memory(hs)
        mem_mask = (torch.arange(hs.shape[1], device=hs.device)[None, :]
                    < hs_len[:, None])[:, None, :]
        return (mem_k.repeat_interleave(K, dim=1),
                mem_v.repeat_interleave(K, dim=1),
                mem_mask.repeat_interleave(K, dim=0))

    def _init_state(self, B: int, K: int, E: int, Lmax: int, lpz,
                    track_bands: bool) -> Dict:
        """The search state before its first step, on ``lpz``'s device.
        ``i`` (the step index) and ``done`` / ``paused`` (the loop's
        flags: every row done, the last step discarded) are host values;
        the rest are tensors.  Online state: each hypothesis's CTC
        frontier (the initial state covers one frame), its accumulated
        (1-w)·att score, the ended pool's final-rescore inputs, and each
        hypothesis's previous beam slot (the endpoint chain gathers by
        it).  ``track_bands`` adds what resumption needs: (r^n, r^b) at
        the last real frame of every ancestor prefix of each live and
        ended hypothesis (``band``, ``ended_band``, depth = prefix length
        - 1) and of the empty prefix (``rb_empty``)."""
        dev = lpz.device
        T = lpz.shape[1]

        def full(shape, value, dtype=torch.float32):
            return torch.full(shape, value, dtype=dtype, device=dev)

        tokens = full((B, K, Lmax), -1, torch.long)
        tokens[:, :, 0] = self.sos
        alive = full((B, K), False, torch.bool)
        alive[:, 0] = True
        state = {
            "i": 0, "done": False, "paused": False,
            "tokens": tokens,
            "score": torch.where(torch.arange(K, device=dev) == 0, 0.0,
                                 LOG_ZERO)[None].expand(B, K).clone(),
            "ctc_prev": full((B, K), 0.0),
            "r": _ctc_initial_state(lpz, self.blank)[:, None].expand(
                B, K, T, 2),
            "last_tok": full((B, K), self.sos, torch.long),
            "alive": alive,
            "cache": self.model.decoder_init_cache(B * K, Lmax),
            "ended_score": full((B, E), LOG_ZERO),
            "ended_len": full((B, E), 0, torch.long),
            "ended_tok": full((B, E, Lmax), -1, torch.long),
            "best_by_len": full((B, Lmax + 2), LOG_ZERO),
            "row_done": full((B,), False, torch.bool),
            "frontier": full((B, K), 1, torch.long),
            "att_lm": full((B, K), 0.0),
            "ended_att_lm": full((B, E), 0.0),
            "ended_rescore": full((B, E), 0.0),
            "ended_need": full((B, E), False, torch.bool),
            "parent_prev": full((B, K), 0, torch.long),
            "lm": None if self.lm is None else self.lm.zero_state(B * K),
        }
        if track_bands:
            state["band"] = full((B, K, Lmax, 2), LOG_ZERO)
            state["ended_band"] = full((B, E, Lmax, 2), LOG_ZERO)
            state["rb_empty"] = full((B,), 0.0)
        return state

    def _make_step(self, C: int, lpz, mem_k, mem_v, mem_mask, hs_len,
                   row_maxlen, row_minlen, *, mid_stream: bool,
                   track_bands: bool):
        """The token step ``state → state``.

        ``mid_stream`` (a resumable refresh; online only) discards a step
        whose reads could depend on frames past the horizon ``hs_len``
        and returns the old state with ``paused`` set: a live
        hypothesis's CTC frontier found no genuine (improvement-based)
        stall below the horizon, its monotonic endpoint advance found no
        candidate among the visible keys, or the token count caught up
        with the frames.  Every committed step then equals the full
        search's, since the DP and the frontier and endpoint rules are
        causal in the frame axis.  End detection is off mid-stream (it
        cannot fire in the full search before the frontiers reach the
        true length).  ``track_bands`` maintains the ancestor bands.

        The decoder step writes its keys and values into the cache at
        position ``i`` in place; a discarded step leaves that write
        behind, which is harmless: its re-run writes position ``i``
        before any step reads it."""
        assert not mid_stream or self.online, \
            "mid-stream (resumable) stepping needs the online search"
        B, T, V = lpz.shape
        K = self.beam
        E = 2 * K
        dev = lpz.device
        rows = torch.arange(B, device=dev)[:, None]
        online, w = self.online, self.ctc_weight
        t_rng = torch.arange(1, T, device=dev)
        last_real = torch.clamp(hs_len - 1, min=0)

        def step(state):
            i = state["i"]
            tokens, score, alive = (state["tokens"], state["score"],
                                    state["alive"])
            ctc_prev, r, last_tok = (state["ctc_prev"], state["r"],
                                     state["last_tok"])
            row_done, frontier = state["row_done"], state["frontier"]
            # the online step replaces the cache's "ep": keep the caller's
            # dict as it is
            cache = dict(state["cache"])
            if online:
                logp, cache, ep_stall = self.model.decoder_step_ep(
                    last_tok.reshape(B * K), i, cache, mem_k, mem_v,
                    mem_mask, state["parent_prev"], alive)
            else:
                logp, cache = self.model.decoder_step(
                    last_tok.reshape(B * K), i, cache, mem_k, mem_v,
                    mem_mask)
            att_logp = logp.reshape(B, K, V).float()
            lm_state = state["lm"]
            if self.lm is not None:
                lm_state, lm_logits = self.lm(lm_state,
                                              last_tok.reshape(B * K))
                lm_logp = torch.log_softmax(lm_logits.float(), dim=-1
                                            ).reshape(B, K, V)
            if online:
                cand_att, cand_ids = _top_k(att_logp, C)
            else:
                # the offline prescreen excludes the blank row
                att_nb = att_logp.clone()
                att_nb[:, :, self.blank] = LOG_ZERO
                cand_att, cand_ids = _top_k(att_nb, C)           # (B, K, C)

            out = _ctc_prefix_step(lpz, r, last_tok, cand_ids, i,
                                   self.blank, want_psi_all=online,
                                   parallel_scan=self.parallel_scan)
            psi, r_cand = out[:2]
            r_sum = _logaddexp(r[..., 0], r[..., 1])             # (B, K, T)
            if online:
                # frontier: the first frame t >= the parent's frontier where
                # no candidate's prefix score improves; frames past hs_len
                # stall by construction
                psi_all = out[2]
                imp_stall = ~(psi_all[..., 1:] - psi_all[..., :-1] > 0.0
                              ).any(dim=2)
                at_front = t_rng >= frontier[..., None]
                valid = (imp_stall | (t_rng >= hs_len[:, None, None])) \
                    & at_front                                   # (B,K,T-1)
                end = torch.where(valid.any(dim=-1),
                                  valid.to(torch.uint8).argmax(dim=-1) + 1, T)
                # candidates are read at the frontier; eos scores the
                # prefix's complete-sequence probability there
                psi = torch.gather(psi_all, 3, (end - 1)[..., None, None]
                                   .expand(B, K, C, 1))[..., 0]
                eos_score = torch.gather(
                    r_sum, 2, torch.clamp(end, max=T - 1)[..., None])[..., 0]
            else:
                eos_score = r_sum[..., -1]
            # eos scores the prefix's complete-sequence CTC probability
            psi = torch.where(cand_ids == self.eos, eos_score[..., None], psi)

            # the attention (+LM) part of the joint score; the online
            # enders keep it as their att_lm score
            cand_attlm = (1.0 - w) * cand_att
            if self.lm is not None:
                cand_attlm = cand_attlm + self.lm_weight * torch.gather(
                    lm_logp, 2, cand_ids)
            joint = cand_attlm + w * (psi - ctc_prev[..., None])
            total = torch.where(alive[..., None], score[..., None] + joint,
                                LOG_ZERO)
            top_score, top_idx = _top_k(total.reshape(B, K * C), K)
            parent = torch.div(top_idx, C, rounding_mode="floor")
            sel_tok = torch.gather(cand_ids.reshape(B, K * C), 1, top_idx)

            new_tokens = _gather_rows(tokens, parent)
            new_tokens[:, :, i + 1] = sel_tok
            new_ctc_prev = torch.gather(psi.reshape(B, K * C), 1, top_idx)
            new_r = _gather_rows(r_cand.reshape(B, K * C, T, 2), top_idx)
            ok = (torch.gather(alive, 1, parent)
                  & (top_score > LOG_ZERO / 2) & ~row_done[:, None])
            new_frontier, new_att_lm = frontier, state["att_lm"]
            if online:
                # children inherit the parent's frontier; att_lm
                # accumulates the attention part of each selected token
                new_frontier = torch.gather(end, 1, parent)
                new_att_lm = torch.gather(new_att_lm, 1, parent) \
                    + torch.gather(cand_attlm.reshape(B, K * C), 1, top_idx)

            hyp_len = i + 2                   # len(yseq) incl. sos + token
            is_eos = ((sel_tok == self.eos) & ok
                      & (hyp_len > row_minlen[:, None]))
            bonus = float(i + 1) * self.penalty
            survive = ok & ~is_eos
            final_step = (i == row_maxlen - 1)[:, None]
            # final-step free eos appended to the survivors
            forced = survive & final_step
            new_tokens[:, :, i + 2] = torch.where(forced, self.eos,
                                                  new_tokens[:, :, i + 2])

            # pool insertion: natural enders at len i+2, forced at i+3
            nat_score = torch.where(is_eos, top_score + bonus, LOG_ZERO)
            frc_score = torch.where(forced, top_score + bonus, LOG_ZERO)
            pool_score = torch.cat([state["ended_score"], nat_score,
                                    frc_score], 1)
            pool_len = torch.cat(
                [state["ended_len"],
                 torch.full((B, K), hyp_len, dtype=torch.long, device=dev),
                 torch.full((B, K), hyp_len + 1, dtype=torch.long,
                            device=dev)], 1)
            pool_tok = torch.cat([state["ended_tok"], new_tokens,
                                  new_tokens], 1)
            ended_score, keep_idx = _top_k(pool_score, E)
            new = dict(state, ended_score=ended_score,
                       ended_len=torch.gather(pool_len, 1, keep_idx),
                       ended_tok=_gather_rows(pool_tok, keep_idx))
            if online:
                # rescore inputs of enders whose frontier stopped short of
                # hs_len: the full-length complete-sequence CTC probability
                # of the parent prefix (natural eos) or the child (forced)
                need = new_frontier < hs_len[:, None]
                pool = (torch.cat([state["ended_att_lm"], new_att_lm,
                                   new_att_lm], 1),
                        torch.cat([state["ended_rescore"],
                                   torch.gather(r_sum[..., -1], 1, parent),
                                   _logaddexp(new_r[..., -1, 0],
                                              new_r[..., -1, 1])], 1),
                        torch.cat([state["ended_need"], need & is_eos,
                                   need & forced], 1))
                (new["ended_att_lm"], new["ended_rescore"],
                 new["ended_need"]) = (torch.gather(x, 1, keep_idx)
                                       for x in pool)
            if track_bands:
                # a child's band is its parent's plus its own (r^n, r^b)
                # at the last real frame; a natural eos ender's CTC prefix
                # is its parent's (eos consumes no frames), a forced
                # ender's the child's
                parent_band = _gather_rows(state["band"], parent)
                child_band = parent_band.clone()
                child_band[:, :, i] = torch.gather(
                    new_r, 2, last_real[:, None, None, None].expand(
                        B, K, 1, 2))[:, :, 0]
                new["band"] = child_band
                new["ended_band"] = _gather_rows(
                    torch.cat([state["ended_band"], parent_band,
                               child_band], 1), keep_idx)

            best_by_len = state["best_by_len"].clone()
            best_by_len[:, hyp_len] = torch.maximum(
                best_by_len[:, hyp_len], nat_score.max(dim=1).values)
            best_by_len[:, hyp_len + 1] = torch.maximum(
                best_by_len[:, hyp_len + 1], frc_score.max(dim=1).values)

            new_alive = survive & ~final_step
            # the online endpoints stay per beam slot (the next step's
            # chain gathers them by parent)
            flat_parent = (parent + rows * K).reshape(-1)
            cache = {k: v if k == "ep" else v.index_select(1, flat_parent)
                     for k, v in cache.items()}
            if self.lm is not None:
                lm_state = select_state(lm_state, flat_parent)

            if online:
                # every live hypothesis's frontier reached hs_len, and the
                # longest ended length scores D_end below the best ended
                # hypothesis at each of the M previous lengths
                long_val = best_by_len[:, i + 2]
                end_detected = torch.where(
                    new_alive, new_frontier == hs_len[:, None], True
                ).all(dim=1) & (long_val > LOG_ZERO / 2)
                for m in range(M_END):
                    val = best_by_len[:, max(i + 1 - m, 0)]
                    end_detected = end_detected & (i + 1 - m >= 0) \
                        & (val > LOG_ZERO / 2) & (long_val - val < D_END)
            else:
                # Watanabe Eq. 50: M consecutive lengths below the best by
                # D_end
                best_overall = ended_score.max(dim=1).values
                end_detected = best_overall > LOG_ZERO / 2
                for m in range(M_END):
                    val = best_by_len[:, max(i - m, 0)]
                    end_detected = end_detected & (i - m >= 0) \
                        & (val > LOG_ZERO / 2) & (val - best_overall < D_END)
            if self.maxlenratio != 0.0 or mid_stream:
                end_detected = torch.zeros_like(end_detected)
            new_row_done = (row_done | end_detected | ~new_alive.any(dim=1)
                            | (i + 1 >= row_maxlen))
            new.update(
                i=i + 1, tokens=new_tokens, ctc_prev=new_ctc_prev, r=new_r,
                score=torch.where(new_alive, top_score, LOG_ZERO),
                last_tok=sel_tok, alive=new_alive, cache=cache, lm=lm_state,
                best_by_len=best_by_len, row_done=new_row_done,
                frontier=new_frontier, att_lm=new_att_lm,
                parent_prev=parent)
            if not mid_stream:
                new["done"] = bool(new_row_done.all())
                return new
            pause = (alive & (~imp_stall_below(imp_stall, frontier)
                              | ep_stall)).any() \
                | (alive.any(dim=1) & (i + 1 >= hs_len)).any()
            paused, done = torch.stack([pause, new_row_done.all()]).tolist()
            if paused:
                return dict(state, paused=True)
            new["done"] = done
            return new

        def imp_stall_below(imp_stall, frontier):
            """(B, K): a genuine stall at or after the frontier and below
            the horizon, whose place later frames cannot move."""
            return (imp_stall & (t_rng < hs_len[:, None, None])
                    & (t_rng >= frontier[..., None])).any(dim=-1)

        return step

    def _final_outputs(self, state, *, band_rescore: bool):
        """The ended pool's final rescore and the n-best: (tokens (B, nb,
        Lmax), lengths (B, nb), scores (B, nb)).  Online, an ender whose
        frontier stopped short of hs_len scores w·ctc_full + att,
        replacing its stored score (the length bonus is dropped, as the
        reference does); ``band_rescore`` takes ctc_full from the ended
        bands (a resumed search, whose stored rescore values saw only
        their refresh's frames): prefix length L = len - 2 lives at band
        depth L - 1, L == 0 being the empty prefix."""
        ended_score = state["ended_score"]
        if self.online:
            rescore = state["ended_rescore"]
            if band_rescore:
                eb = state["ended_band"]                      # (B, E, L, 2)
                depth = state["ended_len"] - 3
                rn = torch.gather(eb, 2, torch.clamp(depth, min=0)[
                    ..., None, None].expand(*depth.shape, 1, 2))[:, :, 0]
                rescore = torch.where(depth < 0, state["rb_empty"][:, None],
                                      _logaddexp(rn[..., 0], rn[..., 1]))
            ended_score = torch.where(
                state["ended_need"],
                self.ctc_weight * rescore + state["ended_att_lm"],
                ended_score)
        nb = min(self.nbest, ended_score.shape[1])
        top_score, top_idx = _top_k(ended_score, nb)
        return (_gather_rows(state["ended_tok"], top_idx),
                torch.gather(state["ended_len"], 1, top_idx), top_score)

    # ---- the resumable online search (decode.online's session)
    #
    # The state persists across refreshes and each refresh runs only the
    # steps its new frames allow.  Two mechanisms keep a resumed search
    # equal to the from-scratch search over the whole stream: the pause
    # of ``_make_step(mid_stream=True)`` (no committed step read a frame
    # past its horizon), and the ancestor bands: extending a hypothesis's
    # CTC prefix DP over new frames needs its parent's r at those frames,
    # so the whole ancestor chain, which is the CTC forward lattice of its
    # token sequence; ``_extend_state`` advances every chain together.

    def _extend_state(self, state, lpz, n_old: int, hs_len):
        """Advance every live and ended hypothesis's ancestor band over the
        frames [n_old, hs_len) and rewrite the live hypotheses' r rows
        from ``n_old`` on (the old padding tail recomputed under the new
        horizon): at each frame, (r^n, r^b) of band depth i-1, or the
        empty prefix's before the first step; past the horizon the
        free-blank padding convention of the in-step recursion,
        (LOG_ZERO, r_sum at the boundary)."""
        B, T, _ = lpz.shape
        K, i_cur = self.beam, state["i"]
        seq = torch.cat([state["tokens"][:, :, 1:],
                         state["ended_tok"][:, :, 1:]], dim=1)
        R, Lm1 = seq.shape[1:]
        seq = torch.clamp(seq, min=0)
        n_hi = max(n_old, min(T, int(hs_len.max())))
        xs = torch.gather(lpz[:, n_old:n_hi], 2, seq.reshape(B, 1, R * Lm1)
                          .expand(B, n_hi - n_old, R * Lm1)
                          ).reshape(B, n_hi - n_old, R, Lm1)
        blank_lp = lpz[:, :, self.blank]
        same_prev = torch.cat([torch.zeros_like(seq[:, :, :1],
                                                dtype=torch.bool),
                               seq[:, :, 1:] == seq[:, :, :-1]], dim=2)
        band = torch.cat([state["band"], state["ended_band"]], dim=1)
        rn, rb = band[:, :, :Lm1, 0], band[:, :, :Lm1, 1]
        rbe = state["rb_empty"]
        d = max(i_cur - 1, 0)
        floor = rn.new_full((B, R, 1), LOG_ZERO)

        def emitted(t):
            """The live rows' (r^n, r^b) at frame t, (B, K, 2)."""
            if i_cur == 0:
                live_rn = torch.full_like(rbe[:, None].expand(B, K),
                                          LOG_ZERO)
                live_rb = past_rb = rbe[:, None].expand(B, K)
            else:
                live_rn, live_rb = rn[:, :K, d], rb[:, :K, d]
                past_rb = _logaddexp(live_rn, live_rb)
            past = (t >= hs_len)[:, None]
            return torch.stack([torch.where(past, LOG_ZERO, live_rn),
                                torch.where(past, past_rb, live_rb)], dim=-1)

        rows = []
        for t in range(n_old, n_hi):
            act = (t < hs_len)[:, None, None]
            blk = blank_lp[:, t]
            rn_sh = torch.cat([floor, rn[:, :, :-1]], dim=2)
            rb_sh = torch.cat([rbe[:, None, None].expand(B, R, 1),
                               rb[:, :, :-1]], dim=2)
            phi = torch.where(same_prev, rb_sh, _logaddexp(rn_sh, rb_sh))
            rn, rb = (torch.where(act, _logaddexp(rn, phi) + xs[:, t - n_old],
                                  rn),
                      torch.where(act, _logaddexp(rn, rb) + blk[:, None, None],
                                  rb))
            rbe = torch.where(act[:, 0, 0], rbe + blk, rbe)
            rows.append(emitted(t))
        if n_hi < T:
            # past every row's horizon nothing moves: one value repeats
            rows.append(emitted(n_hi)[:, :, None].expand(B, K, T - n_hi, 2))
        r_ext = torch.cat([x if x.ndim == 4 else x[:, :, None]
                           for x in rows], dim=2)
        band = torch.cat([torch.stack([rn, rb], dim=-1),
                          floor[..., None].expand(B, R, 1, 2)], dim=2)
        return dict(state, r=torch.cat([state["r"][:, :, :n_old], r_ext],
                                       dim=2),
                    band=band[:, :K], ended_band=band[:, K:], rb_empty=rbe)

    @staticmethod
    def _pad_state(state, T: int, Lmax: int):
        """Grow a persisted state to a larger frame / length bucket."""
        def pad(x, dim, n, value):
            short = n - x.shape[dim]
            if short <= 0:
                return x
            shape = list(x.shape)
            shape[dim] = short
            return torch.cat([x, x.new_full(shape, value)], dim=dim)

        cache = dict(state["cache"])
        cache["k"] = pad(cache["k"], 2, Lmax, 0.0)
        cache["v"] = pad(cache["v"], 2, Lmax, 0.0)
        return dict(
            state, cache=cache, r=pad(state["r"], 2, T, 0.0),
            tokens=pad(state["tokens"], 2, Lmax, -1),
            ended_tok=pad(state["ended_tok"], 2, Lmax, -1),
            best_by_len=pad(state["best_by_len"], 1, Lmax + 2, LOG_ZERO),
            band=pad(state["band"], 2, Lmax, LOG_ZERO),
            ended_band=pad(state["ended_band"], 2, Lmax, LOG_ZERO))

    @torch.no_grad()
    def _resume(self, state, hs_pad, n_old: int, n_new: int, *,
                final: bool):
        """One refresh: extend the persisted state over the frames
        [n_old, n_new) of ``hs_pad`` (1, T, D) (the stream's encoder
        states so far, zero-padded to a bucket of T frames) and run token
        steps until the horizon pauses the search (mid-stream) or it
        completes (``final``).  Returns (state, outputs): mid-stream the
        best current hypothesis (tokens (B, Lmax) with sos, its length,
        score, whether it is live); at ``final`` ``_final_outputs``'s,
        band-rescored — the from-scratch search's result."""
        B, T, _ = hs_pad.shape
        K = self.beam
        hs_len = torch.full((B,), n_new, dtype=torch.long,
                            device=hs_pad.device)
        lpz = self._masked_lpz(torch.log_softmax(
            self.model.ctc_logits(hs_pad).float(), dim=-1), hs_len)
        state = self._extend_state(self._pad_state(state, T, T + 2), lpz,
                                   n_old, hs_len)
        state["paused"] = False
        row_maxlen = torch.clamp(hs_len, max=T) if final \
            else torch.full_like(hs_len, 2 ** 30)
        step = self._make_step(
            self._num_cand(lpz.shape[-1]), lpz,
            *self._build_memory(hs_pad, hs_len, K), hs_len, row_maxlen,
            (self.minlenratio * hs_len).to(torch.long),
            mid_stream=not final, track_bands=True)
        while state["i"] < T and not state["done"] and not state["paused"]:
            state = step(state)
        if final:
            return state, self._final_outputs(state, band_rescore=True)
        rows = torch.arange(B, device=hs_pad.device)
        live_score = torch.where(state["alive"], state["score"], LOG_ZERO)
        lk = live_score.argmax(dim=1)
        ek = state["ended_score"].argmax(dim=1)
        use_live = state["alive"].any(dim=1)
        return state, (
            torch.where(use_live[:, None], state["tokens"][rows, lk],
                        state["ended_tok"][rows, ek]),
            torch.where(use_live, state["i"] + 1,
                        state["ended_len"][rows, ek]),
            torch.where(use_live, live_score.max(dim=1).values,
                        state["ended_score"].max(dim=1).values),
            use_live)
