"""The CTC prefix recursion's parallel form (``parallel_scan=True``: a
doubling scan of 3x3 log-semiring products) against ``lasr_tpu``'s
``associative_scan`` form and against the port's loop over frames:

  - ``_ctc_prefix_step`` at prefix lengths 0, 1 and 3, with and without
    the per-frame scores: psi, r_new and psi_all within 1e-4 of both,
    every entry at or below LOG_ZERO exactly LOG_ZERO; scanned in
    candidate slices (the online prescreen over the whole vocabulary)
    bit for bit as in one piece;
  - every search with the flag on against the flag off: offline in
    table, A and B, online (with the full-vocabulary prescreen of
    ctc_weight 1.0 in slices), long-form, and the resumable
    ``IncrementalBeamSession`` (its final equal to the from-scratch
    search): token-exact, scores within 1e-4;
  - one offline search against ``lasr_tpu``'s with ``parallel_scan=True``
    on bridged weights: token-exact, scores within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.decode import beam as jax_beam
from lasr_tpu.models.e2e_online import E2E_Transformer_CTC_Online as JaxOnline
from lasr_tpu_torch.decode import beam
from lasr_tpu_torch.decode.beam import LOG_ZERO, CTCAttBeamDecoder
from lasr_tpu_torch.decode.longform import LongFormCTCAttDecoder
from lasr_tpu_torch.decode.online import IncrementalBeamSession
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from lasr_tpu_torch.utils.weights import flax_to_state_dict, load_model_weights
from tests.torch_port_common import (CONFIGS, ONLINE, TINY, data,
                                     seeded_variables, t)

TOL = 1e-4
BEAM = dict(beam=4, ctc_beam=5, ctc_weight=0.5, nbest=2)


def _prefix_inputs(seed=0, B=2, K=3, C=5, T=19, V=9):
    """Log-probs with the padding convention (row 1's last 5 frames:
    blank free, labels impossible), a DP state with a LOG_ZERO row and
    candidates that include the blank and each hypothesis's last token."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, V))
    lpz = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    lpz[1, T - 5:] = LOG_ZERO
    lpz[1, T - 5:, 0] = 0.0
    r_prev = (3 * rng.standard_normal((B, K, T, 2)) - 20).astype(np.float32)
    r_prev[0, 1, :, 0] = LOG_ZERO
    last = rng.integers(1, V, (B, K)).astype(np.int32)
    cand = rng.integers(0, V, (B, K, C)).astype(np.int32)
    cand[:, :, 0] = last
    cand[0, 0, 1] = 0
    return lpz, r_prev, last, cand


# the prefix length is traced (lasr_tpu's search passes its step index):
# one compile for each want_psi_all
_JAX_STEP = jax.jit(jax_beam._ctc_prefix_step,
                    static_argnames=("blank", "want_psi_all",
                                     "parallel_scan"))


def _close(got, want, what):
    """Within TOL above the floor; at or below LOG_ZERO (log 0) where
    ``want`` is, and there exactly LOG_ZERO.  (The loop adds finite terms
    to LOG_ZERO, which at 1e10 moves it by multiples of 1024: still log
    0; the scans collapse every sum at the floor, as lasr_tpu's do.)"""
    got, want = np.asarray(got), np.asarray(want)
    floor = want <= LOG_ZERO
    np.testing.assert_array_equal(got <= LOG_ZERO, floor, err_msg=what)
    np.testing.assert_allclose(got[~floor], want[~floor], atol=TOL, rtol=0,
                               err_msg=what)
    assert (got[got <= LOG_ZERO] == LOG_ZERO).all(), what


@pytest.mark.parametrize("want_psi_all", [False, True])
@pytest.mark.parametrize("out_len", [0, 1, 3])
def test_prefix_step_matches_lasr_tpu_and_the_loop(out_len, want_psi_all):
    inputs = _prefix_inputs()
    want = _JAX_STEP(*map(jnp.asarray, inputs), out_len=jnp.int32(out_len),
                     blank=0, want_psi_all=want_psi_all, parallel_scan=True)
    args = [t(x) for x in inputs] + [out_len, 0]
    got = beam._ctc_prefix_step(*args, want_psi_all=want_psi_all,
                                parallel_scan=True)
    loop = beam._ctc_prefix_step(*args, want_psi_all=want_psi_all)
    assert len(got) == len(loop) == (3 if want_psi_all else 2)
    for name, g, w, s in zip(("psi", "r_new", "psi_all"), got, want, loop):
        _close(g, w, f"{name} vs lasr_tpu")
        _close(g, s, f"{name} vs the loop")


def test_prefix_step_in_candidate_slices(monkeypatch):
    """Slicing the candidate axis (one candidate's worth of scan bytes)
    changes no value; past the last frame both forms return the initial
    state."""
    args = [t(x) for x in _prefix_inputs(seed=1)]
    whole = beam._ctc_prefix_step(*args, 2, 0, want_psi_all=True,
                                  parallel_scan=True)
    monkeypatch.setattr(beam, "_SCAN_BYTES", 1)
    sliced = beam._ctc_prefix_step(*args, 2, 0, want_psi_all=True,
                                   parallel_scan=True)
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)
    T = args[0].shape[1]
    for a, b in zip(beam._ctc_prefix_step(*args, T, 0, parallel_scan=True),
                    beam._ctc_prefix_step(*args, T, 0)):
        assert torch.equal(a, b)


def _port(jax_cls, port_cls, kw, seed, x, xlen, ys, ctc_scale=1.0,
          src_bias=None):
    """(flax model, seeded variables, the port's model with the same
    weights); ``ctc_scale`` sharpens the CTC head, ``src_bias`` sets every
    ``src_att_bias`` (so online frontiers stall and endpoints advance)."""
    fm = jax_cls(**kw)
    v = seeded_variables(fm, seed, x, xlen, ys)

    def edit(path, a):
        name = jax.tree_util.keystr(path)
        if "['ctc']" in name:
            return a * ctc_scale
        if src_bias is not None and name.endswith("['src_att_bias']"):
            return np.full_like(a, src_bias)
        return a
    v = jax.tree_util.tree_map_with_path(edit, v)
    pm = port_cls(**kw, device="cpu")
    load_model_weights(pm, flax_to_state_dict(v))
    return fm, v, pm


@functools.lru_cache(maxsize=None)
def _offline(config):
    """The tiny Conformer at one block each (the search is the subject)."""
    x, xlen, ys = data(seed=4)
    kw = dict(TINY, encoder_num_blocks=1, decoder_num_block=1,
              **CONFIGS[config])
    return _port(jax_models.E2E_Conformer_CTC, E2E_Conformer_CTC, kw, 5, x,
                 xlen, ys, ctc_scale=4.0)


@functools.lru_cache(maxsize=None)
def _online():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 120, 80)).astype(np.float32)
    kw = dict(ONLINE, encoder_num_blocks=1, decoder_num_block=1)
    return _port(JaxOnline, E2E_Transformer_CTC_Online, kw, 6, x,
                 np.asarray([120], np.int32), np.ones((1, 4), np.int32),
                 ctc_scale=16.0, src_bias=2.0)


@pytest.fixture
def scans(monkeypatch):
    """Counts the calls of the parallel form (so a flag that no search
    passes on fails the tests)."""
    calls = [0]
    fn = beam._ctc_prefix_parallel

    def counted(*args):
        calls[0] += 1
        return fn(*args)
    monkeypatch.setattr(beam, "_ctc_prefix_parallel", counted)
    return calls


def _feats(seed, T=61, D=20):
    x = np.random.default_rng(seed).standard_normal((2, T, D))
    return x.astype(np.float32), np.asarray([T, T - 18], np.int32)


def _same(got, want, atol=TOL):
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.scores, want.scores, atol=atol, rtol=0)


@pytest.mark.parametrize("config", ["plain", "A", "B"])
def test_offline_search_flag_on_equals_off(config, scans):
    pm = _offline(config)[2]
    x, xlen = _feats(7)
    off = CTCAttBeamDecoder(pm, device="cpu", **BEAM)
    assert off.parallel_scan is False
    on = CTCAttBeamDecoder(pm, parallel_scan=True, device="cpu", **BEAM)
    want = off(x, xlen)
    assert scans[0] == 0
    _same(on(x, xlen), want)
    assert scans[0] > 0
    assert max(len(want.best_ids(b)) for b in range(2)) >= 2


@pytest.mark.parametrize("ctc_weight", [0.5, 1.0])
def test_online_search_flag_on_equals_off(ctc_weight, monkeypatch, scans):
    """ctc_weight 1.0 prescreens the whole vocabulary (C = V), scanned in
    slices here."""
    pm = _online()[2]
    x = np.random.default_rng(8).standard_normal((1, 100, 80))
    x, xlen = x.astype(np.float32), np.asarray([100], np.int32)
    kw = dict(BEAM, online=True, ctc_weight=ctc_weight, device="cpu")
    want = CTCAttBeamDecoder(pm, **kw)(x, xlen)
    if ctc_weight == 1.0:
        monkeypatch.setattr(beam, "_SCAN_BYTES", 1 << 16)
    _same(CTCAttBeamDecoder(pm, parallel_scan=True, **kw)(x, xlen), want)
    # ctc_weight 1.0: 11 candidates in slices of 6
    assert scans[0] >= (2 * want.lengths.max() - 4 if ctc_weight == 1.0
                        else want.lengths.max() - 2) > 0


def test_longform_flag_on_equals_off(scans):
    pm = _offline("plain")[2]
    x = np.random.default_rng(9).standard_normal((1, 220, 20))
    x, xlen = x.astype(np.float32), np.asarray([220], np.int32)
    lf = dict(segment_frames=24, window_frames=6, segment_batch=4,
              encoder_window_frames=16, encoder_halo_frames=4,
              encoder_window_batch=4, device="cpu")
    off, on = (LongFormCTCAttDecoder(CTCAttBeamDecoder(
        pm, parallel_scan=flag, device="cpu", **BEAM), **lf)
        for flag in (False, True))
    want = off(x, xlen)
    assert scans[0] == 0
    assert on(x, xlen) == want and len(want[1]) >= 2
    assert scans[0] > 0
    # the scores of one search call over the first group of segments
    hs, T, lpz = off.encode(torch.from_numpy(x), torch.from_numpy(xlen))
    group = off.segments(lpz, T)[:4]
    _same(on.dec.search(*on.padded_segments(hs, lpz, group), max_len=24),
          off.dec.search(*off.padded_segments(hs, lpz, group), max_len=24))


def test_incremental_session_flag_on_equals_off(scans):
    """Mid-stream refreshes, the final and the from-scratch search, each
    with the flag on against off."""
    pm = _online()[2]
    dec = {flag: CTCAttBeamDecoder(pm, online=True, parallel_scan=flag,
                                   device="cpu", **BEAM)
           for flag in (False, True)}
    feats = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (1, 120, 80)).astype(np.float32))
    hs, hs_len, _ = dec[False].encode(feats, torch.tensor([120]))
    hs = hs[:, : int(hs_len[0])]
    T = hs.shape[1]
    sessions = {f: IncrementalBeamSession(d, bucket=32)
                for f, d in dec.items()}
    steps = []
    for n in (int(0.35 * T), int(0.7 * T)):
        (w_tok, w_score, w_live), (g_tok, g_score, g_live) = (
            sessions[f].refresh(hs[0, :n]) for f in (False, True))
        assert (g_tok, g_live) == (w_tok, w_live)
        np.testing.assert_allclose(g_score, w_score, atol=TOL)
        steps.append(sessions[True]._state["i"])
    assert steps[-1] > 0 and scans[0] >= steps[-1]
    finals = {f: s.refresh(hs[0], final=True) for f, s in sessions.items()}
    _same(finals[True], finals[False])
    lpz = torch.log_softmax(pm.ctc_logits(hs).float(), dim=-1)
    with torch.no_grad():
        scratch = dec[True].search(hs, torch.tensor([T]), lpz, T)
    _same(finals[True], scratch)


def test_offline_search_matches_lasr_tpu_parallel_scan(scans):
    fm, v, pm = _offline("B")
    x, xlen = _feats(11)
    kw = dict(BEAM, parallel_scan=True)
    want = jax_beam.CTCAttBeamDecoder(fm, v, **kw)(x, xlen)
    got = CTCAttBeamDecoder(pm, device="cpu", **kw)(x, xlen)
    _same(got, want, atol=1e-3)
    assert scans[0] > 0 and max(len(got.best_ids(b)) for b in range(2)) >= 2
