"""The port's resumable online beam search (``IncrementalBeamSession``)
against ``lasr_tpu``'s on the same weights and the same encoder states, at
test_incremental_beam.py's widths:

  - every mid-stream refresh equals ``lasr_tpu``'s at the same split
    (tokens, live flag, score within 1e-4), and the final equals both
    ``lasr_tpu``'s final and the port's from-scratch search;
  - the n-best pool survives resumption;
  - the persisted state after one refresh (the step count, the tokens,
    the ancestor bands) equals ``lasr_tpu``'s, bands within 1e-4;
  - ``StreamingRecognizer`` with ``beam_incremental=True`` gives
    ``lasr_tpu``'s incremental recognizer's partials, and finalizes as
    with ``False`` and as ``lasr_tpu``'s;
  - with RNNLM shallow fusion, the resumed search (growing its bucket)
    finalizes as the fused from-scratch search.
"""

import functools

import numpy as np
import pytest
import torch

from lasr_tpu.decode.beam import CTCAttBeamDecoder as JaxBeam
from lasr_tpu.decode.online import IncrementalBeamSession as JaxSession
from lasr_tpu.decode.online import StreamingRecognizer as JaxRecognizer
from lasr_tpu.models.e2e_online import E2E_Transformer_CTC_Online as JaxOnline
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.decode.online import (IncrementalBeamSession,
                                          StreamingRecognizer)
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from tests.torch_port_common import ONLINE, pair
from tests.test_torch_port_streaming_decode import _wave

TINY = dict(ONLINE, encoder_num_blocks=1, decoder_num_block=1)
DEC = dict(beam=3, ctc_beam=5, ctc_weight=0.5, online=True)
# the stream's 32 frames fill one bucket of 32, so every session refresh
# runs one compiled lasr_tpu search of each kind; the recognizer's
# bucket of 16 grows the persisted state between refreshes
BUCKET = 32
NBEST = 3
# a sharp CTC head and a positive source-attention bias: frontiers stall
# and endpoints advance, so mid-stream refreshes run token steps (random
# weights otherwise pause every refresh at step 0)
SHARP = dict(ctc_scale=16.0, src_bias=2.0)


@functools.lru_cache(maxsize=None)
def _models():
    return pair(JaxOnline, E2E_Transformer_CTC_Online, TINY, seed=3,
                jit=True, **SHARP)


@functools.lru_cache(maxsize=None)
def _setup():
    """(jax decoder, port decoder, the stream's encoder states (T, D))
    of one tiny model (nbest 3); the states are the online encoder's
    output on 120 seeded frames, fed to both searches."""
    fm, v, pm = _models()
    jdec = JaxBeam(fm, v, nbest=NBEST, **DEC)
    pdec = CTCAttBeamDecoder(pm, nbest=NBEST, device="cpu", **DEC)
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 120, 80)).astype(np.float32))
    hs, hs_len, _ = pdec.encode(feats, torch.tensor([120]))
    return jdec, pdec, hs[0, : int(hs_len[0])].numpy()


_JITS = {}


def _jax_session(jdec):
    """A ``lasr_tpu`` session sharing one compiled ``_resume`` (each
    session otherwise compiles its own)."""
    sess = JaxSession(jdec, bucket=BUCKET)
    sess._jit = _JITS.setdefault("resume", sess._jit)
    return sess


def _scratch(pdec, hs_np):
    """The port's from-scratch online search over the whole stream."""
    T = len(hs_np)
    hs = torch.from_numpy(hs_np)[None]
    hs_len = torch.tensor([T])
    lpz = torch.log_softmax(pdec.model.ctc_logits(hs).float(), dim=-1)
    return pdec.search(hs, hs_len, lpz, T)


def _same_final(got, want, atol=1e-4):
    n = int(want.lengths[0, 0])
    assert int(got.lengths[0, 0]) == n
    assert got.tokens[0, 0, :n].tolist() == want.tokens[0, 0, :n].tolist()
    np.testing.assert_allclose(got.scores[0, 0], want.scores[0, 0],
                               atol=atol)


@pytest.mark.parametrize("splits", [[1.0], [0.35, 0.7, 1.0],
                                    [0.2, 0.4, 0.6, 0.8, 1.0]])
def test_refreshes_and_final_equal_jax_and_from_scratch(splits):
    jdec, pdec, hs_np = _setup()
    T = len(hs_np)
    js, ps = _jax_session(jdec), IncrementalBeamSession(pdec, bucket=BUCKET)
    for frac in splits[:-1]:
        n = int(frac * T)
        w_tok, w_score, w_live = js.refresh(hs_np[:n])
        g_tok, g_score, g_live = ps.refresh(torch.from_numpy(hs_np[:n]))
        assert (g_tok, g_live) == (w_tok, w_live)
        np.testing.assert_allclose(g_score, w_score, atol=1e-4)
    got = ps.refresh(torch.from_numpy(hs_np), final=True)
    _same_final(got, js.refresh(hs_np, final=True))
    _same_final(got, _scratch(pdec, hs_np))


def test_nbest_pool_survives_resumption():
    jdec, pdec, hs_np = _setup()
    half = torch.from_numpy(hs_np[: len(hs_np) // 2])
    ps = IncrementalBeamSession(pdec, bucket=BUCKET)
    ps.refresh(half)
    got = ps.refresh(torch.from_numpy(hs_np), final=True).nbest_ids(0)
    assert len(got) == NBEST
    js = _jax_session(jdec)
    js.refresh(hs_np[: len(hs_np) // 2])
    for want in (js.refresh(hs_np, final=True).nbest_ids(0),
                 _scratch(pdec, hs_np).nbest_ids(0)):
        assert [ids for ids, _ in got] == [ids for ids, _ in want]
        np.testing.assert_allclose([s for _, s in got],
                                   [s for _, s in want], atol=1e-4)


def test_band_state_after_one_refresh_equals_jax():
    jdec, pdec, hs_np = _setup()
    n = int(0.6 * len(hs_np))
    js, ps = _jax_session(jdec), IncrementalBeamSession(pdec, bucket=BUCKET)
    js.refresh(hs_np[:n])
    ps.refresh(torch.from_numpy(hs_np[:n]))
    want, got = js._state, ps._state
    assert got["i"] == int(want["i"]) >= 5
    for key in ("tokens", "ended_tok", "alive", "frontier"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("band", "ended_band", "rb_empty", "r"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)


def test_recognizer_incremental_finalizes_as_from_scratch_and_jax():
    fm, v, pm = _models()
    n = 24000
    wav = _wave(7, n)
    rk = dict(beam_interval=2, beam_bucket=16)
    finals, partials = [], []
    for incremental in (False, True):
        rec = StreamingRecognizer(
            pm, beam_decoder=CTCAttBeamDecoder(pm, device="cpu", **DEC),
            beam_incremental=incremental, **rk)
        parts = []
        for lo in range(0, n, 4000):
            rec.accept_waveform(wav[lo: lo + 4000])
            parts.append(rec.partial_result()[0])
        finals.append(rec.finalize()[0])
        assert (rec.beam_session is not None) == incremental
        partials.append(parts)
    rec_j = JaxRecognizer(fm, v, beam_decoder=JaxBeam(fm, v, **DEC), **rk)
    parts = []
    for lo in range(0, n, 4000):
        rec_j.accept_waveform(wav[lo: lo + 4000])
        parts.append(rec_j.partial_result()[0])
    assert partials[1] == parts and len(set(map(tuple, parts))) >= 3
    assert finals[0] == finals[1] == rec_j.finalize()[0]


def test_session_with_an_rnnlm_finalizes_as_the_fused_search():
    """With shallow RNNLM fusion (lasr_tpu's session carries the LM state
    too) the resumed search's final equals the from-scratch fused
    search."""
    from lasr_tpu_torch.modules.rnn import RNNCellStack
    _, pdec, hs_np = _setup()
    torch.manual_seed(2)
    lm = RNNCellStack(input_dim=11, output_dim=11, n_layers=2, n_units=24,
                      device="cpu")
    fused = CTCAttBeamDecoder(pdec.model, lm=lm, lm_weight=0.3,
                              device="cpu", **DEC)
    ps = IncrementalBeamSession(fused, bucket=16)
    for n in (10, 20):
        ps.refresh(torch.from_numpy(hs_np[:n]))
    assert ps._state["i"] > 0 and ps._state["lm"] is not None
    got = ps.refresh(torch.from_numpy(hs_np), final=True)
    _same_final(got, _scratch(fused, hs_np))
