"""Streaming decode of the port against lasr_tpu on identical weights
(carried across by the weight bridge), at test_streaming.py's widths:

  - the online beam search (``ctc_att_online``) token-exact, scores within
    1e-4, on a ragged batch, nbest 1 and 3;
  - ``StreamingRecognizer``: greedy tokens equal after every ragged sample
    piece and at finalize; beam partials and finalize equal with
    ``beam_incremental=False``; its incremental fbank frames equal the
    batch frontend's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.decode.beam import CTCAttBeamDecoder as JaxBeam
from lasr_tpu.decode.online import StreamingRecognizer as JaxRecognizer
from lasr_tpu.models.e2e_online import E2E_Transformer_CTC_Online as JaxOnline
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.decode.online import StreamingRecognizer
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from lasr_tpu_torch.utils.weights import flax_to_state_dict, load_model_weights
from tests.torch_port_common import ONLINE, pair


@pytest.mark.parametrize("nbest", [1, 3])
def test_online_beam_token_exact(nbest):
    fm, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online,
                     dict(ONLINE, encoder_num_blocks=1, decoder_num_block=1),
                     seed=nbest)
    rng = np.random.default_rng(20 + nbest)
    x = rng.standard_normal((3, 120, 80)).astype(np.float32)
    xlen = np.asarray([120, 80, 97], np.int32)
    kw = dict(beam=3, ctc_beam=5, ctc_weight=0.4, nbest=nbest)
    want = JaxBeam(fm, v, online=True, **kw)(x, xlen)
    got = CTCAttBeamDecoder(pm, online=True, device="cpu", **kw)(x, xlen)
    for b in range(3):
        w_nb, g_nb = want.nbest_ids(b), got.nbest_ids(b)
        assert len(g_nb) == nbest
        assert [ids for ids, _ in g_nb] == [ids for ids, _ in w_nb]
        np.testing.assert_allclose([s for _, s in g_nb],
                                   [s for _, s in w_nb], atol=1e-4)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def _wave(seed, n):
    """A tone that changes pitch and loudness every 0.1 s (some segments
    near silence), under noise."""
    rng = np.random.default_rng(seed)
    seg = -(-n // 1600)
    f0 = np.repeat(rng.uniform(100, 2000, seg), 1600)[:n]
    amp = np.repeat(rng.choice([0.0, 0.02, 0.3], seg), 1600)[:n]
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    return (amp * np.sin(phase)
            + 0.002 * rng.standard_normal(n)).astype(np.float32)


def centred_ctc(kw, seed, wav, scale=4.0):
    """A model pair whose CTC head is sharpened by ``scale`` and whose
    bias is shifted by minus the mean logit of ``wav``'s frames, so the
    frame-to-frame change of the encoder output (not its mean direction)
    decides the argmax and greedy decoding emits a varied sequence."""
    fm, v, _ = pair(JaxOnline, E2E_Transformer_CTC_Online, kw, seed=seed,
                    ctc_scale=scale)
    n = len(wav)
    feats, feat_len = JaxFrontend(["fbank:80"])(
        jnp.asarray(wav[None]), jnp.asarray([n], jnp.int32))
    hs, hs_len = fm.apply(v, feats, feat_len, method=fm.encode_online)
    logits = np.asarray(fm.apply(v, hs, method=fm.ctc_logits))[0]
    dense = v["params"]["ctc"]["Dense_0"]
    dense["bias"] = dense["bias"] - logits[: int(hs_len[0])].mean(0)
    pm = E2E_Transformer_CTC_Online(**kw, device="cpu")
    load_model_weights(pm, flax_to_state_dict(v))
    return fm, v, pm


@pytest.mark.parametrize("piece", [3333, 1600])
def test_streaming_recognizer_greedy_equals_jax(piece):
    n = 16000
    wav = _wave(9, n)
    fm, v, pm = centred_ctc(dict(ONLINE, encoder_num_blocks=1,
                                 decoder_num_block=1), 9, wav)
    rec_j = JaxRecognizer(fm, v)
    rec_p = StreamingRecognizer(pm)
    got, want = [], []
    for lo in range(0, n, piece):   # ragged pieces
        want += rec_j.accept_waveform(wav[lo: lo + piece])
        got += rec_p.accept_waveform(wav[lo: lo + piece])
        assert got == want
    final_j, final_p = rec_j.finalize()[0], rec_p.finalize()[0]
    assert final_p == final_j and len(set(final_p)) >= 3


def test_streaming_recognizer_beam_equals_jax():
    kw = dict(ONLINE, encoder_num_blocks=1, decoder_num_block=1)
    fm, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online, kw, seed=3)
    n = 24000
    wav = _wave(3, n)
    dk = dict(beam=3, ctc_beam=5, ctc_weight=0.4, online=True)
    rk = dict(beam_interval=1, beam_bucket=16, beam_incremental=False)
    rec_j = JaxRecognizer(fm, v, beam_decoder=JaxBeam(fm, v, **dk), **rk)
    rec_p = StreamingRecognizer(
        pm, beam_decoder=CTCAttBeamDecoder(pm, device="cpu", **dk), **rk)
    for lo in range(0, n, 5000):
        rec_j.accept_waveform(wav[lo: lo + 5000])
        rec_p.accept_waveform(wav[lo: lo + 5000])
        assert rec_p.partial_result()[0] == rec_j.partial_result()[0]
    assert rec_p._beam_tokens is not None
    assert rec_p.finalize()[0] == rec_j.finalize()[0]


def test_frontend_of_both_packages_feeds_the_same_recognizer_frames():
    """The recognizer's incremental fbank equals the batch frontend's."""
    n = 9000
    wav = _wave(1, n)
    fe = JaxFrontend(["fbank:80"])
    want, _ = fe(jnp.asarray(wav[None]), jnp.asarray([n], jnp.int32))
    _, _, pm = pair(JaxOnline, E2E_Transformer_CTC_Online,
                    dict(ONLINE, encoder_num_blocks=1, decoder_num_block=1))
    rec = StreamingRecognizer(pm)
    for lo in range(0, n, 1234):
        rec.accept_waveform(wav[lo: lo + 1234])
    np.testing.assert_allclose(rec._frames, np.asarray(want[0]), atol=2e-3)
