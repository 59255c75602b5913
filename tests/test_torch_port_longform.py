"""Long-form decoding of the port against lasr_tpu on the same weights
and features: ``pick_cut_frames``' cuts equal; the windowed encoder
(windows small enough to force 5 of them, in two window batches) within
2e-4 in ``hs`` and ``lpz`` for the rel-pos Conformer, the abs-pos
Conformer and the abs-PE Transformer (their windows' positions through
``pos_offset``); and the long-form tokens exact, windowed and through the
full forward, on the rel-pos Conformer and the abs-PE Transformer."""

import functools

import numpy as np
import pytest

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.decode.beam import CTCAttBeamDecoder as JaxBeam
from lasr_tpu.decode.longform import LongFormCTCAttDecoder as JaxLongForm
from lasr_tpu.decode.longform import pick_cut_frames as jax_cuts
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.decode.longform import LongFormCTCAttDecoder
from lasr_tpu_torch.decode.longform import pick_cut_frames
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Transformer_CTC
from tests.torch_port_common import OFFLINE, TINY, model_pair, pair

TOL = 2e-4
# windows of 16 encoder frames with halos of 4, segments of 24 frames
LONGFORM = dict(segment_frames=24, window_frames=6, segment_batch=4,
                encoder_window_frames=16, encoder_halo_frames=4,
                encoder_window_batch=4)
BEAM = dict(beam=3, ctc_beam=4, ctc_weight=0.5)


def models(name):
    """(flax model, variables, port model, idim) of a configuration."""
    if name == "transformer_abs":
        fm, v, pm = pair(jax_models.E2E_Transformer_CTC, E2E_Transformer_CTC,
                         OFFLINE, seed=1, ctc_scale=4.0)
        return fm, v, pm, OFFLINE["idim"]
    flags = {} if name == "conformer_rel" else dict(
        encoder_pos_enc_layer_type="abs_pos",
        encoder_selfattention_layer_type="selfattn")
    fm, v, pm = model_pair(flags, seed=3)
    return fm, v, pm, TINY["idim"]


@functools.lru_cache(maxsize=None)
def decoders(name):
    """Both packages' long-form decoders over one configuration, shared
    by the tests (each JAX search shape compiles once)."""
    fm, v, pm, idim = models(name)
    return (JaxLongForm(JaxBeam(fm, v, **BEAM), **LONGFORM),
            LongFormCTCAttDecoder(CTCAttBeamDecoder(pm, device="cpu",
                                                    **BEAM),
                                  device="cpu", **LONGFORM), idim)


def stream(idim, n, seed=0):
    x = np.random.default_rng(seed).standard_normal((1, n, idim))
    return x.astype(np.float32), np.asarray([n], np.int32)


def test_pick_cut_frames_equal():
    rng = np.random.default_rng(5)
    for n, segment, window in ((300, 40, 9), (97, 24, 6), (50, 60, 5),
                               (400, 30, 30)):
        blank = rng.standard_normal(n).astype(np.float32)
        blank[rng.integers(0, n, n // 10)] += 3.0
        assert pick_cut_frames(blank, n, segment, window) == \
            jax_cuts(blank, n, segment, window)


@pytest.mark.parametrize("name", ["conformer_rel", "conformer_abs",
                                  "transformer_abs"])
def test_windowed_encoder_matches_jax(name):
    want_dec, got_dec, idim = decoders(name)
    x, n = stream(idim, 300, seed=1)
    hs_w, T_w, lpz_w = want_dec._encode_windowed(x, n)
    hs, T, lpz = got_dec.encode_windowed(got_dec.dec.model.ctc[1].weight
                                         .new_tensor(x), n)
    assert T == T_w == 74 and hs.shape[0] == T
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_w), atol=TOL)
    np.testing.assert_allclose(lpz.numpy(), np.asarray(lpz_w), atol=TOL)


@pytest.mark.parametrize("name,n", [("conformer_rel", 300),
                                    ("conformer_rel", 90),
                                    ("transformer_abs", 300)])
def test_longform_tokens_equal_jax(name, n):
    want_dec, got_dec, idim = decoders(name)
    x, xlen = stream(idim, n, seed=2)
    want, want_segs = want_dec(x, xlen)
    got, got_segs = got_dec(x, xlen)
    assert got_segs == want_segs and got == want
    # 300 input frames: 74 encoder frames, windowed, in several segments
    # of at most 24; 90: one window, the full forward, one segment
    assert len(got_segs) >= 3 if n == 300 else len(got_segs) == 1
    assert any(got_segs)
