"""The streaming model family of the port against lasr_tpu on identical
weights (carried across by the weight bridge) and seeded inputs, at
test_streaming.py's widths (d=16, chunks 16/16/16):

  - per-row positional offsets; ``_chunk_grid`` over a range of T;
  - ``E2E_Transformer_CTC_Online``: eval forward and E2E_Loss within 2e-4;
  - ``ChunkEncoder`` in both ``ref_tail`` conventions with ragged x_len
    within 2e-4, and the port's ``encode_chunk`` sequence equal to its
    own batch forward within 1e-5;
  - ``StreamDecoder``: full forward with the attention maps and every
    step form within 2e-4, the chained endpoints exact;
  - the state_dict round-trips through ``torch_compat.torch_to_flax``;
  - the memory knobs and the resumable search build (the session's
    refusals hold), what stays unported raises, a train-mode forward
    with sigmoid noise outside ``dropout_generator`` raises, the Trainer
    takes both models (one step each), and the registry resolves their
    reference names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.models.e2e_online import E2E_Transformer_CTC_Online as JaxOnline
from lasr_tpu.modules.embedding import PositionalEncoding as JaxPE
from lasr_tpu.modules.streaming import _chunk_grid as jax_chunk_grid
from lasr_tpu.utils.masks import target_mask as jax_target_mask
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.decode.online import (IncrementalBeamSession,
                                          ServingEngine, StreamingRecognizer)
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Transformer_CTC
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.modules.embedding import PositionalEncoding
from lasr_tpu_torch.modules.streaming import _chunk_grid
from lasr_tpu_torch.ops.fbank import KaldiFbankConfig
from lasr_tpu_torch.utils.masks import target_mask
from tests.torch_port_common import (ONLINE, OFFLINE, TOL, batch,
                                     check_forward_and_loss, pair,
                                     round_trip, t)


def test_positional_encoding_takes_per_row_offsets():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    jm = JaxPE(16, 0.0)
    pe = PositionalEncoding(16, 0.0).eval()
    off = np.asarray([0, 5, 130], np.int32)
    want = jm.apply({}, jnp.asarray(x), offset=jnp.asarray(off))
    np.testing.assert_allclose(pe(t(x), offset=t(off)).numpy(),
                               np.asarray(want), atol=1e-5)
    # an int offset keeps the table rows
    for o in (0, 9):
        np.testing.assert_allclose(
            pe(t(x), o).numpy(), np.asarray(jm.apply({}, jnp.asarray(x), o)),
            atol=1e-6)
    assert torch.equal(pe(t(x), 9), pe(t(x), torch.tensor(9)))


@pytest.mark.parametrize("cur,right", [(64, 64), (32, 16), (64, 0),
                                       (16, 16)])
def test_chunk_grid_equals_jax(cur, right):
    for T in range(1, 420, 7):
        assert _chunk_grid(T, cur, right, cur) == \
            jax_chunk_grid(T, cur, right, cur)


def test_online_model_forward_and_loss():
    fm, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online, ONLINE, seed=2,
                     src_bias=0.3)
    check_forward_and_loss(fm, v, pm, seed=2)


@pytest.mark.parametrize("ref_tail", [False, True])
def test_chunk_encoder_matches_jax(ref_tail):
    fm, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online, ONLINE, seed=4)
    for T, lens in ((120, (120, 80, 97)), (77, (77, 1, 40))):
        x, _, _ = batch(T=T, seed=T)
        xlen = np.asarray(lens, np.int32)
        hs, hs_len = fm.apply(v, x, xlen, ref_tail=ref_tail,
                              method=fm.encode_online)
        with torch.no_grad():
            phs, phs_len = pm.encode_online(t(x), t(xlen), ref_tail=ref_tail)
        np.testing.assert_allclose(phs.numpy(), np.asarray(hs), atol=TOL)
        np.testing.assert_array_equal(phs_len.numpy(), np.asarray(hs_len))


def test_encode_chunk_sequence_equals_batch_forward():
    _, _, pm = pair(JaxOnline, E2E_Transformer_CTC_Online, ONLINE, seed=5)
    enc = pm.encoder
    x, _, _ = batch(B=2, T=128, seed=6)
    xlen = torch.tensor([128, 93])
    with torch.no_grad():
        full, full_len = enc(t(x), xlen)
        n = _chunk_grid(128, 16, 16, 16)
        x_pad = torch.nn.functional.pad(t(x), (0, 0, 0, 16 + 6 + 16))
        mems = enc.init_stream_state(2)
        outs = []
        for c in range(n):
            out, mems = enc.encode_chunk(x_pad[:, c * 16: c * 16 + 38], c,
                                         mems, xlen)
            outs.append(out)
    inc = torch.cat(outs, dim=1)
    for b in range(2):
        m = int(full_len[b])
        np.testing.assert_allclose(inc[b, :m].numpy(), full[b, :m].numpy(),
                                   atol=1e-5)


def test_stream_decoder_forward_and_steps():
    fm, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online, ONLINE, seed=7,
                     src_bias=-0.2)
    B, K, L, T = 2, 3, 4, 10
    rng = np.random.default_rng(8)
    mem = rng.standard_normal((B, T, 16)).astype(np.float32)
    ys = rng.integers(1, 11, (B, L)).astype(np.int32)
    mem_mask = np.ones((B, 1, T), bool)
    mem_mask[1, 0, 7:] = False

    def japply(fn, *args):
        return fm.apply(v, *args, method=fn)

    want, attn = japply(
        lambda m, *a: m.decoder(*a, collect_attn=True), jnp.asarray(ys),
        jax_target_mask(jnp.asarray(ys)), mem, mem_mask)
    with torch.no_grad():
        got, pattn = pm.decoder(t(ys).long(), target_mask(t(ys)), t(mem),
                                t(mem_mask), collect_attn=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(pattn.numpy(), np.asarray(attn), atol=TOL)

    # the untruncated monotonic step and the raw-memory online step
    with torch.no_grad():
        pmk, pmv = pm.decoder_project_memory(t(mem))
    mk, mv = japply(lambda m, h: m.decoder.project_memory(h), mem)
    np.testing.assert_allclose(pmk.numpy(), np.asarray(mk), atol=TOL)
    cj = japply(lambda m: m.decoder.init_cache(B, L))
    cj2 = cj
    cp = pm.decoder_init_cache(B, L)
    cp2 = pm.decoder_init_cache(B, L)
    for i in range(L):
        lj, cj = japply(lambda m, *a: m.decoder.forward_one_step(*a),
                        ys[:, i], i, cj, mk, mv, mem_mask)
        lj2, cj2 = japply(lambda m, *a: m.decoder_step_online(*a),
                          ys[:, i], i, cj2, mem)
        with torch.no_grad():
            lp, cp = pm.decoder_step(t(ys[:, i]).long(), i, cp, pmk, pmv,
                                     t(mem_mask))
            lp2, cp2 = pm.decoder_step_online(t(ys[:, i]).long(), i, cp2,
                                              t(mem))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=TOL)
        np.testing.assert_allclose(lp2.numpy(), np.asarray(lj2), atol=TOL)
        np.testing.assert_array_equal(cp2["ep"].numpy(),
                                      np.asarray(cj2["ep"]))

    # the beam's chained step: siblings share a parent in beam order
    mkK, mvK = (np.repeat(np.asarray(a), K, axis=1) for a in (mk, mv))
    maskK = np.repeat(mem_mask, K, axis=0)
    parents = [[[0, 0, 0], [0, 0, 0]], [[0, 0, 1], [0, 1, 0]],
               [[1, 1, 0], [2, 2, 2]], [[0, 2, 2], [1, 0, 0]]]
    alives = [[[1, 0, 0], [1, 0, 0]], [[1, 1, 1], [1, 1, 0]],
              [[1, 0, 1], [1, 1, 1]], [[1, 1, 1], [0, 1, 1]]]
    cj = japply(lambda m: m.decoder.init_cache(B * K, L))
    cp = pm.decoder_init_cache(B * K, L)
    toks = rng.integers(1, 11, (L, B * K))
    for i in range(L):
        par = np.asarray(parents[i], np.int32)
        alv = np.asarray(alives[i], bool)
        lj, cj, sj = japply(lambda m, *a: m.decoder_step_ep(*a), toks[i], i,
                            cj, mkK, mvK, maskK, par, alv)
        with torch.no_grad():
            lp, cp, sp = pm.decoder_step_ep(
                t(toks[i]).long(), i, cp, t(mkK), t(mvK), t(maskK),
                t(par).long(), t(alv))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=TOL)
        np.testing.assert_array_equal(cp["ep"].numpy(), np.asarray(cj["ep"]))
        np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))


def test_state_dict_round_trips_through_torch_compat():
    _, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online, ONLINE, seed=11,
                    src_bias=0.5)
    round_trip(v, pm)


def test_ported_options_build_and_the_rest_raise():
    """The memory knobs and the resumable search, once refused, build;
    what stays unported still raises."""
    kw = dict(ONLINE, device="cpu")
    for flag, attr, value in (("encoder_remat", "remat", True),
                              ("encoder_conv_once", "conv_once", True),
                              ("encoder_layer_major_rows",
                               "layer_major_rows", 64)):
        model = E2E_Transformer_CTC_Online(**dict(kw, **{flag: value}))
        assert getattr(model.encoder, attr) == value
    assert E2E_Transformer_CTC(**OFFLINE, encoder_remat=True,
                               device="cpu").encoder.remat
    # every input layer of lasr_tpu's encoder builds; an unknown one
    # raises as it does there
    assert E2E_Transformer_CTC(**OFFLINE, encoder_input_layer="embed",
                               device="cpu").encoder.input_layer == "embed"
    with pytest.raises(ValueError, match="unknown input_layer"):
        E2E_Transformer_CTC(**OFFLINE, encoder_input_layer="conv1d",
                            device="cpu")
    # layer_major=False is the same math as the layer-major forward
    E2E_Transformer_CTC_Online(**kw, encoder_layer_major=False)

    # train-mode sigmoid noise draws from the dropout generator only
    pm = E2E_Transformer_CTC_Online(
        **dict(kw, decoder_src_attention_sigmoid_noise=1.0))
    with pytest.raises(RuntimeError, match="dropout_generator"):
        x, xlen, ys = batch()
        pm.train()
        pm.decoder.decoders[0].src_attn(t(x[:, :4, :16]), t(x[:, :9, :16]),
                                        t(x[:, :9, :16]))
    pm.eval()
    dec = CTCAttBeamDecoder(pm, online=True, device="cpu")
    rec = StreamingRecognizer(pm, beam_decoder=dec)
    assert isinstance(rec.beam_session, IncrementalBeamSession)
    assert StreamingRecognizer(pm, beam_decoder=dec,
                               beam_incremental=False).beam_session is None
    with pytest.raises(ValueError, match="maxlenratio"):
        StreamingRecognizer(pm, beam_decoder=CTCAttBeamDecoder(
            pm, online=True, maxlenratio=0.5, device="cpu"))
    with pytest.raises(ValueError, match="online=True"):
        IncrementalBeamSession(CTCAttBeamDecoder(pm, device="cpu"))
    with pytest.raises(ValueError, match="different model"):
        other = E2E_Transformer_CTC_Online(**kw)
        StreamingRecognizer(pm, engine=ServingEngine(other,
                                                     KaldiFbankConfig()))
    with pytest.raises(ValueError, match="streaming model"):
        CTCAttBeamDecoder(E2E_Transformer_CTC(**OFFLINE, device="cpu"),
                          online=True, device="cpu")


@pytest.mark.parametrize("which", ["transformer", "online"])
def test_trainer_refuses_the_new_models(which):
    """The Trainer takes both models: one step with dropout, SpecAugment
    and (online) the sigmoid noise on gives finite metrics and moves
    every parameter that the loss reaches."""
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.train.optimizer import Adam
    from lasr_tpu_torch.train.trainer import METRICS, Trainer
    torch.manual_seed(0)
    model = (E2E_Transformer_CTC(**OFFLINE, device="cpu")
             if which == "transformer"
             else E2E_Transformer_CTC_Online(
                 **dict(ONLINE, decoder_src_attention_sigmoid_noise=1.0),
                 device="cpu"))
    trainer = Trainer(model, E2E_Loss(11), Adam(lr=1e-3),
                      DeviceFrontend(["norm", "fbank:80", "specaug"]),
                      device="cpu")
    rng = np.random.default_rng(1)
    wav = (0.2 * rng.standard_normal((2, 12800))).astype(np.float32)
    batch_ = {"wav_array": wav, "wav_len": np.asarray([12800, 9000],
                                                       np.int32),
              "token_id": rng.integers(3, 11, (2, 5)).astype(np.int32),
              "token_len": np.asarray([5, 3], np.int32)}
    before = [p.detach().clone() for p in trainer.params]
    state, metrics = trainer.train_step(trainer.init_state(), batch_)
    assert state.step == 1 and set(metrics) == set(METRICS)
    assert all(np.isfinite(v) for v in metrics.values())
    moved = [not torch.equal(a, p) for a, p in zip(before, trainer.params)]
    assert sum(moved) >= len(moved) - 2


def test_registry_resolves_the_reference_names():
    from lasr_tpu_torch.utils.registry import dynamic_import
    with pytest.warns(UserWarning, match="reference class"):
        assert dynamic_import(
            "lasr.model.e2e_ctc_att.e2e_transformer:E2E_Transformer_CTC"
        ) is E2E_Transformer_CTC
    with pytest.warns(UserWarning, match="reference class"):
        assert dynamic_import(
            "lasr.model.e2e_ctc_att.e2e_transformer_online:"
            "E2E_Transformer_CTC_Online") is E2E_Transformer_CTC_Online
    assert dynamic_import("lasr_tpu.models.e2e_online:"
                          "E2E_Transformer_CTC_Online") \
        is E2E_Transformer_CTC_Online
