"""The Univ dual-view family in the port against lasr_tpu on identical
weights (lasr_tpu's init, bridged), f32, at test_streaming.py's widths:

  - both dual encoders: the offline and online views (eval, and a fixed
    chunk in train mode at dropout 0), the dynamic encoder's drawn chunk
    (from the shared generator) against lasr_tpu's online view at that
    chunk, and ``forward_per_chunk`` in one call and in calls with and
    without right context; cut at chunk boundaries the per-chunk outputs
    concatenate to the online view;
  - ``E2E_Transformer_CTC_Univ_Dynamic``'s whole output dict;
  - ``ctc_force_align`` exactly (integer frames), ``KL_Loss``, and
    ``Align_Loss`` in all seven modes;
  - ``CTC_CE_Univ_Loss`` and one dropout-0 train-mode step's gradients
    against ``jax.grad`` (lasr_tpu's model at the chunk the port drew);
  - a Univ YAML naming the reference classes through the port's train
    CLI, then ``ctc_greedy`` through both decode CLIs and both
    ``ASRProcess``es on its checkpoints; ``ctc_att`` and
    ``ctc_att_online`` raise a ValueError naming the class.

All within 2e-4 unless stated.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from lasr_tpu.models.e2e_online import \
    E2E_Transformer_CTC_Univ_Dynamic as JaxUniv
from lasr_tpu.models.losses_univ import Align_Loss as JaxAlign
from lasr_tpu.models.losses_univ import CTC_CE_Univ_Loss as JaxUnivLoss
from lasr_tpu.models.losses_univ import KL_Loss as JaxKL
from lasr_tpu.models.losses_univ import ctc_force_align as jax_force_align
from lasr_tpu.modules.streaming import \
    DualTransformerEncoder as JaxDual
from lasr_tpu_torch.bin import decode as port_decode
from lasr_tpu_torch.bin import train as port_train
from lasr_tpu_torch.data.reader import read_scp
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Univ_Dynamic
from lasr_tpu_torch.models.losses_univ import (Align_Loss, CTC_CE_Univ_Loss,
                                               KL_Loss, ctc_force_align)
from lasr_tpu_torch.modules.dropout import dropout_generator
from lasr_tpu_torch.modules.streaming import (DualTransformerEncoder,
                                              ParallelDynamicDualEncoder)
from lasr_tpu_torch.process.asrprocess import ASRProcess
from lasr_tpu_torch.utils.weights import (flax_to_state_dict,
                                          load_model_weights)
from tests.test_torch_port_cli import _decode_lines, _jax_cli, write_corpus
from tests.torch_port_common import (TOL, f32, flax_state_dict, labels,
                                     numpy_tree, t)

UNIV = dict(idim=80, odim=11, encoder_attention_dim=16,
            encoder_attention_heads=2, encoder_attention_chunk=4,
            encoder_linear_units=32, encoder_num_blocks=2,
            decoder_attention_dim=16, decoder_self_attention_heads=2,
            decoder_src_attention_heads=2, decoder_linear_units=32,
            decoder_num_block=2, decoder_src_attention_sigmoid_noise=0.0,
            encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
            ctc_dropout=0.0)
DUAL = dict(idim=20, attention_dim=16, attention_heads=2, attention_chunk=4,
            linear_units=32, num_blocks=2, dropout_rate=0.0,
            positional_dropout_rate=0.0)


@functools.lru_cache(maxsize=None)
def _dual_pair(input_layer, seed=1, T=24):
    """(flax DualTransformerEncoder, its variables, the port's) on the
    same weights."""
    x = np.random.default_rng(seed).standard_normal(
        (2, T, 20)).astype(np.float32)
    fm = JaxDual(**DUAL, input_layer=input_layer)
    v = numpy_tree(jax.jit(fm.init)(jax.random.PRNGKey(seed), x,
                                    np.asarray([T, T - 6], np.int32)))
    holder = torch.nn.Module()
    holder.encoder = DualTransformerEncoder(**DUAL, input_layer=input_layer)
    load_model_weights(holder, flax_to_state_dict(
        {"params": {"encoder": v["params"]}}))
    return fm, v, holder.encoder


def test_dual_encoder_views_equal_jax():
    fm, v, enc = _dual_pair("linear")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 20)).astype(np.float32)
    xlen = np.asarray([24, 18], np.int32)
    off, on, h_len = jax.jit(fm.apply)(v, x, xlen)
    enc.eval()
    for got, want in zip(enc(t(x), t(xlen)), (off, on, h_len)):
        np.testing.assert_allclose(f32(got), f32(want), atol=TOL)
    np.testing.assert_allclose(f32(enc.forward_offline(t(x), t(xlen))[0]),
                               f32(off), atol=TOL)
    np.testing.assert_allclose(f32(enc.forward_online(t(x), t(xlen))[0]),
                               f32(on), atol=TOL)
    assert not np.allclose(f32(off), f32(on))
    # train mode at dropout 0: the same fixed-chunk views
    enc.train()
    for got, want in zip(enc(t(x), t(xlen)), (off, on)):
        np.testing.assert_allclose(f32(got), f32(want), atol=TOL)


def test_dynamic_encoder_draws_its_chunk_from_the_shared_generator():
    _, v, _ = _dual_pair("linear")
    enc = ParallelDynamicDualEncoder(**DUAL, input_layer="linear")
    holder = torch.nn.Module()
    holder.encoder = enc
    load_model_weights(holder, flax_to_state_dict(
        {"params": {"encoder": v["params"]}}))
    x = np.random.default_rng(4).standard_normal((2, 40, 20)).astype(
        np.float32)
    xlen = np.asarray([40, 33], np.int32)
    enc.train()
    shared = torch.Generator().manual_seed(11)
    chunk = DUAL["attention_chunk"] + int(torch.randint(
        17, (1,), generator=torch.Generator().manual_seed(11))) - 8
    with dropout_generator(torch.Generator().manual_seed(0), shared=shared):
        off, on, _ = enc(t(x), t(xlen))
    jdual = JaxDual(**dict(DUAL, attention_chunk=max(1, chunk)),
                    input_layer="linear")
    want_off, want_on, _ = jax.jit(jdual.apply)(v, x, xlen)
    np.testing.assert_allclose(f32(off), f32(want_off), atol=TOL)
    np.testing.assert_allclose(f32(on), f32(want_on), atol=TOL)
    # without a shared generator the draw comes from the dropout one
    with dropout_generator(torch.Generator().manual_seed(11)):
        _, on2, _ = enc(t(x), t(xlen))
    np.testing.assert_allclose(f32(on2), f32(on), atol=1e-6)


@pytest.mark.parametrize("right", [0, 8])
def test_forward_per_chunk_equals_jax(right):
    fm, v, enc = _dual_pair("conv2d", T=128)
    enc.eval()
    x = np.random.default_rng(2).standard_normal((1, 128, 20)).astype(
        np.float32)
    jc = pc = None
    cuts = (67, 99, 128)        # 67 and 99 raw frames: 16 and 24 rows
    outs = []
    step = jax.jit(functools.partial(fm.apply, method=fm.forward_per_chunk),
                   static_argnums=(3,))
    for n in cuts:
        want, jc = step(v, x[:, :n], jc, right)
        got, pc = enc.forward_per_chunk(t(x[:, :n]), pc, right)
        np.testing.assert_allclose(f32(got), f32(want), atol=TOL)
        for g, w in zip(pc, jc):
            np.testing.assert_allclose(f32(g), f32(w), atol=TOL)
        outs.append(got)
    if right == 0:
        # cut at chunk boundaries, the outputs are the online view
        full, n_full = enc.forward_online(t(x), torch.tensor([128]))
        cat = torch.cat(outs, dim=1)
        assert cat.shape[1] == int(n_full[0])
        np.testing.assert_allclose(f32(cat), f32(full), atol=1e-5)


@functools.lru_cache(maxsize=None)
def _univ_pair(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 60, 80)).astype(np.float32)
    xlen = np.asarray([60, 44], np.int32)
    ys = rng.integers(3, 11, (2, 5)).astype(np.int32)
    ys[1, 3:] = -1
    cfg = UNIV
    fm = JaxUniv(**cfg)
    v = numpy_tree(jax.jit(fm.init)(jax.random.PRNGKey(seed), x, xlen,
                                    np.maximum(ys, 1)))
    pm = E2E_Transformer_CTC_Univ_Dynamic(**cfg, device="cpu")
    load_model_weights(pm, flax_to_state_dict(v))
    return fm, v, pm, (x, xlen, ys)


def test_univ_model_output_dict_equals_jax():
    fm, v, pm, (x, xlen, ys) = _univ_pair()
    ys_in, _, _ = labels(ys)
    want = jax.jit(fm.apply)(v, x, xlen, ys_in)
    got = pm(t(x), t(xlen), t(ys_in).long())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(f32(got[k]), f32(want[k]), atol=TOL,
                                   err_msg=k)
    assert got["ali_out"].shape == (2, 2 * 2, ys_in.shape[1], 14)
    for online in (False, True):
        hs, hs_len = pm.encode(t(x), t(xlen), online=online, solo_pad=True)
        w_hs, w_len = jax.jit(functools.partial(
            fm.apply, online=online, method=fm.encode))(v, x, xlen)
        np.testing.assert_allclose(f32(hs), f32(w_hs), atol=TOL)
        np.testing.assert_array_equal(hs_len.numpy(), np.asarray(w_len))


def _align_inputs(seed=0, B=3, T=12, V=5, L=3):
    rng = np.random.default_rng(seed)
    lp = np.asarray(jax.nn.log_softmax(
        2 * rng.standard_normal((B, T, V)).astype(np.float32), -1))
    labels_ = np.array([[1, 2, 3], [2, 4, 0], [3, 3, 1]], np.int32)
    return lp, labels_, np.array([12, 9, 11], np.int32), \
        np.array([3, 2, 3], np.int32)


def test_ctc_force_align_exact():
    lp, lab, in_len, lab_len = _align_inputs()
    want = np.asarray(jax_force_align(*map(jnp.asarray,
                                           (lp, lab, in_len, lab_len))))
    got = ctc_force_align(t(lp), t(lab), t(in_len), t(lab_len)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2, 1] > got[2, 0] >= 1      # the repeated label: two frames


def test_kl_loss_equals_jax():
    rng = np.random.default_rng(1)
    x, y = (rng.standard_normal((2, 5, 7)).astype(np.float32)
            for _ in range(2))
    mask = np.zeros((2, 5), bool)
    mask[1, 3:] = True
    for norm in (False, True):
        want = float(JaxKL(7, norm)(x, y, mask))
        got = float(KL_Loss(7, norm)(t(x), t(y), t(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(KL_Loss(7)(t(x), t(x), t(mask))) == pytest.approx(0.0,
                                                                    abs=1e-6)


@pytest.mark.parametrize("mode", ["mid", "beg", "end", "norm", "qua",
                                  "google", "ctc"])
def test_align_loss_modes_equal_jax(mode):
    B, layers, L1, T = 3, 4, 4, 12
    rng = np.random.default_rng(0)
    raw = np.abs(rng.standard_normal((B, layers, L1, T))).astype(np.float32)
    ali_out = raw / raw.sum(-1, keepdims=True)
    beg = np.array([[1, 3, 5], [2, 4, -1], [1, 6, 8]], np.int32)
    end = np.array([[2, 4, 7], [3, 6, -1], [3, 7, 10]], np.int32)
    enc_pad = np.zeros((B, T), bool)
    enc_pad[1, 9:] = True
    ctc_out = rng.standard_normal((B, T, 5)).astype(np.float32) * 2
    ctc_label = np.array([[1, 2, 3], [2, 4, -1], [3, 3, 1]], np.int32)
    ctc_len = np.array([12, 9, 11], np.int32)
    want = float(JaxAlign(mode)(*map(jnp.asarray, (
        ali_out, beg, end, enc_pad, ctc_out, ctc_label, ctc_len))))
    got = float(Align_Loss(mode)(t(ali_out), t(beg), t(end), t(enc_pad),
                                 t(ctc_out), t(ctc_label), t(ctc_len)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)
    assert np.isfinite(got) and got != 0.0


def test_univ_loss_and_step_gradients_equal_jax():
    fm, v, pm, (x, xlen, ys) = _univ_pair()
    ys_in, att_label, ctc_label = labels(ys)
    # the ctc alignment mode: the one whose loss is on without label frames
    kw = dict(smoothing=0.1, rate=0.3, kl_rate=0.7, ali_rate=0.5,
              ali_type="ctc")
    # the port's train-mode chunk, drawn as the Trainer's shared
    # generator draws it; lasr_tpu's model at that chunk, eval mode
    # (dropout is 0, so the two modes differ by the chunk alone)
    chunk = UNIV["encoder_attention_chunk"] + int(torch.randint(
        17, (1,), generator=torch.Generator().manual_seed(5))) - 8
    jm = JaxUniv(**dict(UNIV, encoder_attention_chunk=max(1, chunk)))
    jcrit = JaxUnivLoss(11, **kw)

    def jax_loss(params):
        out = jm.apply({"params": params}, x, xlen, ys_in)
        data = dict(out, att_label=jnp.asarray(att_label),
                    ctc_label=jnp.asarray(ctc_label))
        m = jcrit.train_forward(data)
        return m["loss_main"], m
    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        v["params"])

    pm.zero_grad()
    pm.train()
    with dropout_generator(torch.Generator().manual_seed(0),
                           shared=torch.Generator().manual_seed(5)):
        out = pm(t(x), t(xlen), t(ys_in).long())
    got = CTC_CE_Univ_Loss(11, **kw).train_forward(
        dict(out, att_label=t(att_label), ctc_label=t(ctc_label)))
    pm.eval()
    got["loss_main"].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=TOL, atol=1e-6, err_msg=k)
    assert float(got["kl_loss"]) > 0.0 and float(got["ali_loss"]) > 0.0
    want_g = flax_state_dict(grads)
    got_g = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got_g) == set(want_g)
    top = max(float(np.abs(w).max()) for w in want_g.values())
    for n, w in want_g.items():
        err = float((got_g[n] - w).abs().max())
        assert err <= 1e-4 * top, (n, err, top)


def _univ_yaml(tmp, train, valid):
    """A tiny Univ config naming the reference classes."""
    cfg = {
        "model_config": {
            "name": "lasr.model.e2e_ctc_att.e2e_transformer_online_offline:"
                    "E2E_Transformer_CTC_Univ_Dynamic",
            "kwargs": dict(UNIV, odim=0)},
        "opti_config": {
            "name": "lasr_tpu.train.optimizer:Adam",
            "kwargs": {"betas": [0.9, 0.98]},
            "scheduler": {"name": "lasr_tpu.train.optimizer:WarmupScheduler",
                          "kwargs": {"factor": 5, "warm_step": 100,
                                     "model_size": 16, "offset": 0}}},
        "criterion_config": {
            "name": "lasr.model.e2e_ctc_att.e2e_loss_univ:CTC_CE_Univ_Loss",
            "kwargs": {"size": 0, "padding_idx": -1, "smoothing": 0.1,
                       "rate": 0.3}},
        "tokenizer_config": {"name": "lasr_tpu.data.tokenizer:CharTokenizer",
                             "kwargs": {"dict_path": train[2]}}}
    for key, corpus, bs in (("train_data_config", train, 4),
                            ("valid_data_config", valid, 3)):
        cfg[key] = {"name": "lasr_tpu.data.dataset:BatchAudioDataSet",
                    "kwargs": {"wav_list": [corpus[0]],
                               "text_list": [corpus[1]],
                               "audio_trans": ["norm", "fbank:80"],
                               "pad_audio": 0, "pad_feats": 0,
                               "batch_size": bs, "batch_type": "size",
                               "min_duration": 0, "text_freq": 0}}
    path = os.path.join(tmp, "univ.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def test_univ_yaml_trains_and_decodes_through_both_clis(tmp_path, capsys):
    corpus = dict(n16=4, n8=0, secs=(0.5, 0.9), n_words=(1, 3),
                  word_len=(1, 4))
    train = write_corpus(str(tmp_path / "train"), seed=21, **corpus)
    valid = write_corpus(str(tmp_path / "dev"), seed=22,
                         **dict(corpus, n16=2))
    config = _univ_yaml(str(tmp_path), train, valid)
    exp = str(tmp_path / "exp")
    assert port_train.main(["-config", config, "-exp_dir", exp,
                            "-num_epochs", "2", "-ema", "1",
                            "-log_interval", "1", "-num_workers", "1",
                            "-device", "cpu"]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        lines = [yaml.safe_load(line) for line in f]
    assert any("kl_loss" in x and np.isfinite(x["loss_main"])
               for x in lines)
    assert any("valid_kl_loss" in x for x in lines)

    decode = {"decode_config": {"decode_method": "ctc_greedy"},
              "test_data_config": {
                  "name": "lasr_tpu.data.dataset:AudioDataSet",
                  "kwargs": {"wav_list": [valid[0]], "text_list": [valid[1]],
                             "audio_trans": ["norm", "fbank:80"],
                             "pad_audio": 0, "pad_feats": 0}}}
    cfg = str(tmp_path / "decode.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(decode, f)
    hparams = os.path.join(exp, "hparams.yaml")
    last = os.path.join(exp, "checkpoints", "last")
    ours, theirs = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    capsys.readouterr()
    assert port_decode.main(["-train_config", hparams, "-decode_config", cfg,
                             "-model_path", os.path.join(exp, "checkpoints"),
                             "-choose", "last", "-avg", "2",
                             "-output_file", ours, "-device", "cpu"]) == 0
    out_port = capsys.readouterr().out
    assert _jax_cli("decode").main([
        "-train_config", hparams, "-decode_config", cfg, "-model_path", last,
        "-choose", "last", "-avg", "2", "-output_file", theirs]) == 0
    out_jax = capsys.readouterr().out
    with open(ours) as f, open(theirs) as g:
        got_text = f.read()
        assert got_text == g.read() and len(got_text.splitlines()) == 2
    assert _decode_lines(out_port) == _decode_lines(out_jax)

    from lasr_tpu.process.asrprocess import ASRProcess as JaxASRProcess
    newest = os.path.join(last, sorted(os.listdir(last))[-1])
    wav = read_scp(valid[0])[0][1]
    assert ASRProcess(hparams, cfg, newest, device="cpu")(wav) == \
        JaxASRProcess(hparams, cfg, newest)(wav)

    for method in ("ctc_att", "ctc_att_online"):
        decode["decode_config"]["decode_method"] = method
        with open(cfg, "w") as f:
            yaml.safe_dump(decode, f)
        with pytest.raises(ValueError,
                           match="E2E_Transformer_CTC_Univ_Dynamic"):
            ASRProcess(hparams, cfg, newest, device="cpu")
    with pytest.raises(ValueError, match="E2E_Transformer_CTC_Univ"):
        CTCAttBeamDecoder(E2E_Transformer_CTC_Univ_Dynamic(
            **dict(UNIV, odim=11), device="cpu"), device="cpu")
