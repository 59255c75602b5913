"""The layer variants of ``lasr_tpu`` that the port builds from the same
kwargs, held against ``lasr_tpu`` on bridged weights (f32, tiny widths,
every JAX call compiled once per shape):

  - the Conformer with ``scaled_abs_pos`` (``ScaledPositionalEncoding``,
    its learnable ``alpha``) under conv2d and no input layer, and with the
    linear input layer under ``rel_pos``;
  - the Transformer encoder with the ``embed`` (token ids) and no input
    layer, and the decoder with the ``linear`` input layer;
  - ``RNNCellStack`` / ``RNNLM`` in bf16.

Each model's eval forward and its dropout-0 train loss within 2e-4 and
its state_dict back through ``torch_to_flax`` bit for bit; the bf16 LM's
logits, states and ``predict`` log-probs within 2e-2 of Flax's bf16 LM.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
import lasr_tpu.models.losses as jax_losses
from lasr_tpu.modules.rnn import RNNCellStack as JaxRNNCellStack
from lasr_tpu.modules.transformer import Decoder as JaxDecoder
from lasr_tpu_torch.models.e2e_ctc_att import (E2E_Conformer_CTC,
                                               E2E_Transformer_CTC)
from lasr_tpu_torch.models.losses import E2E_Loss, LabelSmoothingLoss
from lasr_tpu_torch.modules.embedding import ScaledPositionalEncoding
from lasr_tpu_torch.modules.rnn import RNNLM, RNNCellStack
from lasr_tpu_torch.modules.transformer import Decoder
from lasr_tpu_torch.utils.masks import target_mask
from lasr_tpu_torch.utils.weights import (flax_to_state_dict,
                                          load_model_weights,
                                          rnnlm_flax_to_state_dict)
from tests.torch_port_common import labels, round_trip, seeded_variables, t

TOL = 2e-4
BF16_TOL = 2e-2
D = 16
# one block each: the variants are the input layers and the encoding
WIDTHS = dict(encoder_attention_dim=D, encoder_attention_heads=2,
              encoder_linear_units=32, encoder_num_blocks=1,
              decoder_attention_dim=D, decoder_attention_heads=2,
              decoder_linear_units=32, decoder_num_block=1,
              encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
              ctc_dropout=0.0)
CONFORMER = dict(WIDTHS, encoder_cnn_kernel=7)
SCALED = dict(CONFORMER, encoder_pos_enc_layer_type="scaled_abs_pos")
REL = dict(CONFORMER, encoder_pos_enc_layer_type="rel_pos",
           encoder_selfattention_layer_type="rel_selfattn")
ODIM = 9

# (JAX class, port class, kwargs, input: "feats" (B, T, idim) or "ids"
# (B, T) in [0, idim))
VARIANTS = {
    "conformer_scaled_conv2d": ("E2E_Conformer_CTC", E2E_Conformer_CTC,
                                dict(SCALED, idim=20), "feats"),
    "conformer_scaled_none": ("E2E_Conformer_CTC", E2E_Conformer_CTC,
                              dict(SCALED, idim=D, encoder_input_layer=None),
                              "feats"),
    "conformer_rel_linear": ("E2E_Conformer_CTC", E2E_Conformer_CTC,
                             dict(REL, idim=20, encoder_input_layer="linear"),
                             "feats"),
    "transformer_embed": ("E2E_Transformer_CTC", E2E_Transformer_CTC,
                          dict(WIDTHS, idim=13, encoder_input_layer="embed"),
                          "ids"),
    "transformer_none": ("E2E_Transformer_CTC", E2E_Transformer_CTC,
                         dict(WIDTHS, idim=D, encoder_input_layer=None),
                         "feats"),
}


def _inputs(kind, idim, seed, B=3, T=40, L=5):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, idim, (B, T)).astype(np.int32) if kind == "ids"
         else rng.standard_normal((B, T, idim)).astype(np.float32))
    xlen = np.asarray([T, T - 11, T - 6][:B], np.int32)
    ys = rng.integers(3, ODIM, (B, L)).astype(np.int32)
    ys[1:, L - 2:] = -1
    return x, xlen, ys


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_lasr_tpu(name):
    jax_cls, port_cls, kw, kind = VARIANTS[name]
    kw = dict(kw, odim=ODIM)
    x, xlen, ys = _inputs(kind, kw["idim"], seed=1)
    ys_in, att_label, ctc_label = labels(ys)
    fm = getattr(jax_models, jax_cls)(**kw)
    v = seeded_variables(fm, 2, x, xlen, ys_in)
    pm = port_cls(**kw, device="cpu")
    load_model_weights(pm, flax_to_state_dict(v))
    round_trip(v, pm)
    if "scaled" in name:
        assert any(isinstance(m, ScaledPositionalEncoding)
                   for m in pm.modules())

    loss_w = jax_losses.E2E_Loss(ODIM, smoothing=0.1, rate=0.3)

    def forwards(v, x, xlen, ys_in, att_label, ctc_label):
        """The eval and the dropout-0 train forward, and the train loss,
        in one compile."""
        train = fm.apply(v, x, xlen, ys_in, deterministic=False,
                         rngs={"dropout": jax.random.PRNGKey(3)},
                         mutable=["batch_stats"])[0]
        return {"eval": fm.apply(v, x, xlen, ys_in), "train": train,
                "loss": loss_w(train["att_out"], train["ctc_out"], att_label,
                               ctc_label, train["hs_len"])}
    want = jax.jit(forwards)(v, x, xlen, ys_in, att_label, ctc_label)
    x_t = t(x).long() if kind == "ids" else t(x)
    got = {}
    with torch.no_grad():
        for mode in ("eval", "train"):
            pm.train(mode == "train")
            got[mode] = pm(x_t, t(xlen), t(ys_in).long())
    pm.eval()
    for mode in ("eval", "train"):
        g, w = got[mode], want[mode]
        for k in ("att_out", "ctc_out"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=TOL, err_msg=f"{mode} {k}")
        np.testing.assert_array_equal(g["hs_len"].numpy(),
                                      np.asarray(w["hs_len"]))
    g = got["train"]
    lp = E2E_Loss(ODIM, smoothing=0.1, rate=0.3)(
        g["att_out"], g["ctc_out"], t(att_label), t(ctc_label), g["hs_len"])
    for a, b in zip(lp, want["loss"]):
        np.testing.assert_allclose(float(a), float(b), rtol=TOL, atol=TOL,
                                   err_msg="train loss")


def test_decoder_linear_input_matches_lasr_tpu():
    """The decoder's linear input layer over (B, L, odim) float inputs:
    forward (eval and dropout-0 train) and the label-smoothed loss."""
    kw = dict(attention_dim=D, attention_heads=2, linear_units=32,
              num_blocks=1, dropout_rate=0.0, positional_dropout_rate=0.0,
              input_layer="linear")
    rng = np.random.default_rng(5)
    B, L, T = 3, 6, 11
    tgt = rng.standard_normal((B, L, ODIM)).astype(np.float32)
    ids = rng.integers(3, ODIM, (B, L)).astype(np.int32)
    ids[1:, L - 2:] = -1
    memory = rng.standard_normal((B, T, D)).astype(np.float32)
    mem_mask = (np.arange(T)[None, :] < np.asarray([T, 7, 9])[:, None]
                )[:, None, :]
    tgt_mask = target_mask(t(ids)).numpy()
    fm = JaxDecoder(ODIM, **kw)
    v = seeded_variables(fm, 6, tgt, tgt_mask, memory, mem_mask)
    pm = Decoder(ODIM, **kw)
    load_model_weights(pm, flax_to_state_dict(v))
    round_trip(v, pm)
    loss_w = jax_losses.LabelSmoothingLoss(ODIM, smoothing=0.1)

    def forwards(v, ids, *args):
        """Eval and dropout-0 train forwards and their losses, in one
        compile."""
        out = (fm.apply(v, *args), fm.apply(
            v, *args, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(7)}))
        return [(o, loss_w(o, ids)) for o in out]
    want = jax.jit(forwards)(v, ids, tgt, tgt_mask, memory, mem_mask)
    loss_p = LabelSmoothingLoss(ODIM, smoothing=0.1)
    for train, (w, lw) in zip((False, True), want):
        pm.train(train)
        with torch.no_grad():
            got = pm(t(tgt), t(tgt_mask), t(memory), t(mem_mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL)
        np.testing.assert_allclose(float(loss_p(got, t(ids))), float(lw),
                                   rtol=TOL, atol=TOL)
    pm.eval()
    with pytest.raises(NotImplementedError, match="embed input"):
        pm.forward_one_step(t(ids[:, 0]).long(), 0, pm.init_cache(B, L),
                            *pm.project_memory(t(memory)), t(mem_mask))


@pytest.mark.parametrize("typ", ["lstm", "gru"])
def test_bf16_rnnlm_matches_flax(typ):
    """Flax's bf16 LM rounds the embedding and the output projection and
    runs its cells in float32 (they take no dtype): the port's bf16 LM
    within 2e-2 over three steps, its state float32 after the first, and
    ``predict``'s log-probs in the logits' dtype as lasr_tpu's."""
    V, B = 11, 4
    kw = dict(input_dim=V, output_dim=V, n_layers=2, n_units=16, typ=typ)
    f32 = JaxRNNCellStack(**kw)
    v = seeded_variables(f32, 8, None, jnp.zeros((B,), jnp.int32))
    fm = JaxRNNCellStack(**kw, dtype=jnp.bfloat16)
    pm = RNNCellStack(**kw, dtype=torch.bfloat16, device="cpu")
    pm.load_state_dict(rnnlm_flax_to_state_dict(v, typ))
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    step = jax.jit(fm.apply)
    rng = np.random.default_rng(9)
    want_state = fm.zero_state(B)
    got_state = pm.zero_state(B)
    assert all(s.dtype == torch.bfloat16 for s in jax.tree.leaves(got_state))
    for _ in range(3):
        x = rng.integers(0, V, (B,))
        want_state, want = step(v, want_state, jnp.asarray(x))
        with torch.no_grad():
            got_state, got = pm(got_state, torch.from_numpy(x))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=BF16_TOL)
        for g, w in zip(jax.tree.leaves(got_state),
                        jax.tree.leaves(want_state)):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=BF16_TOL)
    x = rng.integers(0, V, (B,))
    predict = jax.jit(lambda v, s, x: jax.nn.log_softmax(
        fm.apply(v, s, x)[1], axis=-1))          # lasr_tpu's RNNLM.predict
    want = np.asarray(predict(v, want_state, jnp.asarray(x)), np.float32)
    _, got = RNNLM(pm).predict(x, got_state)
    assert got.dtype == torch.float32
    # log-probs rounded to bf16: a spacing of 2^-6 at magnitudes 2-4
    np.testing.assert_allclose(got.numpy(), want,
                               atol=BF16_TOL * max(1.0, np.abs(want).max()))
