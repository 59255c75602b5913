"""The int8 feed-forward (``ops/quant.py``) against ``lasr_tpu``'s
``ops/quant.py``, and the seed-recompute dropout (``ops/dropout.py``)
against the port's ``Dropout``:

  - ``int8_matmul``'s forward within 1e-6 (relative) of ``lasr_tpu``'s
    (the int32 products are exact; the dequantization multiplies in the
    same order), its two backwards (``bwd_int8`` True and False) too;
  - ``QuantLinear`` takes an ``nn.Dense`` (or ``QuantDense``) tree through
    the weight bridge and computes ``QuantDense``'s output on it, and the
    port's ``Linear`` and ``QuantLinear`` load each other's state_dicts;
  - ``tests/test_quant.py``'s tiny Conformer with ``encoder_ff_int8``:
    one train-mode step's loss, every parameter's gradient and the
    BatchNorm statistics after it within 2e-4 of ``lasr_tpu``'s;
  - the seed dropout's outputs and gradients are bitwise those of
    ``dropout`` on the same generator state (a tensor-parallel shard
    too), and the backward saves no mask-sized tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.modules.feed_forward import \
    PositionwiseFeedForward as JaxFeedForward
from lasr_tpu.ops.quant import QuantDense
from lasr_tpu.ops.quant import int8_matmul as jax_int8_matmul
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.modules.dropout import dropout, dropout_generator
from lasr_tpu_torch.modules.feed_forward import PositionwiseFeedForward
from lasr_tpu_torch.modules.layers import Linear
from lasr_tpu_torch.ops.dropout import SeedDropout, seed_dropout
from lasr_tpu_torch.ops.quant import QuantLinear, int8_matmul
from lasr_tpu_torch.utils.weights import (flax_to_state_dict,
                                          load_model_weights)
from tests.torch_port_common import seeded_variables

# tests/test_quant.py's tiny Conformer, dropout off
KW_INT8 = dict(idim=8, odim=11, encoder_attention_dim=16,
               encoder_attention_heads=2, encoder_linear_units=32,
               encoder_num_blocks=2, decoder_attention_dim=16,
               decoder_attention_heads=2, decoder_linear_units=32,
               decoder_num_block=1, encoder_pos_enc_layer_type="rel_pos",
               encoder_selfattention_layer_type="rel_selfattn",
               encoder_cnn_kernel=7, encoder_ff_int8=True,
               encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
               ctc_dropout=0.0)
NOISE_LEAVES = ("conv_module.depthwise_conv.bias", "linear_k.bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("bwd_int8", [True, False])
def test_int8_matmul_matches_lasr_tpu(bwd_int8):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    co = rng.standard_normal((2, 16, 24)).astype(np.float32)
    @jax.jit
    def jax_side(a, b, c):
        y, vjp = jax.vjp(lambda a, b: jax_int8_matmul(a, b, bwd_int8), a, b)
        return (y,) + vjp(c)
    want, wx, ww = jax_side(jnp.asarray(x), jnp.asarray(w), jnp.asarray(co))
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = int8_matmul(tx, tw, bwd_int8)
    got.backward(torch.as_tensor(co))
    assert _rel(got.detach(), want) < 1e-6
    assert _rel(tx.grad, wx) < 1e-6 and _rel(tw.grad, ww) < 1e-6


def test_quant_linear_interops_with_dense():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 40)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    vd = jax.eval_shape(nn.Dense(24).init, key, jnp.asarray(x))
    assert vd == jax.eval_shape(QuantDense(24).init, key, jnp.asarray(x))
    vd = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), vd)
    sd = flax_to_state_dict({"params": {"d": vd["params"]}})
    quant = QuantLinear(40, 24)
    quant.load_state_dict({"weight": sd["d.weight"], "bias": sd["d.bias"]})
    with torch.no_grad():
        got = quant(torch.as_tensor(x))
    want = jax.jit(QuantDense(24).apply)(vd, jnp.asarray(x))
    assert _rel(got, want) < 1e-6
    plain = Linear(40, 24)
    plain.load_state_dict(quant.state_dict())
    quant.load_state_dict(plain.state_dict())
    # the int8 feed-forward of lasr_tpu on the same tree
    ff = JaxFeedForward(40, 24, 0.0, activation=nn.swish, int8=True)
    vf = jax.eval_shape(ff.init, jax.random.PRNGKey(1), jnp.asarray(x))
    vf = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), vf)
    port = PositionwiseFeedForward(40, 24, 0.0, torch.nn.functional.silu,
                                   int8=True)
    load_model_weights(port, {k[len("feed_forward."):]: v for k, v in
                              flax_to_state_dict({"params": {
                                  "feed_forward": vf["params"]}}).items()})
    with torch.no_grad():
        got = port.eval()(torch.as_tensor(x))
    assert _rel(got, jax.jit(ff.apply)(vf, jnp.asarray(x))) < 1e-6


def test_ff_int8_conformer_train_step_matches_lasr_tpu():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 37, 8)).astype(np.float32)
    feat_len = np.asarray([37, 30], np.int32)
    ys = rng.integers(3, 11, (2, 5)).astype(np.int32)
    args = [jnp.asarray(a) for a in (feats, feat_len, ys)]
    fm = jax_models.E2E_Conformer_CTC(**KW_INT8)
    v = seeded_variables(fm, 8, *args)

    def loss(params):
        out, state = fm.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, *args,
                              deterministic=False, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(1)})
        return (jnp.sum(out["ctc_out"] ** 2)
                + jnp.sum(out["att_out"] ** 2)), state

    (want, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    model = E2E_Conformer_CTC(**KW_INT8, device="cpu")
    load_model_weights(model, flax_to_state_dict(v))
    assert isinstance(model.encoder.encoders[0].feed_forward.w_1,
                      QuantLinear)
    model.train()
    with dropout_generator(torch.Generator().manual_seed(0)):
        out = model(*[torch.as_tensor(a) for a in (feats, feat_len)],
                    torch.as_tensor(ys).long())
    got = (out["ctc_out"] ** 2).sum() + (out["att_out"] ** 2).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-4)
    want_g = flax_to_state_dict({"params": grads})
    top = max(float(g.abs().max()) for g in want_g.values())
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want_g[name].numpy()
        if name.endswith(NOISE_LEAVES):
            assert max(np.abs(g).max(), np.abs(w).max()) / top < 2e-4, name
            continue
        assert _rel(g, w) < 2e-4, (name, _rel(g, w))
    sd = model.state_dict()
    for k, w in flax_to_state_dict({"batch_stats":
                                    stats["batch_stats"]}).items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=k)


@pytest.mark.parametrize("shard", [None, (1, 1, 2)])
def test_seed_dropout_is_dropout_without_a_saved_mask(shard):
    x = torch.randn(4, 6, 33, requires_grad=True)
    g = torch.randn(4, 6, 33)
    with dropout_generator(torch.Generator().manual_seed(3)):
        want = dropout(x, 0.3, True, shard)
    saved = []
    with dropout_generator(torch.Generator().manual_seed(3)), \
            torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
        got = seed_dropout(x, 0.3, True, shard)
    assert torch.equal(got, want)
    assert not [t for t in saved if t.numel() >= x.numel()]
    (want_g,) = torch.autograd.grad(want, x, g)
    (got_g,) = torch.autograd.grad(got, x, g)
    assert torch.equal(got_g, want_g)
    if shard is None:
        module = SeedDropout(0.3)
        with dropout_generator(torch.Generator().manual_seed(3)):
            assert torch.equal(module(x), want)
        assert torch.equal(module.eval()(x), x)
