"""Training of the streaming model (``E2E_Transformer_CTC_Online``) in the
port against lasr_tpu, f32, at test_streaming.py's widths (d=16, chunks
16/16/16), on identical weights (lasr_tpu's init, bridged):

  - the train-mode forward (the chunked encoder's layer-major form) and
    ``E2E_Loss`` within 2e-4, every parameter's gradient within 1e-4 of
    the largest gradient, dropout 0 and sigmoid noise 0 (the draws of the
    two packages' generators cannot match);
  - 3 ``Trainer`` steps against lasr_tpu's Trainer: metrics, parameters
    and the EMA shadow within 1e-4 (Adam eps 1e-3, as
    ``test_torch_port_trainer.py`` explains);
  - the monotonic attention's sigmoid noise with one injected draw: the
    choose-probabilities times their survival, and their gradient, within
    1e-5 of lasr_tpu's ``_choose_probs`` given the key the draw came from
    (2e-2 of the largest magnitude in bf16);
  - the port's own draw: from the dropout generator, of the scores' shape,
    mean ~0 and std ~``sigmoid_noise``, repeatable from a seed, none in
    eval mode, and a RuntimeError outside ``dropout_generator``;
  - ``safe_exclusive_cumprod``'s gradient at its clip's boundaries
    (x == 1, the tie) equal to ``jnp.clip``'s;
  - the chunked encoder's ``encoder_layer_major_rows`` and
    ``encoder_conv_once`` against lasr_tpu with the same knobs and
    against the knob-off forward (dropout 0), and ``encoder_remat`` in
    the Transformer, Conformer (rel kernels' plain path) and streaming
    encoders at dropout 0.1 against the plain forward under the same
    generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.losses as jax_losses
from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.models.e2e_online import E2E_Transformer_CTC_Online as JaxOnline
from lasr_tpu.modules.attention import MTMultiHeadedAttention as JaxMT
from lasr_tpu.modules.attention import \
    safe_exclusive_cumprod as jax_cumprod
from lasr_tpu.parallel.mesh import make_mesh
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.modules.attention import (MTMultiHeadedAttention,
                                              safe_exclusive_cumprod)
from lasr_tpu_torch.modules.dropout import dropout_generator
from lasr_tpu_torch.train.optimizer import Adam
from lasr_tpu_torch.train.trainer import METRICS, Trainer
from lasr_tpu_torch.utils.weights import load_model_weights
from tests.torch_port_common import (ONLINE, TOL, batch, f32,
                                     flax_state_dict, labels, pair, t)

NODROP = dict(ONLINE, encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
              ctc_dropout=0.0)     # ONLINE's sigmoid noise is 0 already
STEP_TOL = 1e-4
ADAM = dict(lr=1e-3, eps=1e-3)
CHAIN = ["norm", "fbank:80"]


def test_train_forward_loss_and_gradients():
    fm, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online, NODROP, seed=3,
                     src_bias=0.3)
    x, xlen, ys = batch(odim=NODROP["odim"], seed=13)
    ys_in, att_label, ctc_label = labels(ys)
    V = NODROP["odim"]
    jcrit = jax_losses.E2E_Loss(V, smoothing=0.1, rate=0.3)

    def jax_loss(params):
        out = fm.apply({"params": params}, x, xlen, ys_in,
                       deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        losses = jcrit(out["att_out"], out["ctc_out"],
                       jnp.asarray(att_label), jnp.asarray(ctc_label),
                       out["hs_len"])
        return losses[0], (out, losses)
    (_, (want, want_losses)), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(v["params"])

    pm.train()
    with dropout_generator(torch.Generator().manual_seed(0)):
        got = pm(t(x), t(xlen), t(ys_in).long())
    losses = E2E_Loss(V, smoothing=0.1, rate=0.3)(
        got["att_out"], got["ctc_out"], t(att_label), t(ctc_label),
        got["hs_len"])
    losses[0].backward()
    for k in ("att_out", "ctc_out"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=TOL, err_msg=k)
    for g, w in zip(losses, want_losses):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=TOL)
    want_g = flax_state_dict(grads)
    got_g = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got_g) == set(want_g)
    top = max(float(g.abs().max()) for g in want_g.values())
    for n, w in want_g.items():
        assert got_g[n] is not None, n
        err = float((got_g[n] - w).abs().max())
        assert err <= STEP_TOL * top, (n, err, top)
    # the source attention's score bias is trained
    assert float(got_g["decoder.decoders.0.src_attn.src_att_bias"].abs()
                 .max()) > 1e-3 * top


def _wave_batch(seed=0):
    rng = np.random.default_rng(seed)
    n = np.asarray([16000, 12000, 9600], np.int32)
    wav = (0.2 * rng.standard_normal((3, 16000))).astype(np.float32)
    wav *= np.arange(16000)[None, :] < n[:, None]
    return {"wav_array": wav, "wav_len": n,
            "token_id": rng.integers(3, ONLINE["odim"], (3, 6)).astype(
                np.int32),
            "token_len": np.asarray([6, 4, 5], np.int32)}


def test_three_steps_match_jax_trainer():
    batch_ = _wave_batch()
    V = NODROP["odim"]
    jt = JaxTrainer(JaxOnline(**NODROP),
                    jax_losses.E2E_Loss(V, smoothing=0.1, rate=0.3),
                    JaxAdam(**ADAM).make(), JaxFrontend(CHAIN),
                    mesh=make_mesh(devices=jax.devices()[:1]), use_ema=True,
                    seed=0, log_interval=1)
    jstate = jt.init_state(batch_)
    model = E2E_Transformer_CTC_Online(**NODROP, device="cpu")
    load_model_weights(model, flax_state_dict(jstate.params))
    pt = Trainer(model, E2E_Loss(V, smoothing=0.1, rate=0.3), Adam(**ADAM),
                 DeviceFrontend(CHAIN), use_ema=True, seed=0, log_interval=1,
                 device="cpu")
    pstate = pt.init_state()
    for step in range(3):
        jstate, jm = jt.train_step(jstate, batch_)
        pstate, pmet = pt.train_step(pstate, batch_)
        for k in METRICS:
            np.testing.assert_allclose(pmet[k], float(jm[k]), rtol=STEP_TOL,
                                       atol=STEP_TOL,
                                       err_msg=f"{k} step {step}")
    want = flax_state_dict(jstate.params)
    want_ema = flax_state_dict(jstate.ema["shadow"])
    got = model.state_dict()
    shadow = dict(zip(pt.names, pstate.ema["shadow"]))
    assert set(shadow) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=STEP_TOL,
                                   err_msg=k)
        np.testing.assert_allclose(shadow[k].numpy(), want_ema[k].numpy(),
                                   atol=STEP_TOL, err_msg=k)


# ---- the sigmoid noise ----

NOISE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_injected_noise_monotonic_attention(dtype):
    """One draw, fed to both: lasr_tpu's ``_choose_probs`` given the key
    (it draws ``jax.random.normal(key, shape, dtype)``), the port's
    ``_monotonic`` given that array.  Tolerance: absolute in f32, of the
    largest magnitude in bf16."""
    rng = np.random.default_rng(4)
    B, H, T1, T2 = 3, 2, 5, 11
    scores = (3.0 * rng.standard_normal((B, H, T1, T2))).astype(np.float32)
    scores[0, 0, 0, :4] = -30.0          # choose-probabilities of ~0: 1-p==1
    mask = np.ones((B, 1, T2), bool)
    mask[1, 0, 7:] = False
    mask[2, 0, 3:] = False
    key = jax.random.PRNGKey(7)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jm = JaxMT(2, 16, sigmoid_noise=1.5, dtype=jdt)
    q = np.zeros((B, T1, 16), np.float32)
    variables = jm.init(jax.random.PRNGKey(0), q, q, q)
    w = rng.standard_normal((B, H, T1, T2)).astype(np.float32)

    def jax_attn(s):
        p = jm.apply(variables, s.astype(jdt), jnp.asarray(mask), key,
                     method=jm._choose_probs)
        return p * jax_cumprod(1.0 - p, axis=-1)
    want = jax_attn(jnp.asarray(scores))
    want_grad = jax.grad(lambda s: (jax_attn(s).astype(jnp.float32)
                                    * w).sum())(jnp.asarray(scores))
    noise = jax.random.normal(key, scores.shape, jdt)

    pm = MTMultiHeadedAttention(2, 16, sigmoid_noise=1.5)
    s = t(scores).requires_grad_()
    got = pm._monotonic(s.to(tdt), t(mask),
                        noise=torch.from_numpy(f32(noise)).to(tdt))
    (got.float() * t(w)).sum().backward()
    assert got.dtype == tdt
    err = float(np.abs(f32(got) - f32(want)).max())
    gerr = float(np.abs(s.grad.numpy() - f32(want_grad)).max())
    if dtype == "bfloat16":
        err /= float(np.abs(f32(want)).max())
        gerr /= float(np.abs(f32(want_grad)).max())
    print(f"{dtype}: attention {err:.2e}, gradient {gerr:.2e}")
    assert err <= NOISE_TOL[dtype] and gerr <= NOISE_TOL[dtype]
    # masked keys get nothing
    assert not f32(got)[1, :, :, 7:].any() and not f32(got)[2, :, :, 3:].any()


def test_sigmoid_noise_draws_from_the_dropout_generator():
    sigma = 2.5
    mt = MTMultiHeadedAttention(2, 16, sigmoid_noise=sigma).train()
    drawn = []
    monotonic = mt._monotonic

    def record(scores, mask, noise=None):
        drawn.append(noise)
        return monotonic(scores, mask, noise)
    mt._monotonic = record
    rng = np.random.default_rng(0)
    q = t(rng.standard_normal((4, 6, 16)).astype(np.float32))
    k = t(rng.standard_normal((4, 40, 16)).astype(np.float32))

    def run(seed):
        with dropout_generator(torch.Generator().manual_seed(seed)):
            return mt(q, k, k)
    with torch.no_grad():
        a, b, c = run(5), run(5), run(6)
    n5, n5b, n6 = drawn
    assert n5.shape == (4, 2, 6, 40) and n5.dtype == torch.float32
    assert torch.equal(a, b) and torch.equal(n5, n5b)
    assert not torch.equal(n5, n6) and not torch.equal(a, c)
    scaled = sigma * n5
    assert abs(float(scaled.mean())) < 0.1 * sigma
    assert abs(float(scaled.std()) / sigma - 1.0) < 0.05
    # the draw is what the forward added
    mt.eval()
    with torch.no_grad():
        kk, vv = mt.project_kv(k, k)
        attn = monotonic(mt._scores(mt.project_q(q), kk), None, n5)
        assert torch.equal(mt._out(attn, vv), a)
        drawn.clear()
        plain = mt(q, k, k)            # eval mode draws nothing
    assert drawn == [None] and not torch.equal(plain, a)
    mt.train()
    with pytest.raises(RuntimeError, match="dropout_generator"):
        mt(q, k, k)
    mt.sigmoid_noise = 0.0           # no noise, no draw, no generator
    with torch.no_grad():
        assert torch.equal(mt(q, k, k), plain)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6),
                                        ("bfloat16", 2.0 ** -7)])
def test_cumprod_gradient_at_the_clip_boundaries(dtype, rtol):
    """x == 1 (a choose-probability that rounds to 0) is a tie of the
    clip's upper bound: half the gradient, as jnp.clip gives (``clamp``
    would give twice lasr_tpu's there).  bf16: within one rounding of
    the cumsum (2^-7 relative)."""
    x = np.asarray([[0.5, 1.0, 0.7, 0.2, 1.0],
                    [1.0, 1.0, 0.5, 0.25, 0.9],
                    [0.3, 0.6, 1.0, 0.0, 0.5]], np.float32)
    w = np.arange(1, 6, dtype=np.float32)[None]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.grad(lambda a: (jax_cumprod(a.astype(jdt)).astype(jnp.float32)
                               * w).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_()
    (safe_exclusive_cumprod(xt.to(tdt)).float() * t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=rtol,
                               atol=1e-30)


# ---- the encoders' memory knobs ----

KNOBS = dict(encoder_layer_major_rows=5, encoder_conv_once=True)


def _train_grads(model, x, xlen, ys_in, att_label, ctc_label, seed=0):
    """(att_out, ctc_out, loss, {name: gradient}) of one train-mode
    forward and E2E_Loss backward, dropout from generator ``seed``."""
    model.train()
    model.zero_grad()
    with dropout_generator(torch.Generator().manual_seed(seed)):
        out = model(t(x), t(xlen), t(ys_in).long())
    loss = E2E_Loss(model.ctc[1].out_features, smoothing=0.1, rate=0.3)(
        out["att_out"], out["ctc_out"], t(att_label), t(ctc_label),
        out["hs_len"])[0]
    loss.backward()
    model.eval()
    return (out["att_out"].detach(), out["ctc_out"].detach(),
            float(loss.detach()),
            {n: p.grad.clone() for n, p in model.named_parameters()})


def _same_grads(got, want, tol):
    top = max(float(w.abs().max()) for w in want.values())
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        assert err <= tol * top, (n, err, top)


def test_row_groups_and_conv_once_equal_jax_and_the_plain_forward():
    """``encoder_layer_major_rows`` (5 of 24 chunk rows a group) and
    ``encoder_conv_once`` together, train mode at dropout 0: forward and
    gradients within 2e-4 / 1e-4 of the largest gradient of lasr_tpu
    with the same knobs, and of the port's plain forward; each knob alone
    too."""
    fm, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online,
                     dict(NODROP, **KNOBS), seed=5, src_bias=0.3, jit=True)
    x, xlen, ys = batch(odim=NODROP["odim"], seed=15)
    ys_in, att_label, ctc_label = labels(ys)
    jcrit = jax_losses.E2E_Loss(NODROP["odim"], smoothing=0.1, rate=0.3)

    def jax_loss(params):
        out = fm.apply({"params": params}, x, xlen, ys_in,
                       deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jcrit(out["att_out"], out["ctc_out"], jnp.asarray(att_label),
                     jnp.asarray(ctc_label), out["hs_len"])[0], out
    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(v["params"])
    att, ctc, loss, got_g = _train_grads(pm, x, xlen, ys_in, att_label,
                                         ctc_label)
    np.testing.assert_allclose(att.numpy(), np.asarray(want["att_out"]),
                               atol=TOL)
    np.testing.assert_allclose(ctc.numpy(), np.asarray(want["ctc_out"]),
                               atol=TOL)
    np.testing.assert_allclose(loss, float(want_loss), rtol=TOL)
    _same_grads(got_g, flax_state_dict(grads), STEP_TOL)
    for knobs in ({}, {"encoder_layer_major_rows": 5},
                  {"encoder_conv_once": True}):
        other = E2E_Transformer_CTC_Online(**dict(NODROP, **knobs),
                                           device="cpu")
        other.load_state_dict(pm.state_dict())
        o_att, _, o_loss, o_g = _train_grads(other, x, xlen, ys_in,
                                             att_label, ctc_label)
        np.testing.assert_allclose(o_att.numpy(), att.numpy(), atol=1e-5)
        np.testing.assert_allclose(o_loss, loss, rtol=1e-5)
        _same_grads(o_g, got_g, 1e-5)


def _remat_models(family):
    """(model without remat, the same weights with it, its output
    dimension) at dropout 0.1 in ``family``."""
    from lasr_tpu_torch.models.e2e_ctc_att import (E2E_Conformer_CTC,
                                                   E2E_Transformer_CTC)
    from tests.torch_port_common import OFFLINE, TINY
    drop = dict(encoder_dropout_rate=0.1, decoder_dropout_rate=0.1,
                ctc_dropout=0.1)
    cls, kw = {"transformer": (E2E_Transformer_CTC, OFFLINE),
               "conformer": (E2E_Conformer_CTC,
                             dict(TINY, idim=80, odim=11,
                                  encoder_use_pallas_attention=True)),
               "streaming": (E2E_Transformer_CTC_Online,
                             dict(ONLINE, decoder_src_attention_sigmoid_noise
                                  =1.0))}[family]
    torch.manual_seed(0)
    plain = cls(**kw, **drop, device="cpu")
    remat = cls(**kw, **drop, encoder_remat=True, device="cpu")
    remat.load_state_dict(plain.state_dict())
    return plain, remat


@pytest.mark.parametrize("family", ["transformer", "conformer", "streaming"])
def test_remat_with_dropout_replays_the_draws(family):
    """``encoder_remat`` at dropout 0.1 (and, streaming, the sigmoid
    noise): the loss and every gradient equal the plain forward's under
    the same generator (within 1e-5 of the largest gradient; the
    recompute replays the forward's draws), and BatchNorm's running
    statistics move once."""
    plain, remat = _remat_models(family)
    x, xlen, ys = batch(odim=11, seed=17)
    ys_in, att_label, ctc_label = labels(ys)
    _, _, loss, grads = _train_grads(plain, x, xlen, ys_in, att_label,
                                     ctc_label, seed=3)
    _, _, r_loss, r_grads = _train_grads(remat, x, xlen, ys_in, att_label,
                                         ctc_label, seed=3)
    np.testing.assert_allclose(r_loss, loss, rtol=1e-6)
    _same_grads(r_grads, grads, 1e-5)
    for (n, a), b in zip(plain.named_buffers(), remat.buffers()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   err_msg=n)
    # a different generator draws other masks
    _, _, other, _ = _train_grads(remat, x, xlen, ys_in, att_label,
                                  ctc_label, seed=4)
    assert abs(other - loss) > 1e-4 * abs(loss)
