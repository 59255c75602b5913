"""Losses, schedule and optimizer of the port against lasr_tpu / optax, f32:

  - the CTC log-likelihood and its gradient against
    ``ctc_forward_from_logits`` and ``jax.grad``, with a row whose
    label_len is 0 and an infeasible row (1e-5, relative for the ~-1e30
    infeasible value);
  - ``LabelSmoothingLoss`` and ``E2E_Loss`` values and gradients (1e-5);
  - ``att_accuracy`` and both greedy-CTC CERs exact;
  - ``WarmupScheduler`` at counts 0, 1 and 25000;
  - one clip + Adam update and a two-step ``MultiSteps`` accumulation
    against optax (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lasr_tpu.models import losses as jl
from lasr_tpu.ops.ctc import ctc_forward_from_logits as jax_ctc
from lasr_tpu.ops.ctc import ctc_labels_from_padded as jax_labels
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.optimizer import Noam as JaxNoam
from lasr_tpu.train.optimizer import WarmupScheduler as JaxWarmup
from lasr_tpu_torch.models import losses as pl
from lasr_tpu_torch.ops.ctc import (ctc_forward_from_logits, ctc_loss,
                                    ctc_labels_from_padded)
from lasr_tpu_torch.train.optimizer import (Adam, Noam, WarmupScheduler,
                                            clip_by_global_norm, global_norm)


def _ctc_case(seed=0):
    rng = np.random.default_rng(seed)
    B, T, V, L = 4, 12, 7, 5
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[1, 2] = labels[1, 1]                   # a repeat needs a blank
    label_len = np.asarray([5, 4, 0, 5], np.int32)
    input_len = np.asarray([12, 9, 7, 3], np.int32)  # row 3 is infeasible
    return logits, input_len, labels, label_len


def test_ctc_loglik_and_gradient_match_jax():
    logits, input_len, labels, label_len = _ctc_case()
    want = np.asarray(jax_ctc(*map(jnp.asarray, (logits, input_len, labels,
                                                  label_len))))
    x = torch.from_numpy(logits).requires_grad_()
    got = ctc_forward_from_logits(x, *map(torch.from_numpy,
                                          (input_len, labels, label_len)))
    assert want[3] < -1e29 and got[3].item() < -1e29   # finite, not -inf
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    # the gradient of the feasible rows' summed log-likelihood
    w = np.asarray([1.0, 1.0, 1.0, 0.0], np.float32)
    jgrad = jax.grad(lambda z: jnp.sum(jax_ctc(
        z, *map(jnp.asarray, (input_len, labels, label_len))) * w))(
        jnp.asarray(logits))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=1e-5)
    assert not x.grad[:, :, :].isnan().any()
    # the loss reduction: -sum / B
    loss = ctc_loss(torch.from_numpy(logits[:3]),
                    *[torch.from_numpy(a[:3]) for a in (input_len, labels,
                                                        label_len)])
    np.testing.assert_allclose(loss.item(), -want[:3].sum() / 3, rtol=1e-6)


def test_ctc_labels_from_padded_match_jax():
    pad = np.asarray([[3, -1, 4, -1], [-1, -1, -1, -1], [5, 6, 7, 8]],
                     np.int32)
    for g, w in zip(ctc_labels_from_padded(torch.from_numpy(pad)),
                    jax_labels(jnp.asarray(pad))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _e2e_case(seed=1):
    rng = np.random.default_rng(seed)
    B, L, T, V = 3, 6, 10, 11
    att_out = rng.standard_normal((B, L, V)).astype(np.float32)
    ctc_out = rng.standard_normal((B, T, V)).astype(np.float32)
    att_label = rng.integers(1, V, (B, L)).astype(np.int32)
    att_label[0, 4:] = -1
    att_label[2, 2:] = -1
    att_label[1, 0] = int(np.argmax(att_out[1, 0]))   # one correct token
    ctc_label = np.where(att_label >= 0, att_label, -1).astype(np.int32)
    hs_len = np.asarray([10, 7, 0], np.int32)          # a padding row
    return att_out, ctc_out, att_label, ctc_label, hs_len


def test_label_smoothing_and_e2e_loss_match_jax():
    att_out, ctc_out, att_label, ctc_label, hs_len = _e2e_case()
    V = att_out.shape[-1]
    for norm in (False, True):
        ls_j = jl.LabelSmoothingLoss(V, -1, 0.1, norm)
        ls_p = pl.LabelSmoothingLoss(V, -1, 0.1, norm)
        x = torch.from_numpy(att_out).requires_grad_()
        got = ls_p(x, torch.from_numpy(att_label))
        got.backward()
        want, g = jax.value_and_grad(lambda z: ls_j(
            z, jnp.asarray(att_label)))(jnp.asarray(att_out))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=1e-5)

    crit_j = jl.E2E_Loss(V, smoothing=0.1, rate=0.3)
    crit_p = pl.E2E_Loss(V, smoothing=0.1, rate=0.3)
    a = torch.from_numpy(att_out).requires_grad_()
    c = torch.from_numpy(ctc_out).requires_grad_()
    labels = [torch.from_numpy(z) for z in (att_label, ctc_label, hs_len)]
    got = crit_p(a, c, *labels)
    got[0].backward()

    def main(aa, cc):
        return crit_j(aa, cc, *map(jnp.asarray, (att_label, ctc_label,
                                                  hs_len)))
    want = main(jnp.asarray(att_out), jnp.asarray(ctc_out))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    ga, gc = jax.grad(lambda aa, cc: main(aa, cc)[0], argnums=(0, 1))(
        jnp.asarray(att_out), jnp.asarray(ctc_out))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc), atol=1e-5)

    # train_forward's metrics, with the CER on every step
    data = dict(att_out=att_out, ctc_out=ctc_out, att_label=att_label,
                ctc_label=ctc_label, hs_len=hs_len)
    mj = crit_j.train_forward({k: jnp.asarray(v) for k, v in data.items()})
    mp = crit_p.train_forward({k: torch.from_numpy(v)
                               for k, v in data.items()})
    assert set(mp) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-5)


def test_accuracy_and_cer_are_exact():
    att_out, ctc_out, att_label, ctc_label, hs_len = _e2e_case(2)
    assert float(pl.att_accuracy(torch.from_numpy(att_out),
                                 torch.from_numpy(att_label))) \
        == float(jl.att_accuracy(jnp.asarray(att_out),
                                 jnp.asarray(att_label)))
    # logits whose argmax path repeats and blanks
    rng = np.random.default_rng(5)
    ctc_out = rng.standard_normal((3, 10, 11)).astype(np.float32)
    ctc_out[:, ::3, 0] += 5.0
    dev = pl.ctc_greedy_cer_device(*map(torch.from_numpy,
                                        (ctc_out, ctc_label, hs_len)))
    jdev = jl.ctc_greedy_cer_device(*map(jnp.asarray,
                                         (ctc_out, ctc_label, hs_len)))
    host = pl.ctc_greedy_cer(ctc_out, ctc_label, hs_len)
    # the device versions divide in f32, the host ones in f64
    assert float(dev) == float(jdev) == float(np.float32(host))
    assert host == jl.ctc_greedy_cer(ctc_out, ctc_label, hs_len) > 0.0


def test_warmup_schedule_matches_jax():
    for args in ((320, 3.0, 25000), (256, 1.0, 10, 0.001, 4)):
        ours, theirs = WarmupScheduler(*args), JaxWarmup(*args)
        for count in (0, 1, 25000):
            np.testing.assert_allclose(ours(count),
                                       float(theirs(jnp.int32(count))),
                                       rtol=1e-6)
    assert Noam(320, 3, 25000).make().learning_rate(0) \
        == pytest.approx(3 * 320 ** -0.5 * 25000 ** -1.5, rel=1e-12)


def _tree(rng, scale):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in ((4, 3), (5,), (2, 2, 2))]


@pytest.mark.parametrize("desc,scale", [
    (("adam", dict(lr=1e-3, betas=(0.9, 0.98))), 10.0),   # clipped
    (("adam", dict(lr=1e-2, weight_decay=0.01)), 0.1),     # not clipped
    (("noam", (16, 5.0, 10)), 3.0)])
def test_clip_and_adam_update_match_optax(desc, scale):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng, 1.0), _tree(rng, scale)
    kind, kw = desc
    jd = JaxAdam(**kw) if kind == "adam" else JaxNoam(*kw)
    pd = Adam(**kw) if kind == "adam" else Noam(*kw)
    tx = optax.chain(optax.clip_by_global_norm(5.0), jd.make())
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    upd = pd.make()
    tp = [torch.from_numpy(p.copy()) for p in params]
    pstate = upd.init(tp)
    for step in range(2):
        jg = [jnp.asarray(g * (step + 1)) for g in grads]
        u, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, u)
        tg = [torch.from_numpy(g * (step + 1)) for g in grads]
        np.testing.assert_allclose(float(global_norm(tg)),
                                   float(optax.global_norm(jg)), rtol=1e-6)
        upd.step(tp, clip_by_global_norm(tg, 5.0), pstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_multisteps_accumulation_matches_optax():
    """acc_grads = 2: the running mean of two gradients, clipped, one Adam
    update (the Trainer's accumulation, written out as it does it)."""
    rng = np.random.default_rng(1)
    params, g1, g2 = _tree(rng, 1.0), _tree(rng, 4.0), _tree(rng, 4.0)
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(5.0),
                                      optax.adam(1e-2)), every_k_schedule=2)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g in (g1, g2):
        u, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, u)
    tp = [torch.from_numpy(p.copy()) for p in params]
    upd = Adam(lr=1e-2).make()
    pstate = upd.init(tp)
    acc = [torch.zeros_like(p) for p in tp]
    for n, g in enumerate((g1, g2)):
        acc = [a + (torch.from_numpy(x) - a) / (n + 1)
               for a, x in zip(acc, g)]
    upd.step(tp, clip_by_global_norm(acc, 5.0), pstate)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
