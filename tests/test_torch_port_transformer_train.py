"""Training of the offline Transformer (``E2E_Transformer_CTC``, the toy
recipe's ``config.yaml`` model) in the port against lasr_tpu, at
test_streaming.py's widths (d=16, 2 + 2 blocks, fbank:80), from the same
weights (lasr_tpu's init, bridged), dropout 0, no SpecAugment:

  - 3 ``Trainer`` steps with the conv2d and the linear input layer: every
    metric, the parameters and the EMA shadow within 1e-4 (Adam eps 1e-3,
    as ``test_torch_port_trainer.py`` explains);
  - ``fit`` of 2 epochs x 2 batches with validation (conv2d): every
    ``metrics.jsonl`` line and the final weights within 1e-4, as
    ``test_torch_port_fit.py`` holds the Conformer;
  - one bf16 step (``dtype=bfloat16`` in both packages): the loss within
    1e-2 relative, the gradients within 5e-2 relative L2 per parameter
    group (the input layer, each block, the norms and heads), the key
    biases, whose true gradient is 0, ~0 against the largest gradient;
    the port's step leaves parameters, Adam state and EMA float32.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.data.dataset import BatchAudioDataSet as JaxBatchAudioDataSet
from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from lasr_tpu.models.losses import E2E_Loss as JaxLoss
from lasr_tpu.parallel.mesh import make_mesh
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.optimizer import WarmupScheduler as JaxWarmup
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu_torch.data.dataset import BatchAudioDataSet
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.data.tokenizer import CharTokenizer
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Transformer_CTC
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.train.optimizer import Adam, WarmupScheduler
from lasr_tpu_torch.train.trainer import METRICS, Trainer
from lasr_tpu_torch.utils.weights import load_model_weights
from tests.test_torch_port_fit import _corpus, _datasets, _lines
from tests.torch_port_common import OFFLINE, flax_state_dict, jax_grad

TOL = 1e-4
GRAD_TOL = 5e-2      # bf16: relative L2 per parameter group
NODROP = dict(OFFLINE, encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
              ctc_dropout=0.0)
CHAIN = ["norm", "fbank:80"]
ADAM = dict(lr=1e-3, eps=1e-3)
WARMUP = dict(model_size=16, factor=1.0, warm_step=10)
ZERO_GRADIENT = "linear_k.bias"    # the softmax removes q·b_k


def _batch(seed=0, odim=OFFLINE["odim"]):
    rng = np.random.default_rng(seed)
    n = np.asarray([12800, 9600, 11000], np.int32)
    wav = (0.2 * rng.standard_normal((3, 12800))).astype(np.float32)
    wav *= np.arange(12800)[None, :] < n[:, None]
    return {"wav_array": wav, "wav_len": n,
            "token_id": rng.integers(3, odim, (3, 6)).astype(np.int32),
            "token_len": np.asarray([6, 4, 5], np.int32)}


def _trainers(kw, dtype=None, sample=None, schedule=None, exp_dir=None):
    """(lasr_tpu's Trainer and its initial state from ``sample``, the
    port's model on the same weights)."""
    jdt = {} if dtype is None else {"dtype": jnp.bfloat16}
    jt = JaxTrainer(jax_models.E2E_Transformer_CTC(**kw, **jdt),
                    JaxLoss(kw["odim"], smoothing=0.1, rate=0.3),
                    JaxAdam(**ADAM).make(schedule), JaxFrontend(CHAIN),
                    exp_dir=exp_dir, schedule=schedule,
                    mesh=make_mesh(devices=jax.devices()[:1]), use_ema=True,
                    seed=0, log_interval=1)
    jt._tb = False   # no TensorBoard writer: it would import TensorFlow
    jstate = jt.init_state(_batch() if sample is None else sample)
    model = E2E_Transformer_CTC(**kw, dtype=dtype, device="cpu")
    load_model_weights(model, flax_state_dict(jstate.params))
    return jt, jstate, model


@pytest.mark.parametrize("input_layer", ["conv2d", "linear"])
def test_three_steps_match_jax_trainer(input_layer):
    kw = dict(NODROP, encoder_input_layer=input_layer)
    jt, jstate, model = _trainers(kw)
    pt = Trainer(model, E2E_Loss(kw["odim"], smoothing=0.1, rate=0.3),
                 Adam(**ADAM), DeviceFrontend(CHAIN), use_ema=True, seed=0,
                 log_interval=1, device="cpu")
    batch = _batch()
    pstate = pt.init_state()
    for step in range(3):
        jstate, jm = jt.train_step(jstate, batch)
        pstate, pm = pt.train_step(pstate, batch)
        for k in METRICS:
            np.testing.assert_allclose(pm[k], float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{k} step {step}")
    want = flax_state_dict(jstate.params)
    want_ema = flax_state_dict(jstate.ema["shadow"])
    got = model.state_dict()
    shadow = dict(zip(pt.names, pstate.ema["shadow"]))
    assert set(got) == set(want) == set(shadow)
    if input_layer == "linear":
        assert "encoder.embed_linear.weight" in got
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=TOL,
                                   err_msg=k)
        np.testing.assert_allclose(shadow[k].numpy(), want_ema[k].numpy(),
                                   atol=TOL, err_msg=k)


# the fit corpora: test_torch_port_fit.py's (one 1 s bucket, 15 ids)
ODIM = 15


def test_fit_matches_jax_trainer(tmp_path):
    train = _corpus(tmp_path / "train", 6, 1)
    valid = _corpus(tmp_path / "dev", 3, 2)
    kw = dict(NODROP, odim=ODIM)
    jtrain, jvalid = _datasets(JaxBatchAudioDataSet, JaxCharTokenizer,
                               train, valid, 3, audio_trans=CHAIN)
    ptrain, pvalid = _datasets(BatchAudioDataSet, CharTokenizer, train,
                               valid, 3, audio_trans=CHAIN)
    assert len(ptrain) == 2 and len(pvalid) == 1
    jsched = JaxWarmup(**WARMUP)
    jt, jstate, model = _trainers(
        kw, sample=next(iter(jtrain.batches(num_workers=1))),
        schedule=jsched, exp_dir=str(tmp_path / "jax"))
    pt = Trainer(model, E2E_Loss(ODIM, smoothing=0.1, rate=0.3),
                 Adam(**ADAM), DeviceFrontend(CHAIN),
                 exp_dir=str(tmp_path / "port"),
                 schedule=WarmupScheduler(**WARMUP), use_ema=True, seed=0,
                 log_interval=1, device="cpu")
    jstate = jt.fit(jstate, jtrain, jvalid, num_epochs=2, num_workers=2,
                    save_checkpoints=False)
    pstate = pt.fit(pt.init_state(), ptrain, pvalid, num_epochs=2,
                    num_workers=2)
    want, got = _lines(tmp_path / "jax"), _lines(tmp_path / "port")
    assert [(x["epoch"], x["step"]) for x in got] == \
        [(x["epoch"], x["step"]) for x in want] == \
        [(0, 1), (0, 2), (0, 2), (1, 3), (1, 4), (1, 4)]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            if k not in ("epoch", "step", "wall_s", "data_wait_s",
                         "dispatch_s"):
                np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                           err_msg=f"{k} at step {w['step']}")
    assert pstate.step == int(jstate.step) == 4
    want_sd = flax_state_dict(jstate.params)
    got_sd = model.state_dict()
    for k, v in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=TOL,
                                   err_msg=k)


def _group(name):
    p = name.split(".")
    return ".".join(p[:3] if p[1] in ("encoders", "decoders") else p[:2])


def _rel_l2_by_group(names, got, want):
    num, den = collections.defaultdict(float), collections.defaultdict(float)
    for n in names:
        num[_group(n)] += float((got[n] - want[n]).double().norm() ** 2)
        den[_group(n)] += float(want[n].double().norm() ** 2)
    return {g: (num[g] / den[g]) ** 0.5 for g in num}


def test_one_bf16_step_matches_jax_trainer():
    jt, jstate, model = _trainers(NODROP, dtype=torch.bfloat16)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    pt = Trainer(model, E2E_Loss(NODROP["odim"], smoothing=0.1, rate=0.3),
                 Adam(**ADAM), DeviceFrontend(CHAIN), use_ema=True, seed=0,
                 log_interval=1, device="cpu")
    batch = _batch()
    metrics, grads = pt.loss_and_grads(batch, 0)
    assert metrics["loss_main"].dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)
    got = dict(zip(pt.names, grads))
    loss, want = jax_grad(jt, jstate, batch, with_loss=True)
    np.testing.assert_allclose(float(metrics["loss_main"].detach()),
                               float(loss), rtol=1e-2)
    want = flax_state_dict(want)
    real = [n for n in pt.names if not n.endswith(ZERO_GRADIENT)]
    largest = max(float(g.abs().max()) for g in grads)
    for n in set(pt.names) - set(real):
        assert float(got[n].abs().max()) < 1e-3 * largest, n
    errs = _rel_l2_by_group(real, got, want)
    print("gradients", {g: round(e, 4) for g, e in errs.items()})
    assert len(errs) == 10 and max(errs.values()) < GRAD_TOL, errs

    model.load_state_dict(start)
    pstate, _ = pt.train_step(pt.init_state(), batch)
    assert any(not torch.equal(start[n], p) for n, p in
               model.state_dict().items())
    floats = list(model.state_dict().values()) + pstate.opt_state["mu"] \
        + pstate.opt_state["nu"] + pstate.ema["shadow"]
    assert all(x.dtype == torch.float32 for x in floats)
