"""The port's ``Trainer.fit`` against lasr_tpu's, and its checkpoint
lifecycle, f32, TINY widths, on seeded WAV corpora written by the tests.

  - ``fit`` of 2 epochs x 2 batches with validation and ``log_interval 1``,
    from the same weights (lasr_tpu's init, bridged), dropout 0, no
    SpecAugment, EMA on, Adam(eps 1e-3, see ``test_torch_port_trainer``)
    under a warmup schedule, in the table and B-train (rel kernels)
    configurations: every ``metrics.jsonl`` line (train and valid: the
    losses, ``att_corr``, ``ctc_cer``, ``grad_norm``, ``lr``) and the final
    weights, BatchNorm statistics and EMA shadow within 1e-4.  Every
    utterance lies inside one 1 s bucket, so lasr_tpu compiles one train
    and one valid step.
  - Kill and resume (the port alone): ``acc_grads 2``, dropout and
    SpecAugment on, a simulated preemption after step 3 (mid-accumulation)
    and ``auto_resume``: weights, Adam moments and count, EMA, step and
    the metrics lines after the kill equal the unbroken run's exactly.
  - Retention: ``last/`` keeps the newest ``checkpoint_keep``, ``best/``
    the lowest ``valid_loss_main``; ``choose="last"`` picks the highest
    steps, across a digit boundary too.
  - The metrics flush of a few pending steps gives lasr_tpu's line, its
    greedy-CER rule for steps that did not compute it included.
"""

import json
import os

import jax
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
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.train.optimizer import Adam, WarmupScheduler
from lasr_tpu_torch.train.trainer import Trainer
from lasr_tpu_torch.utils.weights import (checkpoint_name, checkpoint_steps,
                                          flax_to_state_dict,
                                          load_model_weights,
                                          load_reference_checkpoint)
from tests.helpers import KillAfter
from tests.test_torch_port_cli import write_corpus
from tests.torch_port_common import TINY, numpy_tree

TOL = 1e-4
NODROP = dict(TINY, encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
              ctc_dropout=0.0)
CONFIGS = {"table": {}, "B-train": {"encoder_use_pallas_attention": True}}
CHAIN = ["norm", "fbank:20"]
ADAM = dict(lr=1e-3, eps=1e-3)
WARMUP = dict(model_size=16, factor=1.0, warm_step=10)
# utterances of 0.55-0.95 s and at most 2 words of 3 letters: one 1 s
# sample bucket, one 8-token bucket
SECS = (0.55, 0.95)
# the corpora's CharTokenizer: 6 special ids, 8 letters and the space
ODIM = 15


def _corpus(root, n, seed):
    return write_corpus(str(root), n16=n, n8=0, seed=seed, secs=SECS,
                        n_words=(1, 3), word_len=(1, 4))


def _datasets(cls, tok_cls, train, valid, batch_size, **kw):
    out = []
    for (scp, txt, dict_path), bs in ((train, batch_size), (valid, 3)):
        ds = cls(wav_list=[scp], text_list=[txt],
                 tokenizer=tok_cls(dict_path), audio_trans=kw.get(
                     "audio_trans", CHAIN), batch_type="size",
                 batch_size=bs, min_duration=0.0, text_freq=0.0)
        ds.load_check_data()
        out.append(ds)
    return out


def _lines(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    return _corpus(root / "train", 6, 1), _corpus(root / "dev", 3, 2)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_fit_matches_jax_trainer(config, corpora, tmp_path):
    kw = dict(NODROP, **CONFIGS[config])
    train, valid = corpora
    jtrain, jvalid = _datasets(JaxBatchAudioDataSet, JaxCharTokenizer,
                               train, valid, 3)
    ptrain, pvalid = _datasets(BatchAudioDataSet, CharTokenizer, train,
                               valid, 3)
    assert len(ptrain) == 2 and len(pvalid) == 1
    assert {ptrain.batch_shape(g)[1:] for g in ptrain.batch_indices()} | \
        {pvalid.batch_shape(g)[1:] for g in pvalid.batch_indices()} == \
        {(16000, 8)}
    odim = kw["odim"] = ODIM
    assert CharTokenizer(train[2]).dict_size() == ODIM

    jsched = JaxWarmup(**WARMUP)
    jt = JaxTrainer(jax_models.E2E_Conformer_CTC(**kw),
                    JaxLoss(odim, smoothing=0.1, rate=0.3),
                    JaxAdam(**ADAM).make(jsched), JaxFrontend(CHAIN),
                    exp_dir=str(tmp_path / "jax"), schedule=jsched,
                    mesh=make_mesh(devices=jax.devices()[:1]), use_ema=True,
                    seed=0, log_interval=1)
    jt._tb = False   # no TensorBoard writer: it would import TensorFlow
    jstate = jt.init_state(next(iter(jtrain.batches(num_workers=1))))
    model = E2E_Conformer_CTC(**kw, device="cpu")
    load_model_weights(model, flax_to_state_dict(numpy_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})))
    pt = Trainer(model, E2E_Loss(odim, smoothing=0.1, rate=0.3),
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
        numbers = [k for k in w if k not in ("epoch", "step", "wall_s",
                                              "data_wait_s", "dispatch_s")]
        assert "lr" in numbers or "valid_loss_main" in numbers
        for k in numbers:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{k} at step {w['step']}")

    assert pstate.step == int(jstate.step) == 4
    want_sd = flax_to_state_dict(numpy_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    want_ema = flax_to_state_dict(numpy_tree(
        {"params": jstate.ema["shadow"]}))
    got_sd = model.state_dict()
    shadow = dict(zip(pt.names, pstate.ema["shadow"]))
    for k, v in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), atol=TOL,
                                   err_msg=k)
        if k in shadow:
            np.testing.assert_allclose(shadow[k].numpy(),
                                       want_ema[k].numpy(), atol=TOL,
                                       err_msg=k)
    # the port's checkpoints of the run: both epochs, both directories
    root = tmp_path / "port" / "checkpoints"
    for sub in ("last", "best"):
        assert sorted(checkpoint_steps(str(root / sub))) == [2, 4]


def _resume_trainer(exp_dir, init):
    """A port Trainer with dropout and SpecAugment on, acc_grads 2, its
    model at the weights ``init``."""
    torch.manual_seed(0)
    model = E2E_Conformer_CTC(**dict(TINY, odim=ODIM), device="cpu")
    model.load_state_dict(init)
    chain = ["norm", "fbank:20", "specaug"]
    return Trainer(model, E2E_Loss(ODIM, smoothing=0.1, rate=0.3),
                   Adam(lr=1e-3), DeviceFrontend(chain), exp_dir=exp_dir,
                   schedule=None, use_ema=True, acc_grads=2, seed=3,
                   log_interval=1, device="cpu"), chain


def test_kill_and_resume_equals_unbroken_run(tmp_path):
    train = _corpus(tmp_path / "train", 8, 3)
    valid = _corpus(tmp_path / "dev", 3, 4)
    torch.manual_seed(0)
    init = E2E_Conformer_CTC(**dict(TINY, odim=ODIM),
                             device="cpu").state_dict()

    def run(exp, dataset_wrap=lambda ds: ds, **kw):
        trainer, chain = _resume_trainer(str(tmp_path / exp), init)
        ds, dv = _datasets(BatchAudioDataSet, CharTokenizer, train, valid,
                           2, audio_trans=chain)
        state = trainer.fit(trainer.init_state(), dataset_wrap(ds), dv,
                            num_epochs=2, num_workers=2, **kw)
        return trainer, state

    full, s_full = run("straight")
    assert s_full.step == 8 and s_full.opt_state["count"] == 4
    with pytest.raises(RuntimeError, match="simulated preemption"):
        run("killed", lambda ds: KillAfter(ds, 3),
            checkpoint_interval_steps=1)
    killed_root = str(tmp_path / "killed" / "checkpoints" / "last")
    assert max(checkpoint_steps(killed_root)) == 3
    mid, _ = _resume_trainer(str(tmp_path / "killed"), init)
    s_mid = mid.restore_checkpoint(step=3)
    assert s_mid.mini_step == 1 and s_mid.acc_grads is not None
    assert s_mid.opt_state["count"] == 1

    resumed, s_res = run("killed", auto_resume=True)
    assert s_res.step == s_full.step
    assert s_res.mini_step == s_full.mini_step == 0
    assert s_res.opt_state["count"] == s_full.opt_state["count"]
    assert s_res.ema["num_updates"] == s_full.ema["num_updates"] == 8
    for name, a, b in zip(full.names, full.params, resumed.params):
        assert torch.equal(a, b), name
    for key in ("mu", "nu"):
        for a, b in zip(s_full.opt_state[key], s_res.opt_state[key]):
            assert torch.equal(a, b), key
    for a, b in zip(s_full.ema["shadow"], s_res.ema["shadow"]):
        assert torch.equal(a, b)
    for k, v in full.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    # every step after the kill logs what the unbroken run logged
    drop = ("wall_s", "data_wait_s", "dispatch_s")

    def after_kill(exp):
        return [{k: v for k, v in x.items() if k not in drop}
                for x in _lines(tmp_path / exp) if x["step"] > 3]
    assert after_kill("killed") == after_kill("straight")


def test_last_and_best_retention(tmp_path):
    train = _corpus(tmp_path / "train", 3, 5)
    valid = _corpus(tmp_path / "dev", 3, 6)
    torch.manual_seed(1)
    model = E2E_Conformer_CTC(**dict(NODROP, odim=ODIM), device="cpu")
    trainer = Trainer(model, E2E_Loss(ODIM), Adam(lr=3e-2),
                      DeviceFrontend(CHAIN), exp_dir=str(tmp_path / "exp"),
                      use_ema=True, log_interval=1, checkpoint_keep=3,
                      device="cpu")
    ds, dv = _datasets(BatchAudioDataSet, CharTokenizer, train, valid, 1)
    state = trainer.fit(trainer.init_state(), ds, dv, num_epochs=4,
                        num_workers=1, checkpoint_interval_steps=1)
    assert state.step == 12
    root = tmp_path / "exp" / "checkpoints"
    assert sorted(checkpoint_steps(str(root / "last"))) == [10, 11, 12]
    valid_loss = {x["step"]: x["valid_loss_main"]
                  for x in _lines(tmp_path / "exp") if "valid_loss_main" in x}
    assert sorted(valid_loss) == [3, 6, 9, 12]
    best = sorted(valid_loss, key=valid_loss.get)[:3]
    assert sorted(checkpoint_steps(str(root / "best"))) == sorted(best)
    with open(root / "best" / "valid_loss.json") as f:
        index = json.load(f)
    assert index == {checkpoint_name(s): valid_loss[s] for s in best}
    with open(root / "loop_state.json") as f:
        loop = json.load(f)
    assert loop["12"] == [4, 0] and loop["11"] == [3, 2]
    # Adam's state is in torch.optim.Adam's layout
    blob = torch.load(root / "last" / checkpoint_name(12),
                      weights_only=False)
    adam = torch.optim.Adam(model.parameters())
    adam.load_state_dict(blob["optimizer_states"][0])
    first = adam.state[next(iter(model.parameters()))]
    assert torch.equal(first["exp_avg"], state.opt_state["mu"][0])
    assert int(first["step"]) == state.opt_state["count"] == 12
    # the newest checkpoint is the final state; "last" averages the
    # highest steps
    newest = load_reference_checkpoint(str(root), "last", avg=1)
    for name, s in zip(trainer.names, state.ema["shadow"]):
        assert torch.equal(newest[name], s), name
    three = load_reference_checkpoint(str(root), "last", avg=3)
    parts = [load_reference_checkpoint(
        str(root / "last" / checkpoint_name(s))) for s in (10, 11, 12)]
    for name in trainer.names:
        want = sum(p[name].double() for p in parts) / 3
        torch.testing.assert_close(three[name], want.float(), rtol=0,
                                   atol=1e-7)


def test_choose_last_loads_the_highest_step_across_digits(tmp_path):
    """Checkpoints of steps 9 and 10: ``choose="last", avg=1`` must load
    step 10, whose name an unpadded filename sort puts first."""
    torch.manual_seed(2)
    model = E2E_Conformer_CTC(**NODROP, device="cpu")
    trainer = Trainer(model, E2E_Loss(TINY["odim"]), Adam(lr=1e-2),
                      DeviceFrontend(CHAIN), exp_dir=str(tmp_path),
                      device="cpu")
    state = trainer.init_state()
    state.step = 9
    trainer.save_checkpoint(state)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    state.step = 10
    trainer.save_checkpoint(state)
    root = str(tmp_path / "checkpoints")
    loaded = load_reference_checkpoint(root, "last", avg=1)
    for name, p in model.named_parameters():
        assert torch.equal(loaded[name], p.detach()), name
    restored = trainer.restore_checkpoint()
    assert restored.step == 10


@pytest.mark.parametrize("steps,acc_grads", [
    ((1, 2, 3), 1),      # the last step computed ctc_cer
    ((4, 5), 1),         # none did: the key is left out
    ((5, 6, 7), 2),      # an earlier one did; lr of step // acc_grads
])
def test_metrics_flush_matches_jax(steps, acc_grads, tmp_path):
    """``_flush_metrics`` on the same pending steps: the same line, the
    greedy-CER rule for a ``ctc_cer_interval`` of 3 included."""
    interval = 3
    rng = np.random.default_rng(sum(steps))
    pending = []
    for s in steps:
        m = {k: float(rng.uniform(0.5, 2.0))
             for k in ("loss_main", "att_loss", "ctc_loss", "att_corr",
                       "grad_norm")}
        m["ctc_cer"] = float(rng.uniform(0, 1)) if s % interval == 0 else -1.0
        pending.append((s, m, 3))
    lines = []
    for which in ("jax", "port"):
        loss = (JaxLoss if which == "jax" else E2E_Loss)(ODIM)
        loss.ctc_cer_interval = interval
        trainer = object.__new__(JaxTrainer if which == "jax" else Trainer)
        trainer.criterion, trainer.acc_grads = loss, acc_grads
        trainer.schedule = (JaxWarmup if which == "jax"
                            else WarmupScheduler)(**WARMUP)
        trainer.exp_dir, trainer._tb = None, None
        (tmp_path / which).mkdir()
        path = str(tmp_path / which / "metrics.jsonl")
        rows = pending if which == "port" else [
            (s, m, n, s) for s, m, n in pending]
        trainer._flush_metrics(rows, 0, path, 0.0, 0.5, 1.5)
        lines.append(_lines(tmp_path / which)[0])
    want, got = lines
    assert set(got) == set(want)
    assert ("ctc_cer" in got) == any(s % interval == 0 for s in steps)
    for k, v in want.items():
        if k != "wall_s":
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
