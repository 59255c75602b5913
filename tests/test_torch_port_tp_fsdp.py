"""Tensor parallelism and FSDP in the port (``lasr_tpu_torch/parallel``:
``tensor.py``, ``sharding.py``, the grid of ``dist.py``) on the CPU:
``gloo`` ranks, each a process of its own started by
``tests/torch_port_dp_worker.py`` (JAX-free), at small widths (2
Conformer blocks of d=32, 2 heads, 2 decoder blocks, a vocabulary of 10).

  - 2 ranks with ``model_parallel`` 2, 2 with FSDP, 4 with dp2 x tp2 and
    FSDP, each against the one-process step on the same global batch
    (dropout 0, SpecAugment on): every metric, the first batch's
    gradient, the updated weights, the BatchNorm statistics and the EMA
    shadow within 1e-5 (PR 12's bar for data parallelism; the leaves
    whose true gradient is 0 ~0 on both sides), the ranks' whole results
    bitwise equal.  FSDP shards every leaf of >= 2 dims here
    (``fsdp_min_size`` 0, as ``lasr_tpu``'s FSDP tests).  Tensor
    parallelism reorders the sums of every split layer, forward and
    backward, and at these widths float32's rounding, amplified ~1000x by
    the model's conditioning (the same steps in float64 agree to ~1e-13),
    moves gradients up to ~1e-4 (relative L2; with this vocabulary of 10
    even the data-parallel reorder reaches 1.5e-5): so the three layouts
    run with the whole computation widened to float64 (``-f64``) and hold
    everything within 1e-5, and the 4-rank layout also runs in float32,
    its gradients within 3e-4 and everything else within 1e-5.
  - 4 ranks (dp2 x tp2 + FSDP) against ``lasr_tpu``'s ``Trainer`` on
    ``make_mesh(data=2, model=2)`` with ``partition_params`` and
    ``fsdp_params``, 3 steps, and each rank's shard of every leaf the
    shape of that leaf's shard under ``lasr_tpu``'s specs.  That mesh's
    own results are up to 3.7e-4 from ``lasr_tpu``'s one-device step
    (``grad_norm`` at step 2; the depthwise conv's weights 2.8e-4: XLA's
    split sums, the same amplification), while the port's one process is
    within 1.2e-7 of it: so every metric, the parameters, the BatchNorm
    statistics and the EMA shadow are held within 1e-4 of ``lasr_tpu``'s
    one-device ``Trainer`` and within 1e-3 of its mesh.
  - ``python -m lasr_tpu_torch.bin.train -fsdp 1 -model_parallel 2
    -num_devices 2 -device cpu``: rank 0 alone writes one tree of whole
    reference checkpoints, which the ``ASRProcess`` of both packages read
    to the same tokens, and a run resumes across layouts (written sharded,
    resumed as one process, and the reverse) to the uninterrupted one-
    process run's losses within 1e-4.

Every multi-process case runs under its own timeout
(``torch_port_dp_worker.TIMEOUT_S``), which kills its process group.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import lasr_tpu.models.e2e_ctc_att as jax_models
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.sharding import PartitionSpec as P
from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.models.losses import E2E_Loss as JaxLoss
from lasr_tpu.parallel.mesh import make_mesh
from lasr_tpu.parallel.sharding import _leaf_spec
from lasr_tpu.process.asrprocess import ASRProcess as JaxASRProcess
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu_torch.data.reader import write_wav
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.parallel import sharding
from lasr_tpu_torch.process.asrprocess import ASRProcess
from lasr_tpu_torch.utils.weights import checkpoint_steps
from tests.test_torch_port_cli import (TINY_CONFORMER, write_config,
                                       write_corpus)
from tests.torch_port_common import flax_state_dict
from tests.torch_port_dp_worker import (KW, Worker, assert_step_equal,
                                        build_trainer, float64_everywhere,
                                        layout_result, one_process_results,
                                        start_one_process, start_ranks,
                                        wav_batch)

ADAM = dict(lr=1e-3, eps=1e-3)
# the vocabulary divides over 2 model ranks, so the embedding and the
# logits heads split too
KW_TP = dict(KW, odim=10)
LAYOUTS = {
    "tp2-f64": dict(ranks=2, model_parallel=2, float64=True),
    "fsdp2-f64": dict(ranks=2, fsdp=True, fsdp_min_size=0, float64=True),
    "dp2xtp2_fsdp-f64": dict(ranks=4, model_parallel=2, fsdp=True,
                             fsdp_min_size=0, float64=True),
    "dp2xtp2_fsdp": dict(ranks=4, model_parallel=2, fsdp=True,
                         fsdp_min_size=0),
}
# float32 gradients of the split steps (see the module docstring)
F32_GRAD_TOL = 3e-4


def _layout_spec(layout):
    """The spec of a layout of LAYOUTS, with the port's initial weights
    (float64 where the layout says)."""
    grid = LAYOUTS[layout]
    spec = dict(kw=KW_TP, chain=["norm", "fbank:20", "specaug"], adam=ADAM,
                acc_grads=2 if layout.startswith("dp2xtp2") else 1,
                device="cpu", batches=[wav_batch(0, 3, 3),
                                       wav_batch(1, 4, 4)], **grid)
    float64_everywhere(bool(grid.get("float64")))
    try:
        torch.manual_seed(0)
        model, _ = build_trainer(dict(spec, fsdp=False), "cpu")
    finally:
        float64_everywhere(False)
    spec["init"] = {k: v.clone() for k, v in model.state_dict().items()}
    return spec


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Two process groups, of 2 and 4 ranks, each running its layouts of
    LAYOUTS in turn (the 4-rank one then lasr_tpu's mesh batches on its
    weights); the port's one-process steps (in a process of their own)
    and lasr_tpu's Trainers run meanwhile."""
    specs = {name: _layout_spec(name) for name in LAYOUTS}
    tmp = {n: str(tmp_path_factory.mktemp(f"ranks{n}")) for n in (1, 2, 4)}
    # one thread: beside the other xdist workers a thread a core stalls it
    # past TIMEOUT_S (start_one_process)
    one_worker = start_one_process(tmp[1], [
        (spec, ("pad", spec["ranks"] // spec.get("model_parallel", 1)),
         None) for spec in specs.values()], threads=1)
    chain = ["norm", "fbank:20"]
    batches = [wav_batch(2, 4, 4), wav_batch(3, 3, 4), wav_batch(2, 4, 4)]
    jt = JaxTrainer(jax_models.E2E_Conformer_CTC(**KW_TP),
                    JaxLoss(KW_TP["odim"], smoothing=0.1, rate=0.3),
                    JaxAdam(**ADAM).make(), JaxFrontend(chain),
                    mesh=make_mesh(data=2, model=2,
                                   devices=jax.devices()[:4]),
                    partition_params=True, fsdp_params=True,
                    fsdp_min_size=0, use_ema=True, seed=0, log_interval=1)
    jstate = jt.init_state(batches[0])
    mesh = dict(kw=KW_TP, chain=chain, adam=ADAM, acc_grads=1, device="cpu",
                batches=batches, ranks=4, model_parallel=2, fsdp=True,
                fsdp_min_size=0,
                init=flax_state_dict(jstate.params, jstate.batch_stats))
    members = {n: [name for name in LAYOUTS if LAYOUTS[name]["ranks"] == n]
               for n in (2, 4)}
    workers = {n: start_ranks(tmp[n], dict(ranks=n, device="cpu", layouts=[
        specs[name] for name in members[n]] + ([mesh] if n == 4 else [])))
        for n in (2, 4)}
    one = JaxTrainer(jax_models.E2E_Conformer_CTC(**KW_TP),
                     JaxLoss(KW_TP["odim"], smoothing=0.1, rate=0.3),
                     JaxAdam(**ADAM).make(), JaxFrontend(chain),
                     mesh=make_mesh(data=1, devices=jax.devices()[:1]),
                     use_ema=True, seed=0, log_interval=1)
    one_state = one.init_state(batches[0])
    want_shapes = _jax_shard_shapes(jstate.params)
    jmetrics, one_metrics = [], []
    for b in batches:
        jstate, m = jt.train_step(jstate, b)
        jmetrics.append({k: float(v) for k, v in m.items()})
        one_state, m = one.train_step(one_state, b)
        one_metrics.append({k: float(v) for k, v in m.items()})
    wants = dict(zip(specs, one_process_results(tmp[1], one_worker,
                                                len(specs))))
    got = {}
    for n, worker in workers.items():
        rc, out = worker.wait()
        assert rc == 0, out[-6000:]
        for i, name in enumerate(members[n]):
            got[name] = layout_result(tmp[n], n, f"_{i}")
    mesh_got = layout_result(tmp[4], 4, f"_{len(members[4])}")
    return ({name: (got[name], wants[name], specs[name]["init"])
             for name in LAYOUTS},
            (mesh_got, want_shapes, jmetrics, one_metrics, jstate,
             one_state))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_ranks_equal_one_process(layout, groups):
    grid = LAYOUTS[layout]
    data = grid["ranks"] // grid.get("model_parallel", 1)
    got, want, init = groups[0][layout]
    loose = None if grid.get("float64") else {"": F32_GRAD_TOL}
    assert_step_equal(got, want, loose=loose)
    moved = [k for k, w in want["state_dict"].items()
             if not torch.equal(w, init[k])]
    assert len(moved) > len(want["names"]) // 2
    # the layout split what it should
    shapes = got["shard_shapes"]
    if grid.get("fsdp"):
        assert shapes["encoder.encoders.0.feed_forward.w_1.weight"][1] \
            == 32 // data
    if grid.get("model_parallel"):
        assert shapes["decoder.embed.0.weight"][0] == 10 // 2


def _jax_shard_shapes(params):
    """The torch-named shape of each leaf's shard under its sharding."""
    shards = jax.tree.map(
        lambda x: np.zeros(x.sharding.shard_shape(x.shape), np.float32),
        params)
    return {k: tuple(v.shape) for k, v in flax_state_dict(shards).items()}


def test_four_ranks_equal_lasr_tpu_mesh_step(groups):
    got, want_shapes, jmetrics, one_metrics, jstate, one_state = groups[1]
    assert got["shard_shapes"] == want_shapes
    for i, (g, w, w1) in enumerate(zip(got["steps"], jmetrics,
                                       one_metrics)):
        for k in g:
            np.testing.assert_allclose(g[k], w1[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k} step {i}")
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, atol=1e-3,
                                       err_msg=f"{k} step {i} (mesh)")
    shadow = dict(zip(got["names"], got["ema"]))
    for st, tol in ((one_state, 1e-4), (jstate, 1e-3)):
        want = flax_state_dict(st.params, st.batch_stats)
        want_ema = flax_state_dict(st.ema["shadow"])
        assert any(k.endswith("norm.running_var") for k in want)
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(got["state_dict"][k].numpy(),
                                       v.numpy(), atol=tol, err_msg=k)
            if k in shadow:
                np.testing.assert_allclose(shadow[k].numpy(),
                                           want_ema[k].numpy(), atol=tol,
                                           err_msg=f"EMA of {k}")


def test_specs_follow_lasr_tpu_rules_at_the_default_size():
    """At ``FSDP_MIN_SIZE`` the small leaves stay whole; the rest split
    as ``lasr_tpu``'s ``_leaf_spec`` splits them (the 1B config's
    feed-forward kernel: P('data', 'model'))."""
    kw = dict(KW_TP, encoder_attention_dim=128, encoder_linear_units=512,
              decoder_attention_dim=128, decoder_linear_units=512,
              encoder_attention_heads=4, decoder_attention_heads=4,
              odim=64)
    model = E2E_Conformer_CTC(**kw, device="cpu")
    specs = sharding.param_specs(model, model_size=2, data_size=2,
                                 fsdp=True)
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    jm = jax_models.E2E_Conformer_CTC(**kw)
    x = jax.numpy.zeros((1, 64, 20))
    variables = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x, jax.numpy.asarray([64]),
        jax.numpy.zeros((1, 4), jax.numpy.int32)))
    shards = {}
    for path, leaf in flatten_dict(variables["params"]).items():
        spec = _leaf_spec(path, leaf, mesh, True, True,
                          sharding.FSDP_MIN_SIZE)
        shape = [n // (2 if axis else 1)
                 for n, axis in zip(leaf.shape, tuple(spec)
                                    + (None,) * (leaf.ndim - len(spec)))]
        shards[path] = np.zeros(shape, np.float32)
        if path == ("encoder", "layers_0", "feed_forward", "Dense_0",
                    "kernel"):
            assert spec == P("data", "model")
    want = {k: tuple(v.shape) for k, v in flax_state_dict(
        unflatten_dict(shards)).items()}
    for name, p in model.named_parameters():
        s = specs[name]
        shape = list(p.shape)
        if s.tp is not None:
            shape[s.tp] //= 2
        if s.fsdp is not None:
            shape[s.fsdp] //= 2
        assert tuple(shape) == want[name], name
    assert specs["encoder.encoders.0.conv_module.depthwise_conv.weight"] \
        == sharding.Spec(None, None)


def _tokens_of_both(exp, tmp_path, wav):
    """(port tokens, lasr_tpu tokens) of ``wav`` from exp's newest
    checkpoint, through each package's ASRProcess."""
    with open(tmp_path / "decode.yaml", "w") as f:
        yaml.safe_dump({"decode_config": {"decode_method": "ctc_att",
                                          "beam": 3, "ctc_beam": 4,
                                          "ctc_weight": 0.5, "lm_rate": 0},
                        "test_data_config": {"kwargs": {
                            "audio_trans": ["norm", "fbank:20"]}}}, f)
    last = os.path.join(exp, "checkpoints", "last")
    steps = checkpoint_steps(last)
    args = (os.path.join(exp, "hparams.yaml"), str(tmp_path / "decode.yaml"),
            os.path.join(last, steps[max(steps)]))
    return ASRProcess(*args, device="cpu")(wav), JaxASRProcess(*args)(wav)


def test_train_cli_sharded_writes_whole_checkpoints_and_resumes_anywhere(
        tmp_path):
    train = write_corpus(str(tmp_path / "train"), n16=8, n8=0, seed=31,
                         secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))
    valid = write_corpus(str(tmp_path / "dev"), n16=2, n8=0, seed=32,
                         secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))
    config = write_config(str(tmp_path / "config.yaml"), train, valid,
                          dict(TINY_CONFORMER, encoder_dropout_rate=0.0,
                               decoder_dropout_rate=0.0, ctc_dropout=0.0),
                          train_batch=4, valid_batch=2)
    base = ["-config", config, "-ema", "1", "-log_interval", "1",
            "-num_workers", "1", "-device", "cpu"]
    grid = ["-fsdp", "1", "-model_parallel", "2", "-num_devices", "2"]
    tmp = str(tmp_path)
    exps = {n: str(tmp_path / n) for n in ("straight", "sharded_first",
                                           "sharded_last")}

    def run(name, epochs, sharded, log):
        return Worker(base + ["-exp_dir", exps[name], "-num_epochs",
                              str(epochs)] + (grid if sharded else []),
                      tmp, module="lasr_tpu_torch.bin.train", name=log)

    first = [run("straight", 2, False, "straight"),
             run("sharded_first", 1, True, "a1"),
             run("sharded_last", 1, False, "b1")]
    outs = [w.wait() for w in first]
    for rc, out in outs:
        assert rc == 0, out[-6000:]
    assert "world size 4" in outs[1][1] and \
        "2 data x 2 model ranks, fsdp 1" in outs[1][1]
    # rank 0 alone wrote, whole reference checkpoints (and one
    # TensorBoard events file where the tensorboard package is installed)
    sharded = exps["sharded_first"]
    tb = importlib.util.find_spec("tensorboard") is not None
    assert sorted(os.listdir(sharded)) == ["checkpoints", "hparams.yaml",
                                           "metrics.jsonl"] + ["tb"] * tb
    if tb:
        assert len(os.listdir(os.path.join(sharded, "tb"))) == 1
    wav = str(tmp_path / "x.wav")
    write_wav(wav, (0.2 * np.random.default_rng(7).standard_normal(
        9000)).astype(np.float32), 16000)
    ours, ref = _tokens_of_both(sharded, tmp_path, wav)
    assert ours == ref

    second = [run("sharded_first", 2, False, "a2"),
              run("sharded_last", 2, True, "b2")]
    for rc, out in (w.wait() for w in second):
        assert rc == 0, out[-6000:]
        assert "auto-resumed from step 2 (epoch 1, batch 0)" in out

    def after_resume(exp):
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        return [x for x in lines if x["step"] > 2 and "loss_main" in x]
    # the resumed steps train on from the restored weights, moments and
    # EMA: their losses are the straight run's (the weights themselves
    # differ where a leaf's gradient is rounding noise, which Adam scales
    # to +-lr steps that differ by layout)
    want = after_resume(exps["straight"])
    assert len(want) == 2
    for name in ("sharded_first", "sharded_last"):
        got = after_resume(exps[name])
        assert [x["step"] for x in got] == [x["step"] for x in want]
        for g, w in zip(got, want):
            for k in ("loss_main", "att_loss", "ctc_loss", "att_corr"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                           err_msg=f"{name}: {k}")
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-3, err_msg=name)
