"""Data-parallel training of the port (``lasr_tpu_torch/parallel``) on the
CPU: two ``gloo`` ranks, each a process of its own started by
``tests/torch_port_dp_worker.py`` (JAX-free), at small widths (2
Conformer blocks of d=32, 2 decoder blocks, a few utterances).

  - Two ranks against the one-process step on the same global batch (B
    odd, so a zero-length pad row lands on rank 1; SpecAugment on,
    dropout 0, the table configuration), at ``acc_grads`` 1 and 2: the
    loss and every metric (relative), every gradient (relative L2; the
    reordered sums of a gradient whose terms cancel move single entries
    further), the parameters after the update, the EMA shadow and the
    BatchNorm running statistics (absolute, as the Trainer tests hold
    them) and ``grad_norm`` within 1e-5; the leaves whose true
    gradient is 0 ~0 on both sides; the two ranks bitwise equal.
  - Two ranks against ``lasr_tpu``'s ``Trainer`` on ``make_mesh(data=2)``
    on weights carried across by the bridge, as
    ``test_torch_port_trainer.py`` holds one device (dropout 0, no
    SpecAugment, Adam eps 1e-3): 3 steps, one with a pad row; every
    metric, the parameters, the BatchNorm statistics and the EMA shadow
    within 1e-4.
  - The dataset's ``batches`` at ``process_count`` 2 and at 2 ranks on a
    host against ``lasr_tpu``'s ``batches(process_index, process_count)``:
    the order, ``order_pad``, the padded shapes, each rank's rows.
  - ``python -m lasr_tpu_torch.bin.train -device cpu -num_devices 2``:
    rank 0 alone writes one checkpoint tree and one ``metrics.jsonl``,
    and a run killed mid-epoch resumes to the uninterrupted run's weights
    within 1e-4.

Every multi-process case runs under its own timeout, which kills its
whole process group.
"""

import importlib.util
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
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu_torch.data.dataset import BatchAudioDataSet
from lasr_tpu_torch.data.tokenizer import CharTokenizer
from lasr_tpu_torch.parallel import dist
from lasr_tpu_torch.utils.weights import checkpoint_steps
from tests.test_torch_port_cli import write_corpus
from tests.torch_port_common import flax_state_dict
from tests.torch_port_dp_worker import (KW, Worker, assert_step_equal,
                                        build_trainer, layout_result,
                                        one_process_results,
                                        start_one_process, start_ranks,
                                        wav_batch)

ADAM = dict(lr=1e-3, eps=1e-3)


def _mesh_trainer(chain):
    return JaxTrainer(jax_models.E2E_Conformer_CTC(**KW),
                      JaxLoss(KW["odim"], smoothing=0.1, rate=0.3),
                      JaxAdam(**ADAM).make(), JaxFrontend(chain),
                      mesh=make_mesh(data=2, devices=jax.devices()[:2]),
                      use_ema=True, seed=0, log_interval=1)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One group of two ranks runs the three layouts below in turn
    (``acc_grads`` 1 and 2 on the port's initial weights, then
    lasr_tpu's mesh batches on its weights); the port's one-process steps
    (in a process of their own) and lasr_tpu's mesh steps run
    meanwhile."""
    tmp = str(tmp_path_factory.mktemp("two"))
    runs = {}
    for acc_grads in (1, 2):
        spec = dict(kw=KW, chain=["norm", "fbank:20", "specaug"], adam=ADAM,
                    acc_grads=acc_grads, device="cpu",
                    batches=[wav_batch(0, 3, 3), wav_batch(1, 4, 4)])
        torch.manual_seed(0)
        model, _ = build_trainer(spec, "cpu")
        spec["init"] = {k: v.clone() for k, v in model.state_dict().items()}
        runs[acc_grads] = spec
    one_tmp = str(tmp_path_factory.mktemp("one"))
    one_worker = start_one_process(one_tmp, [
        (spec, ("pad", 2), None) for spec in runs.values()])
    chain = ["norm", "fbank:20"]
    batches = [wav_batch(2, 4, 4), wav_batch(3, 3, 4), wav_batch(2, 4, 4)]
    jt = _mesh_trainer(chain)
    jstate = jt.init_state(batches[0])
    mesh = dict(kw=KW, chain=chain, adam=ADAM, acc_grads=1, device="cpu",
                batches=batches,
                init=flax_state_dict(jstate.params, jstate.batch_stats))
    worker = start_ranks(tmp, dict(ranks=2, device="cpu", layouts=[
        runs[1], runs[2], mesh]))
    jmetrics = []
    for b in batches:
        jstate, m = jt.train_step(jstate, b)
        jmetrics.append({k: float(v) for k, v in m.items()})
    wants = dict(zip(runs, one_process_results(one_tmp, one_worker,
                                               len(runs))))
    rc, out = worker.wait()
    assert rc == 0, out[-6000:]
    got = [layout_result(tmp, 2, f"_{i}") for i in range(3)]
    return ({acc: (got[i], wants[acc], runs[acc]["init"])
             for i, acc in enumerate((1, 2))}, (got[2], jmetrics, jstate))


@pytest.mark.parametrize("acc_grads", [1, 2])
def test_two_ranks_equal_one_process_on_the_global_batch(acc_grads,
                                                         two_ranks):
    got, want, init = two_ranks[0][acc_grads]
    assert_step_equal(got, want)
    # the update moved the weights, and the BatchNorm statistics
    moved = [k for k, w in want["state_dict"].items()
             if not torch.equal(w, init[k])]
    assert any(k.endswith("norm.running_var") for k in moved)
    assert len(moved) > len(want["names"]) // 2


def test_two_ranks_equal_lasr_tpu_mesh_step(two_ranks):
    got, jmetrics, jstate = two_ranks[1]
    for i, (g, w) in enumerate(zip(got["steps"], jmetrics)):
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k} step {i}")
    want = flax_state_dict(jstate.params, jstate.batch_stats)
    want_ema = flax_state_dict(jstate.ema["shadow"])
    shadow = dict(zip(got["names"], got["ema"]))
    assert any(k.endswith("norm.running_var") for k in want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   atol=1e-4, err_msg=k)
        if k in shadow:
            np.testing.assert_allclose(shadow[k].numpy(),
                                       want_ema[k].numpy(), atol=1e-4,
                                       err_msg=f"EMA of {k}")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """9 utterances of 0.5-0.9 s: 5 groups of 2 (one of 1)."""
    root = tmp_path_factory.mktemp("dp")
    return write_corpus(str(root / "c"), n16=9, n8=0, seed=5,
                        secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))


def _dataset_pair(corpus):
    scp, txt, dict_path = corpus
    kw = dict(wav_list=[scp], text_list=[txt], audio_trans=["fbank:20"],
              batch_type="size", batch_size=2, batch_pad_multiple=2,
              min_duration=0.0, text_freq=0.0)
    jd = JaxBatchAudioDataSet(tokenizer=JaxCharTokenizer(dict_path), **kw)
    pd = BatchAudioDataSet(tokenizer=CharTokenizer(dict_path), **kw)
    jd.load_check_data()
    pd.load_check_data()
    return jd, pd


def _rows_equal(got, want, rows=slice(None)):
    for k in ("wav_array", "wav_len", "token_id", "token_len"):
        np.testing.assert_array_equal(got[k], want[k][rows], err_msg=k)
    assert got["order_pad"] == want["order_pad"]


def test_dataset_shards_as_lasr_tpu(corpus):
    jd, pd = _dataset_pair(corpus)
    kw = dict(shuffle=True, seed=3, num_workers=2)
    hosts = [list(jd.batches(process_index=p, process_count=2, **kw))
             for p in range(2)]
    # 5 batches over 2 processes: the head cycled in once, tagged
    assert [len(h) for h in hosts] == [3, 3]
    assert [b["order_pad"] for h in hosts for b in h].count(True) == 1
    for p in range(2):
        got = list(pd.batches(process_index=p, process_count=2, **kw))
        assert len(got) == len(hosts[p])
        for g, w in zip(got, hosts[p]):
            _rows_equal(g, w)
    # 2 ranks on each of 2 hosts, and 2 ranks on one host: rows of the
    # host batch, padded to the global batch's lengths
    one = list(jd.batches(**kw))
    for P, want in ((2, hosts), (1, [one])):
        for p in range(P):
            for r in range(2):
                got = list(pd.batches(process_index=p, process_count=P,
                                      local_rank=r, local_world_size=2,
                                      **kw))
                assert len(got) == len(want[p])
                for s_, (g, w) in enumerate(zip(got, want[p])):
                    b = len(w["wav_len"]) // 2
                    _rows_equal(g, w, slice(r * b, (r + 1) * b))
                    assert g["row0"] == p * 2 * b + r * b
                    np.testing.assert_array_equal(
                        g["global_wav_len"],
                        np.concatenate([h[s_]["wav_len"] for h in want]))
    # a resumed epoch skips whole steps
    got = list(pd.batches(process_index=1, process_count=2, local_rank=1,
                          local_world_size=2, skip=2, **kw))
    b = len(hosts[1][2]["wav_len"]) // 2
    assert len(got) == 1
    _rows_equal(got[0], hosts[1][2], slice(b, 2 * b))


def _lines(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_on_two_cpu_ranks_writes_once_and_resumes(tmp_path):
    from tests.test_torch_port_cli import TINY_CONFORMER, write_config
    train = write_corpus(str(tmp_path / "train"), n16=6, n8=0, seed=21,
                         secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))
    valid = write_corpus(str(tmp_path / "dev"), n16=3, n8=0, seed=22,
                         secs=(0.5, 0.9), n_words=(1, 3), word_len=(1, 4))
    # batches of 3 over 2 ranks: every step has a pad row on rank 1
    config = write_config(str(tmp_path / "config.yaml"), train, valid,
                          TINY_CONFORMER, chain=["norm", "fbank:20",
                                                 "specaug"],
                          train_batch=3, valid_batch=3)
    flags = ["-config", config, "-num_epochs", "2", "-ema", "1",
             "-log_interval", "1", "-num_workers", "1", "-device", "cpu",
             "-num_devices", "2", "-checkpoint_interval_steps", "1"]
    straight, killed = str(tmp_path / "straight"), str(tmp_path / "killed")
    tmp = str(tmp_path)
    runs = [Worker(flags + ["-exp_dir", straight], tmp,
                    module="lasr_tpu_torch.bin.train", name="straight"),
            Worker(["cli"] + flags + ["-exp_dir", killed], tmp,
                    env={"DP_KILL_AFTER": "3"}, name="killed")]
    (rc, out), (rc_k, out_k) = [w.wait() for w in runs]
    assert rc == 0, out[-6000:]
    assert rc_k not in (0, None) and "simulated preemption" in out_k, \
        out_k[-6000:]
    assert "backend gloo, world size 2" in out

    # rank 0 alone wrote: one tree, each line once, and one TensorBoard
    # events file where the tensorboard package is installed
    tb = importlib.util.find_spec("tensorboard") is not None
    assert sorted(os.listdir(straight)) == [
        "checkpoints", "hparams.yaml", "metrics.jsonl"] + ["tb"] * tb
    if tb:
        assert len(os.listdir(os.path.join(straight, "tb"))) == 1
    assert [(x["epoch"], x["step"], "valid_loss_main" in x)
            for x in _lines(straight)] == [
        (0, 1, False), (0, 2, False), (0, 2, True), (1, 3, False),
        (1, 4, False), (1, 4, True)]
    assert all(x["utts_cum"] == 3 for x in _lines(straight)
               if "utts_cum" in x)
    root = os.path.join(straight, "checkpoints")
    assert sorted(checkpoint_steps(os.path.join(root, "last"))) == \
        [1, 2, 3, 4]
    assert sorted(os.listdir(root)) == ["best", "last", "loop_state.json"]
    # killed when asking for the 4th batch, after step 3's checkpoint
    assert max(checkpoint_steps(os.path.join(killed, "checkpoints",
                                             "last"))) == 3

    rc_r, out_r = Worker(flags + ["-exp_dir", killed], tmp,
                          module="lasr_tpu_torch.bin.train",
                          name="resumed").wait()
    assert rc_r == 0, out_r[-6000:]
    assert "auto-resumed from step 3 (epoch 1, batch 1)" in out_r
    drop = ("wall_s", "data_wait_s", "dispatch_s")

    def after_kill(exp):
        return [{k: v for k, v in x.items() if k not in drop}
                for x in _lines(exp) if x["step"] > 3]
    got, want = after_kill(killed), after_kill(straight)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    sd = [torch.load(os.path.join(exp, "checkpoints", "last",
                                  "step-000000004.ckpt"),
                     weights_only=False)["state_dict"]
          for exp in (straight, killed)]
    for k, v in sd[0].items():
        np.testing.assert_allclose(sd[1][k].numpy(), v.numpy(), atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("device,flag,gpus,want", [
    ("cpu", -1, 0, 1), ("cpu", 2, 0, 2), ("cuda", -1, 4, 4),
    ("cuda", 3, 4, 3), ("cuda", 5, 4, "exceeds the 4"),
    ("cuda:1", 2, 4, "pass -device cuda"), ("cpu", 0, 0, "-1 or a count")])
def test_num_devices_picks_the_ranks(device, flag, gpus, want, monkeypatch):
    from lasr_tpu_torch.bin import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: gpus > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    args = train.build_parser().parse_args(
        ["-config", "c.yaml", "-device", device, "-num_devices", str(flag)])
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            train.num_ranks(args)
    else:
        assert train.num_ranks(args) == want


def test_shard_rows_split_a_padded_global_batch():
    batch = wav_batch(4, 3, 3)
    full = dist.pad_rows(batch, 2)
    assert len(full["wav_len"]) == 4 and full["wav_len"][3] == 0
    shards = [dist.shard_rows(batch, r, 2) for r in range(2)]
    for k in ("wav_array", "wav_len", "token_id", "token_len"):
        np.testing.assert_array_equal(
            np.concatenate([s[k] for s in shards]), full[k])
    assert [s["row0"] for s in shards] == [0, 2]
    assert all(s["n_utts"] == 3 for s in shards)
    np.testing.assert_array_equal(shards[1]["global_wav_len"],
                                  full["wav_len"])
    # at world size 1 nothing is communicated
    x = torch.ones(3, requires_grad=True)
    assert dist.all_reduce_sum(x) is x and dist.global_sum(x) is x
    assert dist.world_size() == 1 and dist.layout() == (0, 1, 0, 1)
