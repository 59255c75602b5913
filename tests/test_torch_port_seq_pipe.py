"""Sequence and pipeline parallelism, and the monotonic attention's tensor
parallelism, in the port (``parallel/dist.py``'s (data, pipe, seq, model)
grid, ``modules/pipeline.py``, ``parallel/tensor.py``) on the CPU:
``gloo`` ranks started by ``tests/torch_port_dp_worker.py`` (JAX-free),
two process groups (2 ranks, 4 ranks) started together, each running its
layouts in turn, at small widths.

  - 4 ranks, data 2 x seq 2, on weights from ``lasr_tpu``'s ``Trainer``
    on ``make_mesh(data=2, seq=2)`` with ``tests/test_trainer.py``'s
    sequence-parallel model (d=32, 2 heads, 2 + 1 blocks, k=7), 3 steps on
    batches whose encoder length divides the seq axis (no pad frame: see
    that test): the losses, the parameters, the BatchNorm statistics and
    the EMA shadow within 1e-4 of the port's one-process step and within
    1e-3 of the mesh's, as ``test_torch_port_tp_fsdp.py`` holds the
    (data x model) mesh (grad_norm within 1e-3 of both);
  - against the port's one-process step, in float64 at 1e-5 (the first
    batch's gradient, the metrics, the weights, BatchNorm statistics and
    EMA after a step, the ranks bitwise equal): 2 seq ranks; 2 pipe ranks,
    pipe 2 x model 2 and data 2 x pipe 2 with FSDP on the pipelined
    Conformer (2 blocks, 2 stages, 2 microbatches; under data ranks a
    microbatch is each rank's k-th slice of its rows, so the one-process
    step takes the rows in that order); the streaming model (one-head
    monotonic source attention, sigmoid noise on) over 2 model ranks;
    and, in float32 (gradients within 3e-4), a Conformer of one head a
    layer over 2 model ranks (the column split) on the rel kernel's path;
  - 2 seq ranks encode a Transformer input whose encoder length is odd
    (11 frames): the padded output equals ``lasr_tpu``'s encoder under a
    seq sharding (``tests/test_trainer.py``'s pad test), 12 frames, the
    valid lengths unchanged.

Every multi-process case runs under ``torch_port_dp_worker.TIMEOUT_S``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.models.losses import E2E_Loss as JaxLoss
from lasr_tpu.parallel.mesh import make_mesh, seq_sharding
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu_torch.parallel import dist
from tests.torch_port_common import flax_state_dict, seeded_variables
from tests.torch_port_dp_worker import (KW, assert_step_equal,
                                        build_trainer, float64_everywhere,
                                        layout_result, run_steps,
                                        start_ranks, wav_batch)

ADAM = dict(lr=1e-3, eps=1e-3)
# 7660 samples: 46 fbank frames, an encoder length of 10 (even)
S = 7660
# tests/test_trainer.py's sequence-parallel model at idim 20
KW_SEQ = dict(idim=20, odim=10, encoder_attention_dim=32,
              encoder_attention_heads=2, encoder_linear_units=64,
              encoder_num_blocks=2, decoder_attention_dim=32,
              decoder_attention_heads=2, decoder_linear_units=64,
              decoder_num_block=1, encoder_pos_enc_layer_type="rel_pos",
              encoder_selfattention_layer_type="rel_selfattn",
              encoder_cnn_kernel=7, encoder_dropout_rate=0.0,
              decoder_dropout_rate=0.0, ctc_dropout=0.0)
KW_PIPE = dict(KW, odim=10, encoder_pipeline_stages=2,
               encoder_pipeline_microbatches=2)
KW_STREAM = dict(idim=20, odim=10, encoder_attention_dim=32,
                 encoder_attention_heads=2, encoder_left_chunk=4,
                 encoder_center_chunk=4, encoder_right_chunk=2,
                 encoder_linear_units=32, encoder_num_blocks=2,
                 decoder_attention_dim=32, decoder_self_attention_heads=2,
                 decoder_src_attention_heads=1, decoder_linear_units=32,
                 decoder_num_block=2, encoder_dropout_rate=0.0,
                 decoder_dropout_rate=0.0, ctc_dropout=0.0,
                 decoder_src_attention_sigmoid_noise=1.0)
KW_TF = dict(idim=20, odim=10, encoder_attention_dim=32,
             encoder_attention_heads=2, encoder_linear_units=64,
             encoder_num_blocks=2, decoder_attention_dim=32,
             decoder_attention_heads=2, decoder_linear_units=64,
             decoder_num_block=1, encoder_dropout_rate=0.0,
             decoder_dropout_rate=0.0, ctc_dropout=0.0)
# the layouts held against the port's one process in float64
TWO = {"seq2": dict(kw=KW, seq_parallel=2),
       "pipe2": dict(kw=KW_PIPE, pipeline_parallel=2),
       "mt_tp2": dict(kw=KW_STREAM, model="online", model_parallel=2),
       # one head a layer over 2 model ranks: the column split, with the
       # rel kernel's plain version run whole (which takes no float64)
       "heads1_tp2_B": dict(kw=dict(KW, odim=10, encoder_attention_heads=1,
                                    decoder_attention_heads=1,
                                    encoder_use_pallas_attention=True),
                            model_parallel=2, float64=False)}
# the monotonic attention's key bias has a gradient (no softmax)
NOISE = {"mt_tp2": ("self_attn.linear_k.bias",)}
# float32's reordered sums (test_torch_port_tp_fsdp.py's F32_GRAD_TOL)
LOOSE = {"heads1_tp2_B": {"": 3e-4}}


def _spec(layout, chain=("norm", "fbank:20", "specaug")):
    return dict(dict(chain=list(chain), adam=ADAM, acc_grads=1,
                     device="cpu", float64=True,
                     batches=[wav_batch(0, 4, 4, S)]), **layout)


class OneProcess:
    """The port's one-process run of a spec: ``__init__`` builds the
    model and puts its initial weights in ``spec["init"]`` (for the
    ranks), ``run()`` takes the steps, on the batches' rows in the order
    ``rows`` (all of them, in order, by default)."""

    def __init__(self, spec, rows=None):
        self.spec, self.rows = spec, rows
        self.f64 = bool(spec.get("float64"))
        float64_everywhere(self.f64)
        try:
            torch.manual_seed(0)
            self.model, self.trainer = build_trainer(dict(spec, fsdp=False),
                                                     "cpu")
        finally:
            float64_everywhere(False)
        spec["init"] = {k: v.clone()
                        for k, v in self.model.state_dict().items()}

    def run(self):
        float64_everywhere(self.f64)
        try:
            return run_steps(self.trainer, self.model, self.spec["batches"],
                             self._rows)
        finally:
            float64_everywhere(False)

    def _rows(self, batch):
        if self.rows is None:
            return dist.pad_rows(batch, 1)
        return {k: v[self.rows] for k, v in batch.items()}


def _odd_encode():
    """The Transformer input of lasr_tpu's pad test: 50 feature frames,
    an encoder length of 11; (features, lengths, lasr_tpu's variables)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 50, 20)).astype(np.float32)
    xlen = np.asarray([50, 42], np.int32)
    ys = rng.integers(3, 10, (2, 5)).astype(np.int32)
    fm = jax_models.E2E_Transformer_CTC(**KW_TF)
    variables = seeded_variables(fm, 4, jnp.asarray(x), jnp.asarray(xlen),
                                 jnp.asarray(ys))
    return x, xlen, variables


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both process groups, started together: 2 ranks run TWO's layouts
    and the odd-length encode; 4 ranks run data 2 x seq 2 on lasr_tpu's
    weights (float32), then pipe 2 x model 2 and data 2 x pipe 2 (float64).
    lasr_tpu's mesh Trainer and the port's one-process runs go on
    meanwhile."""
    tmp = {n: str(tmp_path_factory.mktemp(f"ranks{n}")) for n in (2, 4)}
    runs = {name: OneProcess(_spec(layout)) for name, layout in TWO.items()}
    x, xlen, variables = _odd_encode()
    encode = dict(kw=KW_TF, model="transformer", seq_parallel=2,
                  encode=(x, xlen), init=flax_state_dict(
                      variables["params"]))
    chain = ["norm", "fbank:20"]
    batches = [wav_batch(2, 4, 4, S), wav_batch(3, 3, 4, S),
               wav_batch(2, 4, 4, S)]
    jt = JaxTrainer(jax_models.E2E_Conformer_CTC(**KW_SEQ),
                    JaxLoss(KW_SEQ["odim"], smoothing=0.1, rate=0.3),
                    JaxAdam(**ADAM).make(), JaxFrontend(chain),
                    mesh=make_mesh(data=2, seq=2, devices=jax.devices()[:4]),
                    use_ema=True, seed=0, log_interval=1)
    assert jt.model.encoder_act_sharding is not None
    jstate = jt.init_state(batches[0])
    seq = dict(kw=KW_SEQ, chain=chain, adam=ADAM, acc_grads=1,
               device="cpu", batches=batches, seq_parallel=2,
               init=flax_state_dict(jstate.params, jstate.batch_stats))
    four = {"pipe2xtp2": OneProcess(_spec(dict(
        kw=KW_PIPE, pipeline_parallel=2, model_parallel=2))),
        # data 2 x pipe 2: each data rank's 2 rows make 2 microbatches of
        # 1, global microbatch k being row k of each rank: the
        # one-process pipelined step on rows 0, 2, 1, 3 (SpecAugment off:
        # it draws by the global row)
        "dp2xpipe2_fsdp": OneProcess(_spec(dict(
            kw=KW_PIPE, pipeline_parallel=2, fsdp=True, fsdp_min_size=0),
            chain=("norm", "fbank:20")), rows=[0, 2, 1, 3])}
    workers = {
        2: start_ranks(tmp[2], dict(ranks=2, device="cpu", layouts=[
            r.spec for r in runs.values()] + [encode])),
        4: start_ranks(tmp[4], dict(ranks=4, device="cpu", layouts=[
            seq] + [r.spec for r in four.values()]))}
    jmetrics = []
    for b in batches:
        jstate, m = jt.train_step(jstate, b)
        jmetrics.append({k: float(v) for k, v in m.items()})
    model, trainer = build_trainer(seq, "cpu", seq["init"])
    one = run_steps(trainer, model, batches, lambda b: dist.pad_rows(b, 1))
    wants = {name: r.run() for name, r in {**runs, **four}.items()}
    for worker in workers.values():
        rc, out = worker.wait()
        assert rc == 0, out[-6000:]
    got = {name: layout_result(tmp[2], 2, f"_{i}")
           for i, name in enumerate(runs)}
    got["encode"] = layout_result(tmp[2], 2, f"_{len(runs)}")
    got.update({name: layout_result(tmp[4], 4, f"_{i}")
                for i, name in enumerate(four, 1)})
    got["seq"] = layout_result(tmp[4], 4, "_0")
    return got, wants, (x, xlen, variables), (one, jmetrics, jstate)


@pytest.mark.parametrize("layout", list(TWO))
def test_two_ranks_equal_one_process(layout, groups):
    got, wants = groups[:2]
    assert_step_equal(got[layout], wants[layout], loose=LOOSE.get(layout),
                      **({"noise": NOISE[layout]} if layout in NOISE
                         else {}))


def test_seq_ranks_pad_an_odd_encoder_length_as_lasr_tpu(groups):
    got, (x, xlen, variables) = groups[0], groups[2]
    fm = jax_models.E2E_Transformer_CTC(
        encoder_act_sharding=seq_sharding(
            make_mesh(data=1, seq=2, devices=jax.devices()[:2])), **KW_TF)
    hs, hs_len = jax.jit(lambda v, a, b: fm.apply(
        v, a, b, method=fm.encode))(variables, jnp.asarray(x),
                                    jnp.asarray(xlen))
    assert got["encode"]["hs"].shape[1] == hs.shape[1] == 12
    np.testing.assert_array_equal(got["encode"]["hs_len"].numpy(),
                                  np.asarray(hs_len))
    np.testing.assert_allclose(got["encode"]["hs"].numpy(), np.asarray(hs),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("layout", ["pipe2xtp2", "dp2xpipe2_fsdp"])
def test_four_ranks_pipe_and_model_equal_one_process(layout, groups):
    got, wants = groups[:2]
    assert_step_equal(got[layout], wants[layout])


def test_data_and_seq_ranks_equal_lasr_tpu_mesh_step(groups):
    """Losses and state within 1e-4 of the one-process step and 1e-3 of
    lasr_tpu's mesh; grad_norm, a norm of float32 gradients whose sums
    the split reorders (``test_torch_port_tp_fsdp.py``: the mesh's own is
    3.7e-4 from one device), within 1e-3 of both."""
    got = groups[0]["seq"]
    one, jmetrics, jstate = groups[3]
    for i, (g, w, w1) in enumerate(zip(got["steps"], jmetrics,
                                       one["steps"])):
        for k in g:
            tol = 1e-3 if k == "grad_norm" else 1e-4
            np.testing.assert_allclose(g[k], w1[k], rtol=tol, atol=tol,
                                       err_msg=f"{k} step {i}")
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, atol=1e-3,
                                       err_msg=f"{k} step {i} (mesh)")
    shadow = dict(zip(got["names"], got["ema"]))
    for k, v in one["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   atol=1e-4, err_msg=k)
    for name, s in zip(one["names"], one["ema"]):
        np.testing.assert_allclose(shadow[name].numpy(), s.numpy(),
                                   atol=1e-4, err_msg=f"EMA of {name}")
    want = flax_state_dict(jstate.params, jstate.batch_stats)
    want_ema = flax_state_dict(jstate.ema["shadow"])
    assert any(k.endswith("norm.running_var") for k in want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   atol=1e-3, err_msg=f"{k} (mesh)")
        if k in shadow:
            np.testing.assert_allclose(shadow[k].numpy(),
                                       want_ema[k].numpy(), atol=1e-3,
                                       err_msg=f"EMA of {k} (mesh)")
