"""GPipe pipeline parallelism in one process (``modules/pipeline.py``)
against ``lasr_tpu``'s pipelined encoder (``lasr_tpu/modules/
pipeline.py``), and a pipelined checkpoint through the weight bridge:

  - the pipelined Conformer (2 blocks in 2 stages, 2 microbatches of a
    4-row batch) on seeded ``lasr_tpu`` variables whose ``pipe_stages``
    leaves the bridge unstacks: the eval forward within 2e-4; one
    train-mode step's loss, every parameter's gradient (relative L2; the
    leaves whose true gradient is 0 ~0 on both sides) and the BatchNorm
    running statistics after it (moved at every tick, warm-up and drain
    included) within 2e-4, in float32;
  - ``pick_microbatches`` equals ``lasr_tpu``'s, clamp included;
  - a ``pipe_stages`` tree maps block p·L/P + l to ``layers_{p·L/P+l}``
    through ``flax_to_state_dict`` and through an orbax root written by
    ``utils.ocdbt.save_tree`` (``load_reference_checkpoint``);
  - ``lasr_tpu``'s ``TapConv1d`` (the pipelined stack's conv) equals the
    port's depthwise and pointwise ``Conv1d`` on the same parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.modules.convops import TapConv1d
from lasr_tpu.modules.pipeline import pick_microbatches as jax_pick
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.modules.dropout import dropout_generator
from lasr_tpu_torch.modules.layers import Conv1d
from lasr_tpu_torch.modules.pipeline import pick_microbatches
from lasr_tpu_torch.utils import ocdbt
from lasr_tpu_torch.utils.weights import (flax_to_state_dict,
                                          load_model_weights,
                                          load_reference_checkpoint)
from tests.torch_port_common import TINY, data, seeded_variables

KW = dict(TINY, encoder_pipeline_stages=2,
          encoder_pipeline_microbatches=2, encoder_dropout_rate=0.0,
          decoder_dropout_rate=0.0, ctc_dropout=0.0)
NOISE_LEAVES = ("conv_module.depthwise_conv.bias", "linear_k.bias")


def _loss(out):
    return (out["ctc_out"] ** 2).sum() + (out["att_out"] ** 2).sum()


@pytest.fixture(scope="module")
def pair():
    x, xlen, ys = data(B=4)
    fm = jax_models.E2E_Conformer_CTC(**KW)
    args = [jnp.asarray(a) for a in (x, xlen, ys)]
    v = seeded_variables(fm, 3, *args)
    model = E2E_Conformer_CTC(**KW, device="cpu")
    load_model_weights(model, flax_to_state_dict(v))
    return fm, v, args, model, [torch.as_tensor(a) for a in (x, xlen, ys)]


def test_pipelined_eval_forward_matches_lasr_tpu(pair):
    fm, v, args, model, targs = pair
    assert "pipe_stages" in v["params"]["encoder"]
    want = jax.jit(fm.apply)(v, *args)
    with torch.no_grad():
        got = model.eval()(targs[0], targs[1], targs[2].long())
    for k in ("ctc_out", "att_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


def test_pipelined_train_step_matches_lasr_tpu(pair):
    """Loss, gradients and the BatchNorm statistics after the step."""
    fm, v, args, model, targs = pair

    def loss(params):
        out, state = fm.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, *args,
                              deterministic=False, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return _loss(out), state

    (want, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    model.train()
    with dropout_generator(torch.Generator().manual_seed(0)):
        got = _loss(model(targs[0], targs[1], targs[2].long()))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-4)
    want_g = flax_to_state_dict({"params": grads})
    top = max(float(g.abs().max()) for g in want_g.values())
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want_g[name].numpy()
        if name.endswith(NOISE_LEAVES):
            assert max(np.abs(g).max(), np.abs(w).max()) / top < 2e-4, name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err < 2e-4, (name, err)
    want_bn = flax_to_state_dict({"batch_stats": stats["batch_stats"]})
    sd = model.state_dict()
    moved = 0
    for k, w in want_bn.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=k)
            moved += not torch.equal(
                w, flax_to_state_dict({"batch_stats": v["batch_stats"]})[k])
    assert moved == 4


def test_pick_microbatches_matches_lasr_tpu():
    for batch, requested in [(8, 4), (8, 5), (6, 4), (7, 4), (1, 8),
                             (8, 100), (12, 0)]:
        assert pick_microbatches(batch, requested) == \
            jax_pick(batch, requested), (batch, requested)
    assert pick_microbatches(6, 4) == 3 and pick_microbatches(7, 4) == 1


def test_pipe_stages_tree_through_the_bridge_and_orbax(tmp_path):
    """A pipelined tree (.pt bridge and orbax root) names block
    p·L/P + l as the port's ``encoders.{p·L/P+l}``."""
    x, xlen, ys = (jnp.asarray(a) for a in data())
    kw = dict(TINY, encoder_num_blocks=4, encoder_pipeline_stages=2)
    v = seeded_variables(jax_models.E2E_Conformer_CTC(**kw), 6, x, xlen, ys)
    stacked = v["params"]["encoder"]["pipe_stages"]["block"]
    sd = flax_to_state_dict(v)
    for p in range(2):
        for layer in range(2):
            block = jax.tree.map(lambda a: np.asarray(a)[p][layer], stacked)
            one = flax_to_state_dict({"params": {"encoder": {
                f"layers_{2 * p + layer}": block}}})
            for k, t in one.items():
                assert torch.equal(sd[k], t), k
    root = str(tmp_path / "pipe")
    ocdbt.save_tree(root, {"params": jax.tree.map(np.asarray, v["params"]),
                           "batch_stats": jax.tree.map(np.asarray,
                                                       v["batch_stats"])})
    read = load_reference_checkpoint(root)
    model = E2E_Conformer_CTC(**kw, device="cpu")
    load_model_weights(model, read)
    for k, t in sd.items():
        assert torch.equal(read[k], t), k


@pytest.mark.parametrize("feat,k,groups", [(16, 1, 1), (8, 7, 8)])
def test_tapconv1d_equals_the_port_conv(feat, k, groups):
    """The pointwise and depthwise convs of a pipelined block."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 20, 8)).astype(np.float32)
    pad = (k - 1) // 2
    tap = TapConv1d(feat, k, padding=[(pad, pad)],
                    feature_group_count=groups)
    v = jax.eval_shape(tap.init, jax.random.PRNGKey(3), jnp.asarray(x))
    v = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), v)
    conv = Conv1d(8, feat, k, padding=pad, groups=groups)
    sd = flax_to_state_dict({"params": {"c": v["params"]}})
    conv.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    with torch.no_grad():
        got = conv(torch.as_tensor(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.jit(tap.apply)(
                                   v, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
