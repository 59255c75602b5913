"""E2E_Conformer_CTC of the port vs lasr_tpu on bridged weights, for the
plain rotated fold and the two served kernel configurations (A: rot
kernel, B: rel kernel): att_out / ctc_out / hs_len at the 2e-4 bar, and
the weights round-trip back through lasr_tpu's own torch_compat."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.utils.torch_compat import torch_to_flax
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.modules.dropout import dropout_generator
from tests.torch_port_common import CONFIGS, TINY, data, model_pair, t

ATOL = 2e-4


@pytest.mark.parametrize("config", list(CONFIGS))
def test_forward_matches_flax_and_weights_round_trip(config):
    fm, variables, pm = model_pair(CONFIGS[config], seed=1)
    x, xlen, ys = data(seed=11)
    want = fm.apply(variables, jnp.asarray(x), jnp.asarray(xlen),
                    jnp.asarray(ys))
    with torch.no_grad():
        got = pm(t(x), t(xlen), t(ys).long())
    np.testing.assert_array_equal(got["hs_len"].numpy(),
                                  np.asarray(want["hs_len"]))
    np.testing.assert_allclose(got["att_out"].numpy(),
                               np.asarray(want["att_out"]), atol=ATOL)
    for b, n in enumerate(np.asarray(want["hs_len"])):
        np.testing.assert_allclose(got["ctc_out"][b, :n].numpy(),
                                   np.asarray(want["ctc_out"])[b, :n],
                                   atol=ATOL)
    back = torch_to_flax(pm.state_dict(), template=variables, strict=True)
    for coll in ("params", "batch_stats"):
        flat_back = dict(_flatten(back[coll]))
        flat_want = dict(_flatten(variables[coll]))
        assert flat_back.keys() == flat_want.keys()
        for k, v in flat_want.items():
            np.testing.assert_array_equal(flat_back[k], v, err_msg=str(k))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_state_dict_names_are_the_reference_names():
    pm = E2E_Conformer_CTC(**TINY, device="cpu")
    keys = set(pm.state_dict())
    for k in ("encoder.embed.conv.0.weight", "encoder.embed.conv.2.bias",
              "encoder.embed.out.0.weight",
              "encoder.encoders.1.self_attn.linear_pos.weight",
              "encoder.encoders.0.self_attn.pos_bias_u",
              "encoder.encoders.0.feed_forward.w_1.weight",
              "encoder.encoders.0.conv_module.norm.running_mean",
              "encoder.encoders.0.conv_module.depthwise_conv.weight",
              "encoder.encoders.0.norm_final.weight", "encoder.after_norm.bias",
              "decoder.embed.0.weight", "decoder.decoders.1.src_attn.linear_k.bias",
              "decoder.decoders.0.norm3.weight", "decoder.output_layer.weight",
              "ctc.1.weight"):
        assert k in keys, k


def test_config_knobs():
    E2E_Conformer_CTC(**TINY, encoder_remat=True, encoder_remat_attend=2,
                      encoder_scan_layers=True,
                      encoder_pos_dropout_mode="rotated",
                      encoder_pipeline_microbatches=4, device="cpu")
    # the pipelined encoder keeps the per-block parameters; its eval
    # forward is the plain one (test_torch_port_pipeline.py trains it)
    torch.manual_seed(0)
    plain = E2E_Conformer_CTC(**TINY, device="cpu")
    staged = E2E_Conformer_CTC(**TINY, encoder_pipeline_stages=2,
                               device="cpu")
    staged.load_state_dict(plain.state_dict())
    x, xlen, ys = data()
    with torch.no_grad():
        assert torch.equal(staged(t(x), t(xlen), t(ys).long())["ctc_out"],
                           plain(t(x), t(xlen), t(ys).long())["ctc_out"])
    with pytest.raises(ValueError, match="not divisible"):
        E2E_Conformer_CTC(**TINY, encoder_pipeline_stages=3, device="cpu")
    # int8 feed-forwards, the same parameters
    int8 = E2E_Conformer_CTC(**TINY, encoder_ff_int8=True, device="cpu")
    int8.load_state_dict(plain.state_dict())
    assert type(int8.encoder.encoders[1].feed_forward.w_2).__name__ \
        == "QuantLinear"
    pm = E2E_Conformer_CTC(**TINY, device="cpu").train()
    x, xlen, ys = data()
    # train-mode dropout draws from a caller-owned generator only
    with pytest.raises(RuntimeError, match="generator"):
        pm(t(x), t(xlen), t(ys).long())
    with dropout_generator(torch.Generator().manual_seed(0)):
        out = pm(t(x), t(xlen), t(ys).long())
    assert bool(torch.isfinite(out["att_out"]).all())


def test_domain_tag_widens_the_ctc_head():
    pm = E2E_Conformer_CTC(**TINY, domain_dim=3, device="cpu")
    assert pm.ctc[1].weight.shape == (TINY["odim"], 16 + 3)
    hs = torch.randn(2, 4, 16)
    with torch.no_grad():
        zero = pm.ctc_logits(hs)
        tagged = pm.ctc_logits(hs, domain=torch.ones(2, 3))
        assert torch.equal(zero, pm.ctc_logits(hs, domain=torch.zeros(2, 3)))
    assert not torch.allclose(zero, tagged)
