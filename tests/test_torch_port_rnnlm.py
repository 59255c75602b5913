"""The port's RNN modules and LM shallow fusion against lasr_tpu on the
same weights (carried across by ``rnnlm_flax_to_state_dict`` /
``lstm_stack_flax_to_state_dict``), f32:

  - ``RNNCellStack`` (lstm / gru × embed / linear) and ``LSTMStack`` (uni
    and bi): logits, states, ``predict``'s log-probs, ``forward_onehot``
    and ``score_sequence`` within 2e-5;
  - ``CTCAttBeamDecoder(lm=…, lm_weight=0.3)`` token-exact with scores
    within 1e-3, nbest 3 lists equal, offline on the tiny Conformer in
    configurations table, A and B, and online on the streaming model;
  - ``build_lm``'s three-way rule, and the orbax ``lm_path`` it refuses.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu.decode.beam import CTCAttBeamDecoder as JaxBeam
from lasr_tpu.models.e2e_online import E2E_Transformer_CTC_Online as JaxOnline
from lasr_tpu.modules.rnn import RNNLM as JaxRNNLM
from lasr_tpu.modules.rnn import LSTMStack as JaxLSTMStack
from lasr_tpu.modules.rnn import RNNCellStack as JaxRNNCellStack
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.decode.lm import build_lm
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from lasr_tpu_torch.modules.rnn import RNNLM, LSTMStack, RNNCellStack
from lasr_tpu_torch.utils.weights import (flax_to_state_dict,
                                          load_model_weights,
                                          lstm_stack_flax_to_state_dict,
                                          rnnlm_flax_to_state_dict)
from tests.torch_port_common import (CONFIGS, ONLINE, TINY, model_pair,
                                     numpy_tree, pair)

TOL = 2e-5


def lm_pair(V, typ="lstm", input_layer="embed", seed=0, n_layers=2,
            n_units=16):
    """(flax RNNCellStack, its numpy variables, the port's on the CPU with
    the same weights)."""
    kw = dict(input_dim=V, output_dim=V, n_layers=n_layers, n_units=n_units,
              typ=typ, input_layer=input_layer)
    fm = JaxRNNCellStack(**kw)
    x = jnp.zeros((2,), jnp.int32) if input_layer == "embed" \
        else jnp.zeros((2, V))
    v = numpy_tree(fm.init(jax.random.PRNGKey(seed), None, x))
    pm = RNNCellStack(**kw, device="cpu")
    pm.load_state_dict(rnnlm_flax_to_state_dict(v, typ))
    return fm, v, pm


def close(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


@pytest.mark.parametrize("typ,input_layer", [
    ("lstm", "embed"), ("lstm", "linear"), ("gru", "embed"),
    ("gru", "linear")])
def test_rnn_cell_stack_matches_flax(typ, input_layer):
    V = 11
    fm, v, pm = lm_pair(V, typ, input_layer, seed=3)
    rng = np.random.default_rng(4)
    want_state, got_state = None, None
    for _ in range(3):
        x = rng.integers(0, V, (4,)) if input_layer == "embed" \
            else rng.standard_normal((4, V)).astype(np.float32)
        want_state, want = fm.apply(v, want_state, jnp.asarray(x))
        with torch.no_grad():
            got_state, got = pm(got_state, torch.from_numpy(x))
        close(got, want)
        close(got_state, want_state)
    if input_layer != "embed":
        return
    # predict's log-probs, the soft one-hot step and the teacher-forced
    # sequence
    tokens = rng.integers(0, V, (3, 5))
    _, want = JaxRNNLM(fm, v).predict(tokens[:, 0], None)
    _, got = RNNLM(pm).predict(tokens[:, 0], None)
    close(got, want)
    soft = rng.dirichlet(np.ones(V), size=3).astype(np.float32)
    want = fm.apply(v, None, jnp.asarray(soft), method=fm.forward_onehot)
    with torch.no_grad():
        got = pm.forward_onehot(None, torch.from_numpy(soft))
    close(got, want)
    want = fm.apply(v, jnp.asarray(tokens), method=fm.score_sequence)
    with torch.no_grad():
        got = pm.score_sequence(torch.from_numpy(tokens))
    close(got, want)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_stack_matches_flax(bidirectional):
    x = np.random.default_rng(5).standard_normal((2, 7, 6)).astype(
        np.float32)
    fm = JaxLSTMStack(input_size=6, hidden_size=8, num_layers=2,
                      bidirectional=bidirectional)
    v = numpy_tree(fm.init(jax.random.PRNGKey(6), jnp.asarray(x)))
    pm = LSTMStack(6, 8, 2, bidirectional=bidirectional, device="cpu")
    pm.load_state_dict(lstm_stack_flax_to_state_dict(v, bidirectional))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (2, 7, 16 if bidirectional else 8)
    close(got, fm.apply(v, jnp.asarray(x)))


def check_hyps(got, want, B, nbest):
    for b in range(B):
        assert got.best_ids(b) == want.best_ids(b)
        w_nb, g_nb = want.nbest_ids(b), got.nbest_ids(b)
        assert len(g_nb) == nbest
        assert [ids for ids, _ in g_nb] == [ids for ids, _ in w_nb]
        np.testing.assert_allclose([s for _, s in g_nb],
                                   [s for _, s in w_nb], atol=1e-3)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@functools.lru_cache(maxsize=None)
def shared_variables():
    """One set of tiny-Conformer weights for the three configurations
    (their flags change the attention's kernels, not the parameters)."""
    return model_pair({}, seed=2)[1]


@pytest.mark.parametrize("config", ["plain", "A", "B"])
def test_lm_fused_beam_token_exact(config):
    variables = shared_variables()
    fm = jax_models.E2E_Conformer_CTC(**TINY, **CONFIGS[config])
    pm = E2E_Conformer_CTC(**TINY, **CONFIGS[config], device="cpu")
    load_model_weights(pm, flax_to_state_dict(variables))
    lm_f, lm_v, lm_p = lm_pair(9, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 61, 20)).astype(np.float32)
    xlen = np.asarray([61, 43], np.int32)
    kw = dict(beam=4, ctc_beam=5, ctc_weight=0.5, nbest=3, lm_weight=0.3)
    want = JaxBeam(fm, variables, lm=JaxRNNLM(lm_f, {"params":
                                                     lm_v["params"]}),
                   **kw)(x, xlen)
    got = CTCAttBeamDecoder(pm, lm=RNNLM(lm_p), device="cpu", **kw)(x, xlen)
    check_hyps(got, want, 2, 3)


def test_lm_fused_online_beam_token_exact():
    fm, v, pm = pair(JaxOnline, E2E_Transformer_CTC_Online,
                     dict(ONLINE, encoder_num_blocks=1, decoder_num_block=1),
                     seed=4)
    lm_f, lm_v, lm_p = lm_pair(ONLINE["odim"], typ="gru", seed=9)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((3, 120, 80)).astype(np.float32)
    xlen = np.asarray([120, 80, 97], np.int32)
    kw = dict(beam=3, ctc_beam=5, ctc_weight=0.4, nbest=3, lm_weight=0.3,
              online=True)
    want = JaxBeam(fm, v, lm=JaxRNNLM(lm_f, lm_v), **kw)(x, xlen)
    got = CTCAttBeamDecoder(pm, lm=lm_p, device="cpu", **kw)(x, xlen)
    check_hyps(got, want, 3, 3)


def test_build_lm_rule_and_orbax_refusal(tmp_path, caplog):
    _, _, lm_p = lm_pair(9, seed=1)
    torch.save(lm_p.state_dict(), tmp_path / "lm.pt")
    conf = {"name": "lasr_tpu.modules.rnn:RNNCellStack",
            "kwargs": dict(input_dim=9, output_dim=9, n_layers=2,
                           n_units=16)}
    assert build_lm({"lm_rate": 0.0, "lm_config": conf,
                     "lm_path": str(tmp_path / "lm.pt")},
                    device="cpu") == (None, 0.0)
    assert build_lm({"lm_rate": 0.3}, device="cpu") == (None, 0.0)
    assert "lm_config/lm_path missing" in caplog.text
    lm, weight = build_lm({"lm_rate": 0.3, "lm_config": conf,
                           "lm_path": str(tmp_path / "lm.pt")}, device="cpu")
    assert weight == 0.3 and isinstance(lm.module, RNNCellStack)
    for k, x in lm_p.state_dict().items():
        assert torch.equal(lm.module.state_dict()[k], x)
    orbax_dir = tmp_path / "orbax_lm"
    orbax_dir.mkdir()
    (orbax_dir / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="orbax"):
        build_lm({"lm_rate": 0.3, "lm_config": conf,
                  "lm_path": str(orbax_dir)}, device="cpu")
