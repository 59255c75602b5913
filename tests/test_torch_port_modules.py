"""Port modules vs their Flax counterparts on bridged weights, at the
2e-4 bar of tests/test_torch_parity.py: rel-pos attention in each of its
three paths, the ConformerEncoder with decode-time solo padding, and the
Decoder's cached one-step decode over several steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.modules.attention import \
    RelPositionMultiHeadedAttention as JaxRelAttention
from lasr_tpu.modules.conformer import ConformerEncoder as JaxEncoder
from lasr_tpu.modules.embedding import RelPositionalEncoding as JaxRelPE
from lasr_tpu.modules.transformer import Decoder as JaxDecoder
from lasr_tpu_torch.modules.attention import RelPositionMultiHeadedAttention
from lasr_tpu_torch.modules.conformer import ConformerEncoder
from lasr_tpu_torch.modules.embedding import RelPositionalEncoding
from lasr_tpu_torch.modules.transformer import Decoder
from lasr_tpu_torch.utils.weights import flax_to_state_dict
from tests.torch_port_common import numpy_tree, perturb_batch_stats, t

ATOL = 2e-4
PATHS = {"rot_fold": dict(rot_fold=True),
         "rot_kernel": dict(rot_fold=True, rot_fold_pallas=True),
         "rel_kernel": dict(use_pallas=True)}


def _load(module, variables, prefix):
    """Bridge a sub-tree (wrapped under ``prefix`` for the name map) into a
    port module."""
    sd = flax_to_state_dict({c: {prefix: v} for c, v in variables.items()})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in sd.items()})
    return module.eval()


@pytest.mark.parametrize("path", list(PATHS))
def test_rel_attention_paths_match_flax(path):
    B, T, D, H = 2, 23, 16, 2
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    _, pos_emb = JaxRelPE(D).apply({}, jnp.asarray(x))
    _, port_pos = RelPositionalEncoding(D).eval()(t(x))
    np.testing.assert_allclose(port_pos.numpy(), np.asarray(pos_emb),
                               atol=1e-6)
    lens = np.asarray([T, 14])
    mask = (np.arange(T)[None, :] < lens[:, None])[:, None, :]
    jm = JaxRelAttention(H, D, **PATHS[path])
    args = (jnp.asarray(x),) * 3 + (pos_emb, jnp.asarray(mask))
    variables = numpy_tree(jm.init(jax.random.PRNGKey(1), *args))
    want = np.asarray(jm.apply(variables, *args))
    pm = _load(RelPositionMultiHeadedAttention(H, D, **PATHS[path]),
               variables, "attn")
    with torch.no_grad():
        got = pm(t(x), t(x), t(x), port_pos, t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("flags", [{}, {"rot_fold_pallas": True},
                                   {"use_pallas_attention": True}])
def test_conformer_encoder_solo_pad_matches_flax(flags):
    kw = dict(idim=20, attention_dim=16, attention_heads=2, linear_units=32,
              num_blocks=2, pos_enc_layer_type="rel_pos",
              selfattention_layer_type="rel_selfattn", cnn_module_kernel=7,
              **flags)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 53, 20)).astype(np.float32)
    xlen = np.asarray([53, 40, 31], np.int32)
    je = JaxEncoder(**kw)
    variables = je.init(jax.random.PRNGKey(2), jnp.asarray(x),
                        jnp.asarray(xlen))
    variables = perturb_batch_stats(numpy_tree(variables), 2)
    want, want_len = je.apply(variables, jnp.asarray(x), jnp.asarray(xlen),
                              solo_pad=True)
    pe = _load(ConformerEncoder(**kw), variables, "encoder")
    with torch.no_grad():
        got, got_len = pe(t(x), t(xlen), solo_pad=True)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for b, n in enumerate(np.asarray(want_len)):
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(want)[b, :n], atol=ATOL)


def test_decoder_cached_steps_match_flax():
    odim, D, H, L = 9, 16, 2, 2
    rng = np.random.default_rng(3)
    B, T, steps = 3, 11, 5
    mem = rng.standard_normal((B, T, D)).astype(np.float32)
    mem_len = np.asarray([11, 7, 9])
    mem_mask = (np.arange(T)[None, :] < mem_len[:, None])[:, None, :]
    ys = rng.integers(0, odim, (B, steps)).astype(np.int32)
    causal = np.tril(np.ones((steps, steps), bool))[None].repeat(B, 0)
    jd = JaxDecoder(odim, D, H, 32, L)
    variables = numpy_tree(jd.init(
        jax.random.PRNGKey(5), jnp.asarray(ys), jnp.asarray(causal),
        jnp.asarray(mem), jnp.asarray(mem_mask)))
    pd = _load(Decoder(odim, D, H, 32, L), variables, "decoder")

    full = jd.apply(variables, jnp.asarray(ys), jnp.asarray(causal),
                    jnp.asarray(mem), jnp.asarray(mem_mask))
    with torch.no_grad():
        got_full = pd(t(ys).long(), t(causal), t(mem), t(mem_mask))
    np.testing.assert_allclose(got_full.numpy(), np.asarray(full), atol=ATOL)

    Lmax = steps + 2
    cache = jd.apply(variables, B, Lmax, method=jd.init_cache)
    mk, mv = jd.apply(variables, jnp.asarray(mem), method=jd.project_memory)
    with torch.no_grad():
        pcache = pd.init_cache(B, Lmax)
        pk, pv = pd.project_memory(t(mem))
        np.testing.assert_allclose(pk.numpy(), np.asarray(mk), atol=1e-6)
        for pos in range(steps):
            want, cache = jd.apply(variables, jnp.asarray(ys[:, pos]), pos,
                                   cache, mk, mv, jnp.asarray(mem_mask),
                                   method=jd.forward_one_step)
            got, pcache = pd.forward_one_step(t(ys[:, pos]).long(), pos,
                                              pcache, pk, pv, t(mem_mask))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)
        np.testing.assert_allclose(pcache["k"].numpy(),
                                   np.asarray(cache["k"]), atol=1e-5)
