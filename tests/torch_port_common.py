"""Shared fixtures of the lasr_tpu_torch parity tests: one TINY Conformer
configuration, built in both packages from one seed, with the weights
handed across as numpy arrays through the weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.utils.weights import flax_to_state_dict, load_model_weights

# tests/test_torch_parity.py's TINY, with rel-pos attention and k=7 convs
TINY = dict(idim=20, odim=9,
            encoder_attention_dim=16, encoder_attention_heads=2,
            encoder_linear_units=32, encoder_num_blocks=2,
            decoder_attention_dim=16, decoder_attention_heads=2,
            decoder_linear_units=32, decoder_num_block=2,
            encoder_pos_enc_layer_type="rel_pos",
            encoder_selfattention_layer_type="rel_selfattn",
            encoder_cnn_kernel=7)

# the served configurations: plain rotated fold, A (rot kernel), B (rel
# kernel)
CONFIGS = {"plain": {}, "A": {"encoder_rot_fold_pallas": True},
           "B": {"encoder_use_pallas_attention": True}}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_batch_stats(variables, seed):
    """Non-trivial BatchNorm statistics, so eval-mode normalization is
    actually exercised."""
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def data(B=2, T=45, D=20, L=5, odim=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    xlen = np.asarray([T] + [T - 9] * (B - 1), dtype=np.int32)
    ys = rng.integers(1, odim, (B, L)).astype(np.int32)
    return x, xlen, ys


def model_pair(flags=(), seed=0, **overrides):
    """(flax model, its numpy variables, the port model on the CPU with the
    same weights)."""
    kw = dict(TINY, **dict(flags), **overrides)
    x, xlen, ys = data(D=kw["idim"], odim=kw["odim"], seed=seed)
    fm = jax_models.E2E_Conformer_CTC(**kw)
    variables = fm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        jnp.asarray(xlen), jnp.asarray(ys))
    variables = perturb_batch_stats(numpy_tree(variables), seed)
    pm = E2E_Conformer_CTC(**kw, device="cpu")
    load_model_weights(pm, flax_to_state_dict(variables))
    return fm, variables, pm


def t(x):
    return torch.from_numpy(np.asarray(x))
