"""Train-mode modules of the port against lasr_tpu, f32, TINY widths:

  - the model's train-mode forward (``deterministic=False``, every dropout
    rate 0) in the table, rotated + rot-kernel (A-train) and rel-kernel
    (B-train) configurations against Flax with ``mutable=["batch_stats"]``:
    outputs within 2e-4, the updated BatchNorm statistics within 1e-5;
  - ``rel_shift`` and ``build_skewed_pos_table`` against JAX (exact);
  - SpecAugment applied with JAX's own draws (computed from its key as
    ``_time_warp_one`` and ``_masks_one`` do) within 1e-5;
  - ``pack_s2s`` exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.data.frontend import pack_s2s as jax_pack_s2s
from lasr_tpu.modules.attention import build_skewed_pos_table as jax_skew
from lasr_tpu.modules.attention import rel_shift as jax_rel_shift
from lasr_tpu.ops.specaug import _randint as jax_randint
from lasr_tpu.ops.specaug import spec_augment as jax_spec_augment
from lasr_tpu_torch.data.frontend import pack_s2s
from lasr_tpu_torch.modules.attention import build_skewed_pos_table, rel_shift
from lasr_tpu_torch.modules.dropout import dropout_generator
from lasr_tpu_torch.ops.specaug import apply_spec_augment, spec_augment
from lasr_tpu_torch.utils.weights import flax_to_state_dict
from tests.torch_port_common import data, model_pair, t

NO_DROPOUT = dict(encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
                  ctc_dropout=0.0)
TRAIN_CONFIGS = {
    "table": {},
    "A-train": {"encoder_rot_fold_pallas": True,
                "encoder_pos_dropout_mode": "rotated"},
    "B-train": {"encoder_use_pallas_attention": True},
}


@pytest.mark.parametrize("config", list(TRAIN_CONFIGS))
def test_train_forward_and_batch_stats_match_flax(config):
    fm, variables, pm = model_pair(TRAIN_CONFIGS[config], seed=2,
                                   **NO_DROPOUT)
    x, xlen, ys = data(seed=12)
    want, mutated = fm.apply(variables, jnp.asarray(x), jnp.asarray(xlen),
                             jnp.asarray(ys), deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(0)},
                             mutable=["batch_stats"])
    pm.train()
    with dropout_generator(torch.Generator().manual_seed(0)):
        got = pm(t(x), t(xlen), t(ys).long())
    np.testing.assert_array_equal(got["hs_len"].numpy(),
                                  np.asarray(want["hs_len"]))
    for key in ("att_out", "ctc_out"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=2e-4)
    stats = flax_to_state_dict({"batch_stats": jax.tree.map(
        np.asarray, mutated["batch_stats"])})
    ours = pm.state_dict()
    assert stats and all(k in ours for k in stats)
    for k, v in stats.items():
        if k.endswith("num_batches_tracked"):
            continue
        before = flax_to_state_dict({"batch_stats": variables[
            "batch_stats"]})[k]
        assert not torch.allclose(v, before)     # the statistics moved
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), atol=1e-5)


@pytest.mark.parametrize("T", [1, 6, 11])
def test_rel_shift_and_skewed_table_match_jax(T):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, 3, T, 2 * T - 1)).astype(np.float32)
    np.testing.assert_array_equal(rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_rel_shift(jnp.asarray(x))))
    e = rng.standard_normal((1, 2 * T - 1, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        build_skewed_pos_table(torch.from_numpy(e)).numpy(),
        np.asarray(jax_skew(jnp.asarray(e))))


def _jax_draws(key, feat_len, F, W, Fw, nF, Tw, nT):
    """JAX's draws, taken from ``key`` exactly as ``spec_augment`` /
    ``_time_warp_one`` / ``_masks_one`` take them."""
    names = ("center", "warped", "freq_bound", "freq_width", "freq_start",
             "time_bound", "time_width", "time_start")
    out = {n: [] for n in names}
    for k, t_len in zip(jax.random.split(key, len(feat_len)), feat_len):
        t_len = jnp.int32(t_len)
        kw, km = jax.random.split(k)
        k1, k2 = jax.random.split(kw)
        center = jax_randint(k1, W, jnp.maximum(t_len - W, W + 1))
        out["center"].append(int(center))
        out["warped"].append(int(jax_randint(k2, center - W, center + W)) + 1)
        keys = jax.random.split(km, nF + nT)
        for i in range(nF + nT):
            kb, kw_, ks = jax.random.split(keys[i], 3)
            top = Fw if i < nF else Tw
            bound = jax.random.randint(kb, (), 0, top)
            width = jax.random.randint(kw_, (), 0, top)
            hi = F - bound if i < nF else t_len - bound
            start = jax_randint(ks, 0, jnp.maximum(hi, 1))
            pre = "freq" if i < nF else "time"
            out[f"{pre}_bound"].append(int(bound))
            out[f"{pre}_width"].append(int(width))
            out[f"{pre}_start"].append(int(start))
    B = len(feat_len)
    shape = {"center": (B,), "warped": (B,), "freq_bound": (B, nF),
             "freq_width": (B, nF), "freq_start": (B, nF),
             "time_bound": (B, nT), "time_width": (B, nT),
             "time_start": (B, nT)}
    return {n: torch.tensor(v, dtype=torch.int32).reshape(shape[n])
            for n, v in out.items()}


@pytest.mark.parametrize("W,zero", [(5, False), (0, False), (3, True)])
def test_spec_augment_with_jax_draws_matches_jax(W, zero):
    rng = np.random.default_rng(W)
    B, T, F = 4, 60, 20
    feat_len = np.asarray([60, 44, 9, 0], np.int32)
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    feats *= (np.arange(T)[None, :] < feat_len[:, None])[..., None]
    kw = dict(max_time_warp=W, max_freq_width=7, n_freq_mask=2,
              max_time_width=12, n_time_mask=2, replace_with_zero=zero)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_spec_augment(jnp.asarray(feats),
                                       jnp.asarray(feat_len), key, **kw))
    draws = _jax_draws(key, feat_len, F, W, 7, 2, 12, 2)
    got = apply_spec_augment(torch.from_numpy(feats),
                             torch.from_numpy(feat_len), draws, W, zero)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert not np.allclose(want, feats)        # something was augmented
    # the port's own draws: same shape, padding zero, seeded
    g = torch.Generator().manual_seed(0)
    own = spec_augment(torch.from_numpy(feats), torch.from_numpy(feat_len),
                       g, **kw)
    again = spec_augment(torch.from_numpy(feats), torch.from_numpy(feat_len),
                         torch.Generator().manual_seed(0), **kw)
    assert torch.equal(own, again) and own.shape == feats.shape
    assert not bool(own[3].any()) and not bool(own[2, 9:].any())


def test_pack_s2s_matches_jax():
    rng = np.random.default_rng(0)
    tok = rng.integers(3, 50, (4, 6)).astype(np.int32)
    tok_len = np.asarray([6, 3, 0, 1], np.int32)
    want = jax_pack_s2s(jnp.asarray(tok), jnp.asarray(tok_len), sos=1, eos=2,
                        ignore=-1)
    got = pack_s2s(torch.from_numpy(tok), torch.from_numpy(tok_len), sos=1,
                   eos=2, ignore=-1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
