"""Shared fixtures of the lasr_tpu_torch parity tests: one TINY Conformer
configuration, built in both packages from one seed, with the weights
handed across as numpy arrays through the weight bridge; and the tiny
Transformer and streaming configurations (test_streaming.py's widths)
with their model-pair, batch and loss-check helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import lasr_tpu.models.e2e_ctc_att as jax_models
import lasr_tpu.models.losses as jax_losses
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.losses import E2E_Loss
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


def seeded_variables(fm, seed, *args):
    """Seeded random variables of the Flax module ``fm`` for the inputs
    ``args``, from the shapes of its init (traced, not compiled): kernels
    N(0, 1/fan_in), embeddings N(0, 1), norm scales and BatchNorm
    variances near 1, the scaled encoding's alpha in [0.5, 1.5], the rest
    N(0, 0.01)."""
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['scale']", "['var']", "['alpha']")):
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name.endswith("['kernel']"):
            x = rng.standard_normal(s.shape) / np.sqrt(
                np.prod(s.shape[:-1]))
        elif name.endswith("['embedding']"):
            x = rng.standard_normal(s.shape)
        else:
            x = 0.1 * rng.standard_normal(s.shape)
        return x.astype(s.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


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


ONLINE = dict(idim=80, odim=11, encoder_attention_dim=16,
              encoder_attention_heads=2, encoder_left_chunk=16,
              encoder_center_chunk=16, encoder_right_chunk=16,
              encoder_linear_units=32, encoder_num_blocks=2,
              decoder_attention_dim=16, decoder_self_attention_heads=2,
              decoder_src_attention_heads=2, decoder_linear_units=32,
              decoder_num_block=2, decoder_src_attention_sigmoid_noise=0.0)
OFFLINE = dict(idim=80, odim=11, encoder_attention_dim=16,
               encoder_attention_heads=2, encoder_linear_units=32,
               encoder_num_blocks=2, decoder_attention_dim=16,
               decoder_attention_heads=2, decoder_linear_units=32,
               decoder_num_block=2)
TOL = 2e-4


def batch(B=3, T=120, D=80, L=5, odim=11, seed=0):
    """Ragged features and targets: x (B, T, D), xlen, ys (B, L) padded
    with -1 past each row's length."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    xlen = np.asarray([T, T - 40, T - 23][:B], np.int32)
    ys = rng.integers(3, odim, (B, L)).astype(np.int32)
    ys[1:, L - 2:] = -1
    return x, xlen, ys


def pair(cls_jax, cls_port, kw, seed=0, src_bias=0.0, ctc_scale=1.0,
         jit=False):
    """(flax model, numpy variables, port model on the CPU with the same
    weights).  ``src_bias`` sets every ``src_att_bias``, ``ctc_scale``
    sharpens the CTC head (so greedy decoding emits tokens); ``jit``
    compiles the init (faster than tracing it eagerly for the chunked
    encoder)."""
    x, xlen, ys = batch(odim=kw["odim"], seed=seed)
    fm = cls_jax(**kw)
    init = jax.jit(fm.init) if jit else fm.init
    v = numpy_tree(init(jax.random.PRNGKey(seed), x, xlen,
                        np.maximum(ys, 1)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.full_like(a, src_bias)
                      if jax.tree_util.keystr(p).endswith("['src_att_bias']")
                      else a * ctc_scale
                      if "['ctc']" in jax.tree_util.keystr(p) else a),
        v["params"])
    v = {"params": params}
    pm = cls_port(**kw, device="cpu")
    load_model_weights(pm, flax_to_state_dict(v))
    return fm, v, pm


def labels(ys, sos=1, eos=2):
    """(ys_in, att_label, ctc_label) of -1-padded targets."""
    B, L = ys.shape
    n = (ys >= 0).sum(1)
    ys_in = np.full((B, L + 1), eos, np.int32)
    att = np.full((B, L + 1), -1, np.int32)
    ys_in[:, 0] = sos
    for b in range(B):
        ys_in[b, 1: n[b] + 1] = ys[b, : n[b]]
        att[b, : n[b]] = ys[b, : n[b]]
        att[b, n[b]] = eos
    return ys_in, att, ys


def check_forward_and_loss(fm, v, pm, seed):
    x, xlen, ys = batch(odim=pm.ctc[1].out_features, seed=seed + 10)
    ys_in, att_label, ctc_label = labels(ys)
    want = fm.apply(v, x, xlen, ys_in)
    with torch.no_grad():
        got = pm(t(x), t(xlen), t(ys_in).long())
    for k in ("att_out", "ctc_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=TOL, err_msg=k)
    np.testing.assert_array_equal(got["hs_len"].numpy(),
                                  np.asarray(want["hs_len"]))
    V = pm.ctc[1].out_features
    lw = jax_losses.E2E_Loss(V, smoothing=0.1, rate=0.3)(
        want["att_out"], want["ctc_out"], jnp.asarray(att_label),
        jnp.asarray(ctc_label), want["hs_len"])
    lp = E2E_Loss(V, smoothing=0.1, rate=0.3)(
        got["att_out"], got["ctc_out"], t(att_label), t(ctc_label),
        got["hs_len"])
    for g, w in zip(lp, lw):
        np.testing.assert_allclose(float(g), float(w), rtol=TOL, atol=TOL)


def round_trip(v, pm):
    """The port's state_dict back through ``torch_compat.torch_to_flax``
    gives the variables ``v`` it was loaded from, bit for bit."""
    from lasr_tpu.utils.torch_compat import torch_to_flax
    back = torch_to_flax({k: x.numpy() for k, x in pm.state_dict().items()},
                         template=v)
    flat_v = jax.tree_util.tree_leaves_with_path(v["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(flat_b) == len(flat_v)
    for path, a in flat_v:
        np.testing.assert_array_equal(flat_b[path], a)


# the bf16 tests' Conformer: 2 blocks of d=64, 4 heads, 256 units, 2
# decoder blocks, rel-pos attention (the recipe's), fbank:80 input
BF16 = dict(idim=80, odim=32, encoder_attention_dim=64,
            encoder_attention_heads=4, encoder_linear_units=256,
            encoder_num_blocks=2, decoder_attention_dim=64,
            decoder_attention_heads=4, decoder_linear_units=256,
            decoder_num_block=2, encoder_pos_enc_layer_type="rel_pos",
            encoder_selfattention_layer_type="rel_selfattn",
            encoder_cnn_kernel=15)
# served (table = the recipe's own flags; eval takes the plain rotated
# fold) and trained configurations
SERVED = {"table": {}, "A": {"encoder_rot_fold_pallas": True},
          "B": {"encoder_use_pallas_attention": True}}
TRAINED = {"A-train": {"encoder_rot_fold_pallas": True,
                       "encoder_pos_dropout_mode": "rotated"},
           "B-train": {"encoder_use_pallas_attention": True}}


def bf16_batch(B=3, T=120, D=80, L=6, odim=32, seed=0):
    """Ragged features (B, T, D), lengths and targets (B, L) in 3..odim."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    xlen = np.asarray([T, T - 23, T - 56][:B], np.int32)
    ys = rng.integers(3, odim, (B, L)).astype(np.int32)
    return x, xlen, ys


def bf16_pair(flags, seed=0, **overrides):
    """(flax f32 model, flax bf16 model, numpy variables with perturbed
    BatchNorm statistics, the port's bf16 model on the CPU with the same
    weights) of ``BF16`` with ``flags``."""
    kw = dict(BF16, **dict(flags), **overrides)
    x, xlen, ys = bf16_batch(D=kw["idim"], odim=kw["odim"], seed=seed)
    f32 = jax_models.E2E_Conformer_CTC(**kw)
    variables = numpy_tree(f32.init(jax.random.PRNGKey(seed), x, xlen, ys))
    variables = perturb_batch_stats(variables, seed)
    pm = E2E_Conformer_CTC(**kw, dtype=torch.bfloat16, device="cpu")
    load_model_weights(pm, flax_to_state_dict(variables))
    return (f32, jax_models.E2E_Conformer_CTC(**kw, dtype=jnp.bfloat16),
            variables, pm)


def rel_max_err(got, want):
    """max |got - want| over max |want| (tensors or arrays of any float
    dtype)."""
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def f32(x):
    """A torch tensor or JAX/numpy array of any float dtype as float32
    numpy."""
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def flax_state_dict(params, batch_stats=None):
    tree = {"params": numpy_tree(params)}
    if batch_stats is not None:
        tree["batch_stats"] = numpy_tree(batch_stats)
    return flax_to_state_dict(tree)


def jax_grad(jt, state, batch, with_loss=False):
    """lasr_tpu's train-step gradient at ``state`` (no update); with
    ``with_loss``, (loss_main, gradient)."""
    feats, feat_len = jt.frontend(jnp.asarray(batch["wav_array"]),
                                  jnp.asarray(batch["wav_len"]))
    ys_in, att_label, ctc_label = jt._pack(jnp.asarray(batch["token_id"]),
                                           jnp.asarray(batch["token_len"]))

    def loss(params):
        out, _ = jt._apply_model(params, state.batch_stats, feats, feat_len,
                                 ys_in, jax.random.PRNGKey(0), train=True)
        data = dict(out, att_label=att_label, ctc_label=ctc_label)
        return jt.criterion.train_forward(data)["loss_main"]
    if with_loss:
        return jax.jit(jax.value_and_grad(loss))(state.params)
    return jax.jit(jax.grad(loss))(state.params)
