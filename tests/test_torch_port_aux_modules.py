"""The auxiliary modules of lasr_tpu_torch (interface, distances,
Conv2dSubsampling6/8 and Conv2dUpsampling, ConvPosEmbedding, VGG2L, the
fillier stack, the wav2vec stack and cpc_loss, the attention harvest)
against lasr_tpu's on the CPU, on bridged weights, in float32.

Every JAX call runs under ``jax.jit``; the JAX variables are seeded
draws from the shapes of the init (``seeded_variables``, no compile)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import lasr_tpu.models.distances as jd
import lasr_tpu.modules.embedding as jemb
import lasr_tpu.modules.fillier as jfill
import lasr_tpu.modules.subsampling as jsub
import lasr_tpu.modules.vgg as jvgg
import lasr_tpu.modules.wav2vec as jw2v
import lasr_tpu_torch.models.distances as pd
import lasr_tpu_torch.modules.embedding as pemb
import lasr_tpu_torch.modules.fillier as pfill
import lasr_tpu_torch.modules.subsampling as psub
import lasr_tpu_torch.modules.vgg as pvgg
import lasr_tpu_torch.modules.wav2vec as pw2v
from lasr_tpu.utils.torch_compat import torch_to_flax
from lasr_tpu_torch.utils.weights import (_torch_path, flax_to_state_dict,
                                          load_model_weights,
                                          state_dict_to_numpy)
from tests.torch_port_common import TOL, numpy_tree, seeded_variables, t


def _bridge(variables, port):
    """Load the Flax variables into the port module (eval mode)."""
    load_model_weights(port, flax_to_state_dict(variables))
    return port.eval()


def _round_trip(variables, skip=()):
    """flax → state_dict → ``lasr_tpu``'s torch_to_flax gives the same
    leaves back (but those under a name in ``skip``)."""
    sd = state_dict_to_numpy(flax_to_state_dict(variables))
    back = dict(jax.tree_util.tree_leaves_with_path(
        torch_to_flax(sd)["params"]))
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    assert len(back) == len(want)
    for path, a in want:
        if any(s in jax.tree_util.keystr(path) for s in skip):
            continue
        np.testing.assert_array_equal(back[path], a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---- items 1-2: the interface and the distances ----

def test_interface_matches_lasr_tpu():
    from lasr_tpu.models import interface as ji
    from lasr_tpu_torch.models import interface as pi
    d = {"x": 1}
    assert pi.EnptyModel().train_forward(d) is d
    assert pi.EnptyModel(3).valid_forward(d) == ji.EnptyModel(3) \
        .valid_forward(d)
    for name in ("get_input_dict", "get_out_dict"):
        with pytest.raises(NotImplementedError):
            getattr(pi.Model_Interface(), name)()
    with pytest.raises(NotImplementedError):
        pi.Model_Interface().valid_forward(d)


def _probs(rng, shape):
    a = np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1
    return a / a.sum(-1, keepdims=True)


DISTANCES = {
    "cosine": (lambda m: m.SeqCosineSimilarity(), "feats"),
    "pairwise": (lambda m: m.SeqPairwiseDistance(), "feats"),
    "pairwise_p1": (lambda m: m.SeqPairwiseDistance(p=1.0, eps=1e-3),
                    "feats"),
    "kl": (lambda m: m.SeqKLDistance(), "probs"),
    "ce_mean": (lambda m: m.SeqCEDistance(), "probs"),
    "ce_sum": (lambda m: m.SeqCEDistance("sum"), "probs"),
    "ce_none": (lambda m: m.SeqCEDistance("none"), "probs"),
}


@pytest.mark.parametrize("name", sorted(DISTANCES))
def test_distance_matches_lasr_tpu(name):
    make, kind = DISTANCES[name]
    rng = _rng(1)
    if kind == "probs":
        a, b = _probs(rng, (3, 7, 5)), _probs(rng, (3, 7, 5))
    else:
        a = rng.standard_normal((3, 7, 5)).astype(np.float32)
        b = rng.standard_normal((3, 7, 5)).astype(np.float32)
    want = jax.jit(make(jd))(a, b)
    _close(make(pd)(t(a), t(b)), want)


def test_seq_cross_entropy_and_cpc_loss_match_lasr_tpu():
    rng = _rng(2)
    logits = rng.standard_normal((2, 6, 9)).astype(np.float32)
    y = rng.integers(0, 9, (2, 6)).astype(np.int32)
    _close(pd.SeqCrossEntropy()(t(logits), t(y)),
           jax.jit(jd.SeqCrossEntropy())(logits, y))
    lg = 3 * rng.standard_normal((3, 2, 4, 10)).astype(np.float32)
    lab = np.zeros_like(lg)
    lab[0] = 1.0
    valid = np.broadcast_to(np.arange(10) < 10 - np.arange(1, 5)[:, None],
                            lg.shape).copy()
    _close(pw2v.cpc_loss(t(lg), t(lab), t(valid)),
           jax.jit(jw2v.cpc_loss)(lg, lab, valid))


# ---- item 3: subsampling and upsampling ----

@pytest.mark.parametrize("cls", ["Conv2dSubsampling", "Conv2dSubsampling6",
                                 "Conv2dSubsampling8"])
def test_conv2d_subsampling_matches_lasr_tpu(cls):
    B, T, idim, odim = 3, 67, 20, 8
    rng = _rng(3)
    x = rng.standard_normal((B, T, idim)).astype(np.float32)
    xlen = np.asarray([T, 50, 23], np.int32)
    fm = getattr(jsub, cls)(idim, odim, dropout_rate=0.0)
    v = seeded_variables(fm, 3, x, xlen)
    pm = getattr(psub, cls)(idim, odim, dropout_rate=0.0)
    sd = flax_to_state_dict({"params": {"embed": v["params"]}})
    load_model_weights(pm, {k[len("embed."):]: a for k, a in sd.items()})
    out, n = jax.jit(fm.apply)(v, x, xlen)
    with torch.no_grad():
        got, got_n = pm.eval()(t(x), t(xlen))
    _close(got, out)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(n))
    for length in (T, 50, 23, 0):
        assert psub.subsampled_len(length, T) == jsub.subsampled_len(
            length, T)


def _upsampling_variables(fm, x, asymmetric):
    v = seeded_variables(fm, 4, x)
    if asymmetric:
        # each transpose kernel a single tap off the centre: without the
        # spatial flip the output lands on other frames and bins
        for name in ("ConvTranspose_0", "ConvTranspose_1"):
            k = np.zeros_like(v["params"][name]["kernel"])
            k[0, 2] = np.eye(*k.shape[2:], dtype=k.dtype) + 0.5
            v["params"][name]["kernel"] = k
    return v


@pytest.mark.parametrize("idim,asymmetric", [(80, True), (83, False),
                                             (21, True)])
def test_conv2d_upsampling_matches_lasr_tpu(idim, asymmetric):
    B, T, odim = 2, 9, 6
    x = _rng(5).standard_normal((B, T, odim)).astype(np.float32)
    fm = jsub.Conv2dUpsampling(idim, odim, dropout_rate=0.0)
    v = _upsampling_variables(fm, x, asymmetric)
    pm = _bridge(v, psub.Conv2dUpsampling(idim, odim, dropout_rate=0.0))
    want = jax.jit(fm.apply)(v, x)
    with torch.no_grad():
        got = pm(t(x))
    assert got.shape == want.shape == (B, 4 * T + 3, idim)
    _close(got, want)
    if asymmetric:
        # the flip is what makes them agree
        with torch.no_grad():
            for m in (pm.ConvTranspose_0, pm.ConvTranspose_1):
                m.weight.copy_(m.weight.flip(2, 3))
            assert (pm(t(x)) - t(want)).abs().max() > 0.1
    _round_trip(v, skip=("ConvTranspose",))


# ---- item 4: ConvPosEmbedding ----

@pytest.mark.parametrize("kw", [dict(), dict(kernel_size=7, groups=4)])
def test_conv_pos_embedding_matches_lasr_tpu(kw):
    B, T, d = 2, 70, 32
    x = _rng(6).standard_normal((B, T, d)).astype(np.float32)
    fm = jemb.ConvPosEmbedding(d, dropout_rate=0.0, **kw)
    v = seeded_variables(fm, 6, x)
    pm = _bridge(v, pemb.ConvPosEmbedding(d, dropout_rate=0.0, **kw))
    with torch.no_grad():
        _close(pm(t(x)), jax.jit(fm.apply)(v, x))
    _round_trip(v)


# ---- item 5: VGG2L ----

def test_vgg2l_sub_len_follows_the_mask_slicing():
    assert jvgg.vgg2l_sub_len(61, 61) == pvgg.vgg2l_sub_len(61, 61) == 10
    for T in (61, 60, 24, 7):
        for n in range(T + 1):
            mask = np.arange(T) < n
            t1 = mask[: T - T % 3][::3]
            want = t1[: len(t1) - len(t1) % 2][::2].sum()
            assert pvgg.vgg2l_sub_len(n, T) == want, (T, n)
            assert int(pvgg.vgg2l_sub_len(torch.tensor(n), T)) == want


@pytest.mark.parametrize("domain_dim", [0, 4])
def test_vgg2l_matches_lasr_tpu(domain_dim):
    B, T, idim, odim = 3, 61, 20, 16
    rng = _rng(7)
    x = rng.standard_normal((B, T, idim)).astype(np.float32)
    xlen = np.asarray([61, 40, 13], np.int32)
    tag = rng.standard_normal((B, domain_dim)).astype(np.float32) \
        if domain_dim else None
    fm = jvgg.VGG2L(idim, odim, domain_dim=domain_dim)
    v = seeded_variables(fm, 7, x, xlen, tag)
    pm = _bridge(v, pvgg.VGG2L(idim, odim, domain_dim=domain_dim))
    out, n = jax.jit(fm.apply)(v, x, xlen, tag)
    with torch.no_grad():
        got, got_n = pm(t(x), t(xlen), None if tag is None else t(tag))
    assert got.shape == (B, 10, odim)
    _close(got, out)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(n))
    assert got_n.tolist() == [10, 7, 3]
    _round_trip(v)


# ---- item 6: the fillier stack ----

def test_fillier_blocks_match_lasr_tpu():
    rng = _rng(8)
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    for jcls, pcls in ((jfill.ConvBlock, pfill.ConvBlock),
                       (jfill.ConvBlockFinal, pfill.ConvBlockFinal)):
        fm = jcls(5, dropout_rate=0.0)
        v = seeded_variables(fm, 8, x)
        pm = _bridge(v, pcls(5, dropout_rate=0.0))
        with torch.no_grad():
            _close(pm(t(x)), jax.jit(fm.apply)(v, x))


@pytest.mark.parametrize("conv_1x1", [False, True])
def test_fillier_embedding_and_head_match_lasr_tpu(conv_1x1):
    rng = _rng(9)
    x = rng.standard_normal((2, 64, 32, 1)).astype(np.float32)
    fm = jfill.EmbeddingModel(dropout_rate=0.0)
    v = seeded_variables(fm, 9, x)
    pm = _bridge(v, pfill.EmbeddingModel(dropout_rate=0.0))
    want = jax.jit(fm.apply)(v, x)
    with torch.no_grad():
        got = pm(t(x))
    assert got.shape == (2, 2, 1, 96)
    _close(got, want)
    _round_trip(v)
    feat = np.ascontiguousarray(
        rng.standard_normal((2, 96, 7, 1)).astype(np.float32))
    head = jfill.Classification(96, 7, 5, dropout_rate=0.0,
                                conv_1x1=conv_1x1)
    vh = seeded_variables(head, 10, feat)
    ph = _bridge(vh, pfill.Classification(96, 7, 5, dropout_rate=0.0,
                                          conv_1x1=conv_1x1))
    with torch.no_grad():
        _close(ph(t(feat)), jax.jit(head.apply)(vh, feat))


# ---- item 7: the wav2vec stack ----

W2V_ENC = dict(conv_layers=((16, 10, 5), (16, 4, 2), (24, 3, 1)),
               dropout=0.0, log_compression=True, skip_connections=True,
               residual_scale=0.5)
W2V_AGG = dict(conv_layers=((24, 3, 1), (16, 2, 1), (16, 3, 1)),
               embed=24, dropout=0.0, skip_connections=True,
               residual_scale=0.5, conv_bias=True)


@pytest.mark.parametrize("zero_pad,non_affine",
                         [(False, False), (True, True)])
def test_wav2vec_encoder_and_aggregator_match_lasr_tpu(zero_pad, non_affine):
    wav = _rng(11).standard_normal((2, 900)).astype(np.float32)
    enc = jw2v.ConvFeatureExtractionModel(
        **W2V_ENC, non_affine_group_norm=non_affine)
    ve = seeded_variables(enc, 11, wav)
    pe = _bridge(ve, pw2v.ConvFeatureExtractionModel(
        **W2V_ENC, non_affine_group_norm=non_affine))
    z = jax.jit(enc.apply)(ve, wav)
    with torch.no_grad():
        _close(pe(t(wav)), z)
    agg = jw2v.ConvAggegator(**W2V_AGG, zero_pad=zero_pad,
                             non_affine_group_norm=non_affine)
    va = seeded_variables(agg, 12, z)
    pa = _bridge(va, pw2v.ConvAggegator(**W2V_AGG, zero_pad=zero_pad,
                                        non_affine_group_norm=non_affine))
    with torch.no_grad():
        _close(pa(t(z)), jax.jit(agg.apply)(va, z))
    _round_trip(ve)
    _round_trip(va)


@pytest.mark.parametrize("cross", [False, True])
def test_wav2vec_predictions_match_lasr_tpu_on_the_jax_draws(cross):
    B, T, C, N, S = 2, 13, 8, 3, 4
    rng = _rng(13)
    c = rng.standard_normal((B, T, 6)).astype(np.float32)
    z = rng.standard_normal((B, T, C)).astype(np.float32)
    kw = dict(prediction_steps=S, n_negatives=N, dropout=0.0, offset=1,
              cross_sample_negatives=cross)
    fm = jw2v.Wav2VecPredictionsModel(6, C, **kw)
    key = jax.random.PRNGKey(5)
    v = seeded_variables(fm, 13, c, z, key)
    pm = _bridge(v, pw2v.Wav2VecPredictionsModel(6, C, **kw))
    logits, labels, valid = jax.jit(fm.apply)(v, c, z, key)
    # the indices lasr_tpu's sample_negatives draws from the same key
    idx = np.asarray(jax.random.randint(key, (N, B, T), 0,
                                        B * T if cross else T))
    with torch.no_grad():
        got = pm(t(c), t(z), neg_idx=t(idx))
    assert got[0].shape == (1 + N, B, S, T)
    _close(got[0], logits)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(labels))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(valid))
    _close(pw2v.cpc_loss(*got), jax.jit(jw2v.cpc_loss)(logits, labels,
                                                       valid))
    _round_trip(v)
    # the generator form draws in range and is reproducible
    g = [torch.Generator().manual_seed(3) for _ in range(2)]
    a, b = (pm.sample_indices(B, T, gen) for gen in g)
    assert torch.equal(a, b) and 0 <= int(a.min()) and \
        int(a.max()) < (B * T if cross else T)


# ---- item 8: the attention harvest ----

def _harvest_pair(kind, flags):
    import lasr_tpu.models.e2e_ctc_att as jm
    import lasr_tpu_torch.models.e2e_ctc_att as pmod
    from lasr_tpu.utils.plot import collect_attention_maps
    from lasr_tpu_torch.utils.plot import calculate_all_attentions as p_calc
    from tests.torch_port_common import TINY, data
    kw = dict(TINY, **flags)
    if kind == "transformer":
        kw = {k: v for k, v in kw.items() if not k.startswith(
            ("encoder_pos", "encoder_self", "encoder_cnn"))}
    x, xlen, ys = data(D=kw["idim"], odim=kw["odim"], seed=14)
    cls = {"conformer": "E2E_Conformer_CTC",
           "transformer": "E2E_Transformer_CTC"}[kind]
    fm = getattr(jm, cls)(**kw)
    v = seeded_variables(fm, 14, x, xlen, ys)
    pm = getattr(pmod, cls)(**kw, device="cpu")
    load_model_weights(pm, flax_to_state_dict(numpy_tree(v)))
    # lasr_tpu's calculate_all_attentions, with its apply compiled
    _, inter = jax.jit(lambda v_, a, b, c: fm.apply(
        v_, a, b, c, mutable=["intermediates"]))(v, x, xlen, ys)
    jmaps = collect_attention_maps(inter["intermediates"])
    want = {".".join(_torch_path(tuple(k.split(".")))): a
            for k, a in jmaps.items()}
    got = p_calc(pm, t(x), t(xlen), t(ys).long())
    return got, want


@pytest.mark.parametrize("kind,config", [
    ("conformer", "plain"), ("conformer", "rot_fold_pallas"),
    ("conformer", "rel_kernel"), ("transformer", "plain")])
def test_calculate_all_attentions_matches_lasr_tpu(kind, config):
    flags = {"plain": {},
             "rot_fold_pallas": {"encoder_rot_fold_pallas": True},
             "rel_kernel": {"encoder_use_pallas_attention": True}}[config]
    got, want = _harvest_pair(kind, flags)
    assert sorted(got) == sorted(want)
    enc = [k for k in got if k.startswith("encoder.")]
    # the rel kernel computes no probabilities: no encoder maps, as in
    # lasr_tpu; every other path harvests both encoder blocks
    assert len(enc) == (0 if config == "rel_kernel" else 2)
    assert len(got) - len(enc) == 4       # 2 decoder blocks x self / src
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)


def test_plot_multi_head_attention_writes_one_png_a_module(tmp_path):
    from lasr_tpu_torch.utils.plot import plot_multi_head_attention
    maps = {"a.b": np.random.default_rng(0).random((1, 2, 3, 4))}
    plot_multi_head_attention(maps, str(tmp_path), uid="u")
    assert (tmp_path / "u.a.b.png").stat().st_size > 0


# ---- the registry ----

@pytest.mark.parametrize("name,kwargs,cls", [
    ("lasr_tpu.modules.vgg:VGG2L", dict(idim=20, odim=8), pvgg.VGG2L),
    ("lasr_tpu.modules.wav2vec:ConvAggegator", dict(embed=8, conv_layers=[
        [8, 3, 1]]), pw2v.ConvAggegator),
    ("lasr_tpu.modules.subsampling:Conv2dSubsampling8",
     dict(idim=20, odim=8), psub.Conv2dSubsampling8),
    ("lasr_tpu.models.distances:SeqCEDistance", dict(reduction="sum"),
     pd.SeqCEDistance)])
def test_yaml_builds_the_aux_modules_through_the_registry(tmp_path, name,
                                                          kwargs, cls):
    import yaml
    from lasr_tpu_torch.utils.registry import BaseConfig
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({"m": {"name": name, "kwargs": kwargs}}))
    conf = yaml.safe_load(path.read_text())["m"]
    assert isinstance(BaseConfig(conf["name"], conf["kwargs"])
                      .generateExample(), cls)


_BLOCKED = ("jax", "flax", "tokenizers", "tensorboard", "matplotlib")
_PROBE = f"""
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {_BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in ("modules.vgg", "modules.wav2vec", "modules.fillier",
          "models.distances", "models.interface", "utils.plot"):
    importlib.import_module("lasr_tpu_torch." + m)
print(sorted(n for n in sys.modules if n.split(".")[0] in {_BLOCKED!r}))
"""


def test_aux_modules_import_without_the_optional_packages():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", \
        res.stdout + res.stderr
