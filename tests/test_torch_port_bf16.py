"""bf16 compute of the port (``dtype=torch.bfloat16``) against lasr_tpu's
``dtype=jnp.bfloat16`` on the CPU, on identical weights (lasr_tpu's init,
bridged) at small widths (``BF16``: 2 Conformer blocks of d=64, 4 heads,
256 units, 2 decoder blocks, 120 input frames).  lasr_tpu's Pallas kernels
run in interpret mode, the port's wrappers run their plain versions.

  - The dtype map: every submodule's output dtype, matched by name through
    the weight bridge, equals Flax's (``capture_intermediates``); this is
    what catches an autocast-style float32 residual stream.  After a train
    step the parameters, gradients, BatchNorm statistics, loss, Adam state
    and EMA are float32.
  - Forwards in table / A / B: encoder output, CTC and decoder logits
    within 2e-2 of each tensor's largest magnitude, the loss within 1e-2
    relative (lasr_tpu's own bf16-vs-f32 distance is printed beside).
  - One train step in A-train and B-train against lasr_tpu's Trainer:
    gradients and updated parameters within 5e-2 relative L2 per
    parameter group (the input layer, each block, the norms and heads);
    the two leaves whose true gradient is 0 (an attention's key bias, the
    depthwise conv's bias before a train-mode BatchNorm) are held to be
    ~0 against the largest gradient instead.
  - K1-K4's plain versions on bf16 inputs against the Pallas kernels in
    interpret mode within 2e-2, and at least as close as the same math
    without the kernels' bf16 rounding.
  - The joint CTC/attention beam search (beam 4) over a bf16 model:
    token-exact, or, where the best hypotheses differ, a tie: both
    packages score both hypotheses alike within 2e-2 relative, and at
    some token step the port's beam cut between two candidates that close
    (the pruning took another path; the models score alike).
  - The train CLI with ``-fp16 16`` against ``bin/train.py -fp16 16``: the
    ``metrics.jsonl`` losses within 1e-2; the port's checkpoint decodes
    alike in both packages' (float32) decode CLIs.
  - What still raises: float16 and other dtypes, on each model class
    (the streaming model builds in bf16).
"""

import collections
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

import lasr_tpu.models.e2e_ctc_att as jax_models
import lasr_tpu.models.losses as jax_losses
from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.decode.beam import CTCAttBeamDecoder as JaxBeam
from lasr_tpu.ops.ctc import ctc_forward_from_logits as jax_ctc
from lasr_tpu.ops.rel_attention import (_rel_attention_pallas,
                                        _rel_attention_pallas_bwd)
from lasr_tpu.ops.rot_attention import (_rot_attention_pallas,
                                        _rot_attention_pallas_bwd)
from lasr_tpu.parallel.mesh import make_mesh
from lasr_tpu.train.optimizer import Adam as JaxAdam
from lasr_tpu.train.trainer import Trainer as JaxTrainer
from lasr_tpu_torch.bin import decode as port_decode
from lasr_tpu_torch.bin import train as port_train
from lasr_tpu_torch.decode import beam as port_beam
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.models.e2e_ctc_att import (E2E_Conformer_CTC,
                                               E2E_Transformer_CTC,
                                               check_dtype)
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.modules.layers import Computes
from lasr_tpu_torch.ops.ctc import ctc_forward_from_logits
from lasr_tpu_torch.ops.rel_attention import (
    rel_attention_backward_reference, rel_attention_reference)
from lasr_tpu_torch.ops.rot_attention import (
    rot_attention_backward_reference, rot_attention_reference)
from lasr_tpu_torch.train.optimizer import Adam
from lasr_tpu_torch.train.trainer import Trainer
from lasr_tpu_torch.utils.weights import (_torch_path, flax_to_state_dict,
                                          load_model_weights)
from tests import test_torch_port_attention_bwd as bwd_cases
from tests.test_torch_port_attention_ops import _rel_case, _rot_case
from tests.test_torch_port_cli import (REPO, _decode_lines, _jax_cli,
                                       write_config,
                                       write_corpus, write_decode_config)
from tests.torch_port_common import (BF16, OFFLINE, ONLINE, SERVED, TRAINED,
                                     bf16_batch, bf16_pair, f32,
                                     flax_state_dict, jax_grad, labels,
                                     numpy_tree, rel_max_err, round_trip, t)

FWD_TOL = 2e-2       # of each tensor's largest magnitude
LOSS_TOL = 1e-2      # relative
GRAD_TOL = 5e-2      # relative L2 per parameter group
NOISE_LEAVES = ("linear_k.bias", "conv_module.depthwise_conv.bias")
ADAM = dict(lr=1e-3, eps=1e-3)    # test_torch_port_trainer.py's choice
CHAIN = ["norm", "fbank:80"]
NODROP = dict(encoder_dropout_rate=0.0, decoder_dropout_rate=0.0,
              ctc_dropout=0.0)


@functools.lru_cache(maxsize=None)
def _pair(config):
    """``bf16_pair`` of a SERVED configuration, made once for every test
    that reads it (none changes it)."""
    return bf16_pair(SERVED[config])


def _ragged_labels(ys):
    ys = ys.copy()
    ys[1, -2:] = -1
    ys[2, -3:] = -1
    return labels(ys)


# ---- the dtype map ----

def _dtypes(out):
    """Leaf dtype names of a module output (dicts by sorted key)."""
    if torch.is_tensor(out):
        return [str(out.dtype).replace("torch.", "")]
    if isinstance(out, dict):
        return [d for k in sorted(out) for d in _dtypes(out[k])]
    if isinstance(out, (tuple, list)):
        return [d for o in out for d in _dtypes(o)]
    return []


def _port_dtype_map(pm, x, xlen, ys_in):
    """{module name: output dtypes} of each module's first call."""
    seen = {}

    def hook(name):
        def record(module, inputs, out):
            seen.setdefault(name, _dtypes(out))
        return record
    hooks = [m.register_forward_hook(hook(name))
             for name, m in pm.named_modules()]
    try:
        with torch.no_grad():
            pm(t(x), t(xlen), t(ys_in).long())
    finally:
        for h in hooks:
            h.remove()
    return seen


def _flax_dtype_map(fm, variables, x, xlen, ys_in):
    """{port module name: output dtypes} of every Flax module call."""
    _, state = fm.apply(variables, x, xlen, ys_in, capture_intermediates=True,
                        mutable=["intermediates"])
    # modules without parameters that the weight bridge does not name
    extra = {("decoder", "embed_pos"): "decoder.embed.1"}
    out = {}
    for path, calls in flatten_dict(state["intermediates"]).items():
        if path[-1] != "__call__":
            continue
        mod = path[:-1]
        name = extra.get(mod, ".".join(_torch_path(mod)))
        out[name] = [str(a.dtype) for a in jax.tree.leaves(calls[0])]
    return out


@pytest.mark.parametrize("config", list(SERVED))
def test_dtype_map_equals_flax(config):
    _, fb, v, pm = _pair(config)
    x, xlen, ys = bf16_batch()
    ys_in, _, _ = _ragged_labels(ys)
    got = _port_dtype_map(pm, x, xlen, ys_in)
    want = _flax_dtype_map(fb, v, x, xlen, ys_in)
    matched = sorted(set(got) & set(want))
    for name in matched:
        assert got[name] == want[name], name
    # every port layer that casts, and every block, has its Flax twin
    casting = {n for n, m in pm.named_modules()
               if isinstance(m, Computes) and n in got}
    assert casting <= set(matched), casting - set(matched)
    assert {"", "encoder", "decoder", "ctc", "encoder.encoders.1",
            "decoder.decoders.1", "encoder.embed.pos_enc"} <= set(matched)
    assert len(matched) >= 60
    # the residual stream and the heads are bf16, as in lasr_tpu
    assert got["encoder.encoders.0"] == ["bfloat16"]
    assert got[""] == ["bfloat16", "bfloat16", "int32"]


def test_train_state_stays_float32():
    kw = dict(BF16, **NODROP, **TRAINED["B-train"])
    model = E2E_Conformer_CTC(**kw, dtype="bfloat16", device="cpu")
    pt = Trainer(model, E2E_Loss(BF16["odim"], smoothing=0.1, rate=0.3),
                 Adam(**ADAM), DeviceFrontend(CHAIN), use_ema=True,
                 log_interval=1, device="cpu")
    batch = _wave_batch()
    metrics, grads = pt.loss_and_grads(batch, 0)
    assert metrics["loss_main"].dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)
    state, _ = pt.train_step(pt.init_state(), batch)
    tensors = dict(model.state_dict())
    tensors.update({f"mu.{i}": m for i, m in enumerate(state.opt_state["mu"])})
    tensors.update({f"nu.{i}": m for i, m in enumerate(state.opt_state["nu"])})
    tensors.update({f"ema.{i}": s for i, s in enumerate(state.ema["shadow"])})
    for name, x in tensors.items():
        if not name.endswith("num_batches_tracked"):
            assert x.dtype == torch.float32, name
    assert any(n.endswith("norm.running_var") for n in tensors)


# ---- forwards ----

@pytest.mark.parametrize("config", list(SERVED))
def test_forward_matches_jax_bf16(config):
    f32m, fb, v, pm = _pair(config)
    x, xlen, ys = bf16_batch(seed=1)
    ys_in, att_label, ctc_label = _ragged_labels(ys)

    def enc(m, a, b):
        return m.encoder(a, b)[0]
    want = dict(fb.apply(v, x, xlen, ys_in),
                hs=fb.apply(v, x, xlen, method=enc))
    ref32 = dict(f32m.apply(v, x, xlen, ys_in),
                 hs=f32m.apply(v, x, xlen, method=enc))
    with torch.no_grad():
        got = dict(pm(t(x), t(xlen), t(ys_in).long()),
                   hs=pm.encoder(t(x), t(xlen))[0])
    for k in ("hs", "ctc_out", "att_out"):
        assert got[k].dtype == torch.bfloat16 and want[k].dtype == jnp.bfloat16
        err = rel_max_err(got[k], want[k])
        print(f"{config} {k}: port vs lasr_tpu bf16 {err:.2e}; lasr_tpu "
              f"bf16 vs f32 {rel_max_err(want[k], ref32[k]):.2e}")
        assert err < FWD_TOL, k

    def jax_loss(out):
        return jax_losses.E2E_Loss(BF16["odim"], smoothing=0.1, rate=0.3)(
            out["att_out"], out["ctc_out"], jnp.asarray(att_label),
            jnp.asarray(ctc_label), out["hs_len"])
    lw, l32 = jax_loss(want), jax_loss(ref32)
    lp = E2E_Loss(BF16["odim"], smoothing=0.1, rate=0.3)(
        got["att_out"], got["ctc_out"], t(att_label), t(ctc_label),
        got["hs_len"])
    for name, g, w, r in zip(("main", "att", "ctc"), lp, lw, l32):
        assert g.dtype == torch.float32
        print(f"{config} loss {name}: port {float(g):.5f} lasr_tpu bf16 "
              f"{float(w):.5f} f32 {float(r):.5f}")
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_TOL)


def test_transformer_forward_matches_jax_bf16():
    kw = dict(OFFLINE)
    x, xlen, ys = bf16_batch(odim=kw["odim"], seed=2)
    ys_in, _, _ = _ragged_labels(ys)
    fm = jax_models.E2E_Transformer_CTC(**kw, dtype=jnp.bfloat16)
    v = numpy_tree(jax_models.E2E_Transformer_CTC(**kw).init(
        jax.random.PRNGKey(2), x, xlen, ys_in))
    pm = E2E_Transformer_CTC(**kw, dtype=torch.bfloat16, device="cpu")
    load_model_weights(pm, flax_to_state_dict(v))
    want = fm.apply(v, x, xlen, ys_in)
    with torch.no_grad():
        got = pm(t(x), t(xlen), t(ys_in).long())
    for k in ("ctc_out", "att_out"):
        assert got[k].dtype == torch.bfloat16
        assert rel_max_err(got[k], want[k]) < FWD_TOL, k


def test_bf16_state_dict_round_trips_through_the_jax_bridge():
    """f32 in and out whatever the compute dtype: the bf16 model's
    state_dict is the weights it was loaded from, and the JAX bf16 model
    runs on them."""
    _, fb, v, pm = _pair("B")
    assert all(x.dtype == torch.float32 for x in pm.state_dict().values()
               if x.is_floating_point())
    round_trip(v, pm)
    x, xlen, ys = bf16_batch()
    out = fb.apply(v, x, xlen, _ragged_labels(ys)[0])
    assert out["ctc_out"].dtype == jnp.bfloat16


# ---- one train step ----

def _wave_batch(seed=0):
    rng = np.random.default_rng(seed)
    n = np.asarray([19200, 15000, 12000], np.int32)   # 120 frames at most
    wav = (0.2 * rng.standard_normal((3, 19200))).astype(np.float32)
    wav *= np.arange(19200)[None, :] < n[:, None]
    return {"wav_array": wav, "wav_len": n,
            "token_id": rng.integers(3, BF16["odim"], (3, 8)).astype(
                np.int32),
            "token_len": np.asarray([8, 6, 7], np.int32)}


def _group(name):
    """The parameter group: the input layer, each block, the norms and
    heads."""
    p = name.split(".")
    return ".".join(p[:3] if p[1] in ("encoders", "decoders") else p[:2])


def _rel_l2_by_group(names, got, want):
    """{group: ||got - want|| / ||want||} over the named tensors."""
    num, den = collections.defaultdict(float), collections.defaultdict(float)
    for n in names:
        num[_group(n)] += float((got[n] - want[n]).double().norm() ** 2)
        den[_group(n)] += float(want[n].double().norm() ** 2)
    return {g: (num[g] / den[g]) ** 0.5 for g in num}


@pytest.mark.parametrize("config", list(TRAINED))
def test_one_train_step_matches_jax_trainer(config):
    kw = dict(BF16, **NODROP, **TRAINED[config])
    batch = _wave_batch()
    jt = JaxTrainer(jax_models.E2E_Conformer_CTC(**kw, dtype=jnp.bfloat16),
                    jax_losses.E2E_Loss(BF16["odim"], smoothing=0.1,
                                        rate=0.3),
                    JaxAdam(**ADAM).make(), JaxFrontend(CHAIN),
                    mesh=make_mesh(devices=jax.devices()[:1]), use_ema=True,
                    seed=0, log_interval=1)
    jstate = jt.init_state(batch)
    model = E2E_Conformer_CTC(**kw, dtype=torch.bfloat16, device="cpu")
    start = flax_state_dict(jstate.params, jstate.batch_stats)
    load_model_weights(model, start)
    pt = Trainer(model, E2E_Loss(BF16["odim"], smoothing=0.1, rate=0.3),
                 Adam(**ADAM), DeviceFrontend(CHAIN), use_ema=True, seed=0,
                 log_interval=1, device="cpu")

    _, grads = pt.loss_and_grads(batch, 0)
    load_model_weights(model, start)          # undo the BatchNorm update
    got = dict(zip(pt.names, grads))
    want = flax_state_dict(jax_grad(jt, jstate, batch))
    real = [n for n in pt.names if not n.endswith(NOISE_LEAVES)]
    largest = max(float(g.abs().max()) for g in grads)
    for n in set(pt.names) - set(real):
        assert float(got[n].abs().max()) < 1e-3 * largest, n
    errs = _rel_l2_by_group(real, got, want)
    print(config, "gradients", {g: round(e, 4) for g, e in errs.items()})
    assert len(errs) == 10 and max(errs.values()) < GRAD_TOL, errs

    jstate, jm = jt.train_step(jstate, batch)
    pstate, pm = pt.train_step(pt.init_state(), batch)
    for k in ("loss_main", "att_loss", "ctc_loss"):
        np.testing.assert_allclose(pm[k], float(jm[k]), rtol=LOSS_TOL,
                                   err_msg=k)
    new = flax_state_dict(jstate.params, jstate.batch_stats)
    errs = _rel_l2_by_group(real, model.state_dict(), new)
    print(config, "updated parameters", {g: f"{e:.1e}"
                                         for g, e in errs.items()})
    assert max(errs.values()) < GRAD_TOL, errs


# ---- the kernels' plain versions ----

def _bf16_pair(arrays):
    """(JAX arrays, torch tensors) of the same values, floats in bf16."""
    jx = [jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
          else jnp.asarray(a) for a in arrays]
    tx = [torch.from_numpy(f32(a)).to(torch.bfloat16)
          if a.dtype == jnp.bfloat16 else torch.from_numpy(np.asarray(a))
          for a in jx]
    return jx, tx


def _unrounded(fn, tx, *rest):
    """``fn`` on the same values in f32 (no bf16 rounding inside)."""
    return fn(*[a.float() if a.is_floating_point() else a for a in tx],
              *rest)


@pytest.mark.parametrize("seed,T", [(0, 70), (1, 33)])
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_plain_forward_matches_pallas_in_bf16(kernel, seed, T):
    if kernel == "K1":
        jx, tx = _bf16_pair(_rot_case(T=T, seed=seed))
        want, want_lse = _rot_attention_pallas(*jx, interpret=True)
        got, lse = rot_attention_reference(*tx)
        plain = _unrounded(rot_attention_reference, tx)[0]
    else:
        jx, tx = _bf16_pair(_rel_case(T=T, seed=seed))
        want, want_lse = _rel_attention_pallas(*jx, H=2, interpret=True)
        got, lse = rel_attention_reference(*tx)
        plain = _unrounded(rel_attention_reference, tx)[0]
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    err = float(np.abs(f32(got) - f32(want)).max())
    unrounded = float(np.abs(f32(plain.to(torch.bfloat16))
                             - f32(want)).max())
    print(f"{kernel} T={T}: {err:.2e} (without P's rounding {unrounded:.2e})")
    assert err < FWD_TOL and err <= unrounded
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)


@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_plain_backward_matches_pallas_in_bf16(kernel):
    which = "rot" if kernel == "K2" else "rel"
    xs, kv, dout = bwd_cases._inputs(which, [37, 23])
    jx, tx = _bf16_pair(list(xs) + [kv, dout])
    (jkv, jd), (tkv, td) = jx[5:], tx[5:]
    if which == "rot":
        out, lse = _rot_attention_pallas(*jx[:5], jkv, interpret=True)
        want = _rot_attention_pallas_bwd(*jx[:5], jkv, out, lse, jd,
                                         interpret=True)
        bwd = rot_attention_backward_reference
    else:
        out, lse = _rel_attention_pallas(*jx[:5], jkv, H=bwd_cases.H,
                                         interpret=True)
        want = _rel_attention_pallas_bwd(*jx[:5], jkv, out, lse, jd,
                                         H=bwd_cases.H, interpret=True)
        bwd = rel_attention_backward_reference
    tout = torch.from_numpy(f32(out)).to(torch.bfloat16)
    tlse = torch.from_numpy(np.asarray(lse))
    got = bwd(*tx[:5], tkv, tout, tlse, td)
    plain = _unrounded(bwd, tx[:5], tkv, tout.float(), tlse, td.float())
    assert len(got) == len(want)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == torch.bfloat16
        err = rel_max_err(g, w)
        unrounded = rel_max_err(p.to(torch.bfloat16), w)
        print(f"{kernel}: {err:.2e} (without dz's rounding {unrounded:.2e})")
        assert err < FWD_TOL and err <= unrounded


# ---- the beam search ----

# the search's score of a full hypothesis (ctc_weight w = 0.5, no length
# penalty): (1-w)·(attention log-probs of its tokens and eos, summed) +
# w·log P_ctc(tokens)
W = 0.5


def _score_port(pm, x, xlen, hyps, eos=2):
    with torch.no_grad():
        hs, hs_len = pm.encode(t(x), t(xlen), solo_pad=True)
        out = []
        for b, ids in hyps:
            ys = torch.tensor([[1] + ids])
            logp = torch.log_softmax(pm.decode_full(
                ys, hs[b:b + 1], hs_len[b:b + 1]).float(), dim=-1)[0]
            att = float(logp.gather(1, torch.tensor(ids + [eos])[:, None])
                        .sum())
            ctc = float(ctc_forward_from_logits(
                pm.ctc_logits(hs[b:b + 1]), hs_len[b:b + 1],
                torch.tensor([ids]), torch.tensor([len(ids)])))
            out.append((1 - W) * att + W * ctc)
    return out


def _score_jax(fm, v, x, xlen, hyps, eos=2):
    hs, hs_len = fm.apply(v, x, xlen, solo_pad=True, method=fm.encode)
    out = []
    for b, ids in hyps:
        ys = jnp.asarray([[1] + ids])
        logits = fm.apply(v, ys, hs[b:b + 1], hs_len[b:b + 1],
                          method=fm.decode_full)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)[0]
        att = float(jnp.take_along_axis(
            logp, jnp.asarray(ids + [eos])[:, None], axis=1).sum())
        ctc = float(jax_ctc(fm.apply(v, hs[b:b + 1], method=fm.ctc_logits),
                            hs_len[b:b + 1], jnp.asarray([ids]),
                            jnp.asarray([len(ids)]))[0])
        out.append((1 - W) * att + W * ctc)
    return out


@pytest.mark.parametrize("config", list(SERVED))
def test_beam_search_over_bf16_model(config, monkeypatch):
    _, fb, v, pm = _pair(config)
    x, xlen, _ = bf16_batch(seed=3)
    kw = dict(beam=4, ctc_beam=5, ctc_weight=W, nbest=1)
    want = JaxBeam(fb, v, **kw)(x, xlen)
    # the port search's candidate totals (B, K*C) at each token step
    totals, top_k = [], port_beam._top_k

    def record(x, k):
        if x.shape[-1] == kw["beam"] * kw["ctc_beam"]:
            totals.append(x.clone())
        return top_k(x, k)
    monkeypatch.setattr(port_beam, "_top_k", record)
    got = port_beam.CTCAttBeamDecoder(pm, device="cpu", **kw)(x, xlen)
    differ = [b for b in range(len(xlen))
              if got.best_ids(b) != want.best_ids(b)]
    print(f"{config}: rows whose best hypotheses differ: {differ}")
    for b in range(len(xlen)):
        if b not in differ:
            np.testing.assert_allclose(got.scores[b, 0], want.scores[b, 0],
                                       rtol=LOSS_TOL)
            continue
        hyps = [(b, want.best_ids(b)), (b, got.best_ids(b))]
        s_port = _score_port(pm, x, xlen, hyps)
        s_jax = _score_jax(fb, v, x, xlen, hyps)
        print(f"  row {b}: lasr_tpu's best {s_jax[0]:.3f} (port "
              f"{s_port[0]:.3f}), the port's best {s_jax[1]:.3f} (port "
              f"{s_port[1]:.3f}); searches {float(want.scores[b, 0]):.3f} "
              f"/ {float(got.scores[b, 0]):.3f}")
        # both packages score both hypotheses alike, each search's own
        # score is its hypothesis's: the difference is in the pruning,
        # where the beam's last kept and first dropped candidates came
        # within the bar of each other
        np.testing.assert_allclose(s_port, s_jax, rtol=FWD_TOL)
        np.testing.assert_allclose(
            [want.scores[b, 0], got.scores[b, 0]], [s_jax[0], s_port[1]],
            rtol=FWD_TOL)
        cut = [torch.sort(x[b], descending=True).values[kw["beam"] - 1:
                                                        kw["beam"] + 1]
               for x in totals]
        gap, step = min((float(c[0] - c[1]), i) for i, c in enumerate(cut)
                        if float(c[1]) > port_beam.LOG_ZERO / 2)
        print(f"  the port's narrowest cut: {gap:.4f} at token step "
              f"{step + 1} (kept {float(cut[step][0]):.3f})")
        assert gap < FWD_TOL * abs(float(cut[step][0]))


# ---- the train CLI with -fp16 16 ----

def _metrics(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_fp16_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """Both CLIs from lasr_tpu's initial weights (the JAX CLI's own init,
    loaded into the port's model before its Trainer starts), dropout 0,
    no SpecAugment, the recipe's optimizer, 2 epochs of 2 steps, B-train,
    on test_torch_port_cli.py's corpus."""
    corpus = dict(n16=8, n8=0, secs=(0.5, 0.9), n_words=(1, 3),
                  word_len=(1, 4))
    train = write_corpus(str(tmp_path / "train"), seed=11, **corpus)
    valid = write_corpus(str(tmp_path / "dev"), seed=12,
                         **dict(corpus, n16=3))
    model = dict(BF16, odim=0, **NODROP, **TRAINED["B-train"])
    config = write_config(str(tmp_path / "config.yaml"), train, valid, model,
                          chain=CHAIN)
    # the recipe's optimizer and schedule (Adam, Noam warmup of 25000
    # steps): a few steps of a real run
    with open(os.path.join(REPO, "example", "asr_en", "conf",
                           "config_baseline.yaml")) as f:
        recipe = yaml.safe_load(f)["opti_config"]
    with open(config) as f:
        conf = yaml.safe_load(f)
    conf["opti_config"] = recipe
    with open(config, "w") as f:
        yaml.safe_dump(conf, f, sort_keys=False)
    init = {}
    jax_init = JaxTrainer.init_state

    def keep_init(self, sample):
        state = jax_init(self, sample)
        init["sd"] = flax_state_dict(state.params, state.batch_stats)
        return state
    monkeypatch.setattr(JaxTrainer, "init_state", keep_init)
    port_init = Trainer.init_state

    def load_init(self):
        load_model_weights(self.model, init["sd"])
        return port_init(self)
    monkeypatch.setattr(Trainer, "init_state", load_init)

    flags = ["-config", config, "-num_epochs", "2", "-fp16", "16",
             "-ema", "1", "-log_interval", "1", "-num_workers", "1"]
    jexp, pexp = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _jax_cli("train").main(flags + ["-exp_dir", jexp,
                                           "-num_devices", "1",
                                           "-fast_rng", "0"]) == 0
    assert port_train.main(flags + ["-exp_dir", pexp, "-device",
                                    "cpu"]) == 0
    want, got = _metrics(jexp), _metrics(pexp)
    assert [(x["epoch"], x["step"]) for x in got] == \
        [(x["epoch"], x["step"]) for x in want] == \
        [(0, 1), (0, 2), (0, 2), (1, 3), (1, 4), (1, 4)]
    for w, g in zip(want, got):
        for k in ("loss_main", "att_loss", "ctc_loss", "valid_loss_main",
                  "valid_att_loss", "valid_ctc_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_TOL,
                                           err_msg=f"{k} step {w['step']}")
    ckpt = torch.load(os.path.join(
        pexp, "checkpoints", "last", sorted(os.listdir(os.path.join(
            pexp, "checkpoints", "last")))[-1]), weights_only=False)
    assert all(x.dtype == torch.float32 for x in ckpt["state_dict"].values()
               if x.is_floating_point())

    capsys.readouterr()
    cfg = write_decode_config(str(tmp_path / "decode.yaml"), valid,
                              "ctc_att", chain=CHAIN)
    hparams = os.path.join(pexp, "hparams.yaml")
    root = os.path.join(pexp, "checkpoints")
    ours, theirs = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    assert port_decode.main(["-train_config", hparams, "-decode_config", cfg,
                             "-model_path", root, "-choose", "last",
                             "-avg", "2", "-output_file", ours,
                             "-device", "cpu"]) == 0
    out_port = capsys.readouterr().out
    assert _jax_cli("decode").main([
        "-train_config", hparams, "-decode_config", cfg,
        "-model_path", os.path.join(root, "last"), "-choose", "last",
        "-avg", "2", "-output_file", theirs]) == 0
    out_jax = capsys.readouterr().out
    with open(ours) as f, open(theirs) as g:
        assert f.read() == g.read()
    assert _decode_lines(out_port) == _decode_lines(out_jax)


# ---- what still raises ----

@pytest.mark.parametrize("dtype", [None, "float32", "jnp.float32",
                                   torch.float32, jnp.float32, "bfloat16",
                                   "jnp.bfloat16", torch.bfloat16,
                                   jnp.bfloat16])
def test_dtype_names(dtype):
    want = torch.bfloat16 if "bfloat16" in str(dtype) else torch.float32
    assert check_dtype(dtype) == want


def test_what_still_raises():
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        E2E_Transformer_CTC_Online(**ONLINE, dtype=torch.float16,
                                   device="cpu")
    E2E_Transformer_CTC_Online(**ONLINE, dtype="float32", device="cpu")
    E2E_Transformer_CTC_Online(**ONLINE, dtype=torch.bfloat16, device="cpu")
    for dtype in (torch.float16, "float16", torch.float64, jnp.float16, 16):
        with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
            E2E_Conformer_CTC(**BF16, dtype=dtype, device="cpu")
