"""bf16 compute of the streaming model (``E2E_Transformer_CTC_Online(dtype=
torch.bfloat16)``, as ``tools/bench_streaming.py`` builds lasr_tpu's)
against lasr_tpu's ``dtype=jnp.bfloat16`` on the CPU, on identical
weights (lasr_tpu's init, bridged) at test_streaming.py's widths:

  - the dtype map: every submodule's output dtype, matched by name through
    the weight bridge, equals Flax's (``capture_intermediates``);
  - the forward (encoder output, CTC and decoder logits) within 2e-2 of
    each tensor's largest magnitude, the loss within 1e-2 relative
    (lasr_tpu's own bf16-vs-f32 distance printed beside);
  - the port's ``encode_chunk`` sequence against its own batch forward in
    bf16, within 2e-2 of the largest magnitude; memories and caches stay
    bf16;
  - the online beam search (``ctc_att_online``) over the bf16 model:
    token-exact against lasr_tpu's with search scores within 2e-2
    relative, or, where the best hypotheses differ, the tie rule of
    ``test_torch_port_bf16.py``'s beam test (both packages score both
    hypotheses alike within 2e-2, and the port's beam cut two candidates
    that close);
  - the monotonic attention's mask fills in bf16: masked decode scores at
    ``torch.finfo(bfloat16).min``, lasr_tpu's ``_mask_min``, and masked
    keys' weights exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lasr_tpu.models.losses as jax_losses
from lasr_tpu.decode.beam import CTCAttBeamDecoder as JaxBeam
from lasr_tpu.models.e2e_online import E2E_Transformer_CTC_Online as JaxOnline
from lasr_tpu.modules.attention import MTMultiHeadedAttention as JaxMT
from lasr_tpu.modules.attention import _mask_min
from lasr_tpu.ops.ctc import ctc_forward_from_logits as jax_ctc
from lasr_tpu_torch.decode import beam as port_beam
from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.modules.attention import MTMultiHeadedAttention
from lasr_tpu_torch.modules.layers import Computes, set_compute_dtype
from lasr_tpu_torch.modules.streaming import _chunk_grid
from lasr_tpu_torch.ops.ctc import ctc_forward_from_logits
from lasr_tpu_torch.utils.weights import flax_to_state_dict, load_model_weights
from tests.test_torch_port_bf16 import _flax_dtype_map, _port_dtype_map
from tests.torch_port_common import (ONLINE, batch, f32, labels, numpy_tree,
                                     rel_max_err, t)

FWD_TOL = 2e-2       # of each tensor's largest magnitude
LOSS_TOL = 1e-2      # relative


def bf16_online(kw=ONLINE, seed=0, src_bias=0.0, sharpen=1.0):
    """(flax f32 model, flax bf16 model, numpy variables, the port's bf16
    model on the CPU with the same weights); ``src_bias`` sets every
    ``src_att_bias``, ``sharpen`` scales the CTC head and the decoder's
    output layer."""
    x, xlen, ys = batch(odim=kw["odim"], seed=seed)
    v = numpy_tree(JaxOnline(**kw).init(jax.random.PRNGKey(seed), x, xlen,
                                        np.maximum(ys, 1)))

    def set_leaf(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['src_att_bias']"):
            return np.full_like(a, src_bias)
        if "['ctc']" in key or "['output_layer']" in key:
            return a * sharpen
        return a
    v = {"params": jax.tree_util.tree_map_with_path(set_leaf, v["params"])}
    pm = E2E_Transformer_CTC_Online(**kw, dtype=torch.bfloat16, device="cpu")
    load_model_weights(pm, flax_to_state_dict(v))
    return (JaxOnline(**kw), JaxOnline(**kw, dtype=jnp.bfloat16), v, pm)


def test_dtype_map_equals_flax():
    _, fb, v, pm = bf16_online()
    x, xlen, ys = batch(seed=1)
    ys_in, _, _ = labels(ys)
    got = _port_dtype_map(pm, x, xlen, ys_in)
    want = _flax_dtype_map(fb, v, x, xlen, ys_in)
    matched = sorted(set(got) & set(want))
    for name in matched:
        assert got[name] == want[name], name
    casting = {n for n, m in pm.named_modules()
               if isinstance(m, Computes) and n in got}
    assert casting <= set(matched), casting - set(matched)
    assert {"", "encoder", "decoder", "ctc", "encoder.after_norm",
            "encoder.encoders.1.norm1", "decoder.decoders.1",
            "decoder.decoders.1.src_attn", "decoder.output_layer",
            "encoder.embed.pos_enc"} <= set(matched)
    assert len(matched) >= 60
    assert got["encoder"] == ["bfloat16", "int32"]
    assert got[""] == ["bfloat16", "bfloat16", "int32"]


def test_forward_matches_jax_bf16():
    f32m, fb, v, pm = bf16_online(seed=2, src_bias=0.3)
    x, xlen, ys = batch(seed=12)
    ys_in, att_label, ctc_label = labels(ys)

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
        print(f"{k}: port vs lasr_tpu bf16 {err:.2e}; lasr_tpu bf16 vs f32 "
              f"{rel_max_err(want[k], ref32[k]):.2e}")
        assert err < FWD_TOL, k
    V = ONLINE["odim"]
    lw = jax_losses.E2E_Loss(V, smoothing=0.1, rate=0.3)(
        want["att_out"], want["ctc_out"], jnp.asarray(att_label),
        jnp.asarray(ctc_label), want["hs_len"])
    lp = E2E_Loss(V, smoothing=0.1, rate=0.3)(
        got["att_out"], got["ctc_out"], t(att_label), t(ctc_label),
        got["hs_len"])
    for g, w in zip(lp, lw):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_TOL)


def test_encode_chunk_sequence_equals_batch_forward_bf16():
    _, _, _, pm = bf16_online(seed=5)
    enc = pm.encoder
    x, _, _ = batch(B=2, T=128, seed=6)
    xlen = torch.tensor([128, 93])
    with torch.no_grad():
        full, full_len = enc(t(x), xlen)
        x_pad = torch.nn.functional.pad(t(x), (0, 0, 0, 16 + 6 + 16))
        mems = enc.init_stream_state(2)
        assert all(m.dtype == torch.bfloat16 for m in mems)
        outs = []
        for c in range(_chunk_grid(128, 16, 16, 16)):
            out, mems = enc.encode_chunk(x_pad[:, c * 16: c * 16 + 38], c,
                                         mems, xlen)
            outs.append(out)
    assert all(m.dtype == torch.bfloat16 for m in mems)
    inc = torch.cat(outs, dim=1)
    assert inc.dtype == full.dtype == torch.bfloat16
    for b in range(2):
        m = int(full_len[b])
        err = rel_max_err(inc[b, :m], full[b, :m])
        print(f"row {b}: encode_chunk vs batch {err:.2e}")
        assert err < FWD_TOL
    cache = pm.decoder_init_cache(2, 4)
    assert cache["k"].dtype == cache["v"].dtype == torch.bfloat16


# the online search's settings, and the solo score of a hypothesis:
# (1-w)·(the online decoder step's log-probs of its tokens and eos, the
# hypothesis alone, endpoints advancing per head) + w·log P_ctc(tokens)
BEAM = dict(beam=3, ctc_beam=5, ctc_weight=0.4, nbest=1)


def _solo_score_port(pm, hs, hs_len, b, ids, eos=2):
    w = BEAM["ctc_weight"]
    with torch.no_grad():
        mem = hs[b:b + 1, : int(hs_len[b])]
        cache = pm.decoder_init_cache(1, len(ids) + 2)
        att = 0.0
        for pos, (y, nxt) in enumerate(zip([1] + ids, ids + [eos])):
            logp, cache = pm.decoder_step_online(torch.tensor([y]), pos,
                                                 cache, mem)
            att += float(logp[0, nxt].float())
        ctc = float(ctc_forward_from_logits(
            pm.ctc_logits(hs[b:b + 1]), hs_len[b:b + 1],
            torch.tensor([ids]), torch.tensor([len(ids)])))
    return (1 - w) * att + w * ctc


def _solo_score_jax(fb, v, hs, hs_len, b, ids, eos=2):
    w = BEAM["ctc_weight"]
    mem = hs[b:b + 1, : int(hs_len[b])]
    cache = fb.apply(v, 1, len(ids) + 2, method=fb.decoder_init_cache)
    att = 0.0
    for pos, (y, nxt) in enumerate(zip([1] + ids, ids + [eos])):
        logp, cache = fb.apply(v, jnp.asarray([y]), pos, cache, mem,
                               method=fb.decoder_step_online)
        att += float(logp[0, nxt].astype(jnp.float32))
    ctc = float(jax_ctc(fb.apply(v, hs[b:b + 1], method=fb.ctc_logits),
                        hs_len[b:b + 1], jnp.asarray([ids]),
                        jnp.asarray([len(ids)]))[0])
    return (1 - w) * att + w * ctc


@pytest.mark.parametrize("seed", [2, 3])
def test_online_beam_over_bf16_model(seed, monkeypatch):
    """Token-exact, or (``test_torch_port_bf16.py``'s rule) where the best
    hypotheses differ: a tie.  Both packages give both hypotheses the
    same solo score within 2e-2 relative, and at some token step the
    port's beam cut between two candidates that close (the pruning took
    another path; the models score alike).  The CTC head and the output
    layer are sharpened 4x, so that the random model's search is
    decisive."""
    kw = dict(ONLINE, encoder_num_blocks=1, decoder_num_block=1)
    _, fb, v, pm = bf16_online(kw, seed=seed, src_bias=0.2, sharpen=4.0)
    rng = np.random.default_rng(20 + seed)
    x = rng.standard_normal((3, 120, 80)).astype(np.float32)
    xlen = np.asarray([120, 80, 97], np.int32)
    want = JaxBeam(fb, v, online=True, **BEAM)(x, xlen)
    totals, top_k = [], port_beam._top_k

    def record(a, k):
        if a.shape[-1] == BEAM["beam"] * BEAM["ctc_beam"]:
            totals.append(a.clone())
        return top_k(a, k)
    monkeypatch.setattr(port_beam, "_top_k", record)
    dec = CTCAttBeamDecoder(pm, online=True, device="cpu", **BEAM)
    got = dec(x, xlen)
    differ = [b for b in range(3) if got.best_ids(b) != want.best_ids(b)]
    print(f"seed {seed}: rows whose best hypotheses differ: {differ}")
    for b in range(3):
        assert len(got.best_ids(b)) > 0
        if b not in differ:
            np.testing.assert_allclose(got.scores[b, 0], want.scores[b, 0],
                                       rtol=FWD_TOL)
            continue
        with torch.no_grad():
            hs, hs_len, _ = dec.encode(t(x), t(xlen))
        jhs, jhs_len = fb.apply(v, x, xlen, ref_tail=True,
                                method=fb.encode_online)
        hyps = (want.best_ids(b), got.best_ids(b))
        s_port = [_solo_score_port(pm, hs, hs_len, b, h) for h in hyps]
        s_jax = [_solo_score_jax(fb, v, jhs, jhs_len, b, h) for h in hyps]
        print(f"  row {b}: solo scores of lasr_tpu's best {s_jax[0]:.3f} "
              f"(port {s_port[0]:.3f}), of the port's best {s_jax[1]:.3f} "
              f"(port {s_port[1]:.3f}); searches {want.scores[b, 0]:.3f} / "
              f"{got.scores[b, 0]:.3f}")
        np.testing.assert_allclose(s_port, s_jax, rtol=FWD_TOL)
        cut = [torch.sort(a[b], descending=True).values[BEAM["beam"] - 1:
                                                        BEAM["beam"] + 1]
               for a in totals]
        gap, step = min((float(c[0] - c[1]), i) for i, c in enumerate(cut)
                        if float(c[1]) > port_beam.LOG_ZERO / 2)
        print(f"  the port's narrowest cut: {gap:.4f} at token step "
              f"{step + 1} (kept {float(cut[step][0]):.3f})")
        assert gap < FWD_TOL * abs(float(cut[step][0]))


def test_monotonic_mask_fills_in_bf16():
    rng = np.random.default_rng(3)
    B, T1, T2, D, H = 2, 4, 9, 16, 2
    q = rng.standard_normal((B, T1, D)).astype(np.float32)
    k = rng.standard_normal((B, T2, D)).astype(np.float32)
    mask = np.ones((B, T2), bool)
    mask[1, 5:] = False
    jm = JaxMT(H, D, bias_init=0.1, dtype=jnp.bfloat16)
    v = numpy_tree(jm.init(jax.random.PRNGKey(0), q, k, k))
    pm = MTMultiHeadedAttention(H, D, bias_init=0.1)
    params = v["params"]
    sd = {"src_att_bias": t(params["src_att_bias"])}
    for n in ("linear_q", "linear_k", "linear_v", "linear_out"):
        sd[f"{n}.weight"] = t(params[n]["kernel"].T.copy())
        sd[f"{n}.bias"] = t(params[n]["bias"])
    pm.load_state_dict(sd)
    set_compute_dtype(pm, torch.bfloat16)
    pm.eval()

    def jproj(m, a, b):
        qq = m.project_q(a)
        kk, _ = m.project_kv(b, b)
        return m.decode_scores(qq[:, :1], kk, mask=jnp.asarray(mask))
    want = jm.apply(v, q, k, method=jproj)
    with torch.no_grad():
        qq = pm.project_q(t(q))
        kk, _ = pm.project_kv(t(k), t(k))
        got = pm.decode_scores(qq[:, :1], kk, mask=t(mask))
    fill = torch.finfo(torch.bfloat16).min
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert fill == _mask_min(jnp.bfloat16)
    assert (got[1, :, 5:] == fill).all()
    np.testing.assert_array_equal(f32(got)[1, :, 5:], f32(want)[1, :, 5:])
    assert rel_max_err(got[:, :, :5], want[:, :, :5]) < FWD_TOL
    # the full forward's weights: 0 on masked keys, bf16 throughout
    with torch.no_grad():
        out, attn = pm(t(q), t(k), t(k), t(mask[:, None, :]),
                       return_attn=True)
    want_out, want_attn = jm.apply(v, q, k, k, jnp.asarray(mask[:, None, :]),
                                   return_attn=True)
    assert out.dtype == attn.dtype == torch.bfloat16
    assert not f32(attn)[1, :, :, 5:].any()
    assert rel_max_err(attn, want_attn) < FWD_TOL
    assert rel_max_err(out, want_out) < FWD_TOL
