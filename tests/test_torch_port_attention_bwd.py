"""The plain backwards of the port's attention kernels against lasr_tpu's
Pallas backward kernels (interpret mode) and against jax.grad of the
blockless ``_xla_reference``s, f32, ragged kv_len >= 1, B=2, H=2; the
autograd Functions on the CPU against torch autograd through the plain
forwards; and the kv_len == 0 rule (exact zero gradients, no NaN).

Tolerance 2e-5 absolute: f32 summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.ops.rel_attention import (_rel_attention_pallas,
                                        _rel_attention_pallas_bwd)
from lasr_tpu.ops.rel_attention import _xla_reference as rel_xla
from lasr_tpu.ops.rot_attention import (_rot_attention_pallas,
                                        _rot_attention_pallas_bwd)
from lasr_tpu.ops.rot_attention import _xla_reference as rot_xla
from lasr_tpu_torch.ops.rel_attention import (
    rel_attention_backward, rel_attention_backward_reference,
    rel_attention_context, rel_attention_reference)
from lasr_tpu_torch.ops.rot_attention import (
    rot_attention_backward, rot_attention_backward_reference,
    rot_attention_context, rot_attention_reference)

ATOL = 2e-5
B, H, T, DK, M = 2, 2, 37, 8, 24


def _inputs(which, lens, seed=0):
    rng = np.random.default_rng(seed)

    def f(*s, sc=1.0):
        return (rng.standard_normal(s) * sc).astype(np.float32)
    BH = B * H
    kv = np.repeat(np.asarray(lens, np.int32), H)
    if which == "rot":
        xs = [f(BH, T, DK), f(BH, T, M, sc=0.3), f(BH, T, DK), f(BH, T, DK),
              f(T, M, sc=0.3)]
    else:
        xs = [f(BH, T, DK), f(BH, T, DK), f(BH, T, DK), f(BH, T, DK),
              f(H, 2 * T - 1, DK)]
    return xs, kv, f(BH, T, DK)


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _port_grads(which, xs, kv, dout):
    fwd = rot_attention_reference if which == "rot" else \
        rel_attention_reference
    bwd = rot_attention_backward if which == "rot" else \
        rel_attention_backward
    args = _t(xs) + [torch.from_numpy(kv)]
    out, lse = fwd(*args)
    return [g.numpy() for g in bwd(*args, out, lse, torch.from_numpy(dout))]


@pytest.mark.parametrize("which", ["rot", "rel"])
def test_plain_backward_matches_pallas_and_jax_grad(which):
    xs, kv, dout = _inputs(which, [37, 23])
    got = _port_grads(which, xs, kv, dout)
    jxs = [jnp.asarray(x) for x in xs]
    jkv = jnp.asarray(kv)
    if which == "rot":
        out, lse = _rot_attention_pallas(*jxs, jkv, interpret=True)
        pallas = _rot_attention_pallas_bwd(*jxs, jkv, out, lse,
                                           jnp.asarray(dout), interpret=True)
        _, vjp = jax.vjp(lambda a, b, c, d: rot_xla(a, b, c, d, jxs[4], jkv),
                         *jxs[:4])
    else:
        out, lse = _rel_attention_pallas(*jxs, jkv, H=H, interpret=True)
        pallas = _rel_attention_pallas_bwd(*jxs, jkv, out, lse,
                                           jnp.asarray(dout), H=H,
                                           interpret=True)
        _, vjp = jax.vjp(lambda a, b, c, d, e: rel_xla(a, b, c, d, e, jkv),
                         *jxs)
    autodiff = vjp(jnp.asarray(dout))
    assert len(got) == len(pallas) == len(autodiff)
    for g, p, a in zip(got, pallas, autodiff):
        np.testing.assert_allclose(g, np.asarray(p), atol=ATOL)
        np.testing.assert_allclose(g, np.asarray(a), atol=ATOL)
    if which == "rel":
        # dp sums both batch rows: one row alone gives another gradient
        xs1 = [x[:H] for x in xs[:4]] + [xs[4]]
        one = _port_grads(which, xs1, kv[:H], dout[:H])
        assert not np.allclose(one[4], got[4], atol=1e-3)


@pytest.mark.parametrize("which", ["rot", "rel"])
@pytest.mark.parametrize("lens", [[37, 23], [37, 0]])
def test_autograd_function_matches_autograd_through_plain_forward(which,
                                                                  lens):
    xs, kv, dout = _inputs(which, lens, seed=3)
    n_grad = 4 if which == "rot" else 5
    fn, fwd = ((rot_attention_context, rot_attention_reference)
               if which == "rot" else
               (rel_attention_context, rel_attention_reference))
    leaves = [x.requires_grad_(i < n_grad) for i, x in enumerate(_t(xs))]
    kv_t = torch.from_numpy(kv)
    g = torch.from_numpy(dout)
    got = torch.autograd.grad(fn(*leaves, kv_t), leaves[:n_grad], g)
    want = torch.autograd.grad(fwd(*leaves, kv_t)[0], leaves[:n_grad], g)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    if lens[-1] == 0:
        empty = torch.from_numpy(np.repeat(np.asarray(lens) == 0, H))
        for a in got[:4]:       # per-bh gradients of the empty row
            assert not bool(a[empty].any())


@pytest.mark.parametrize("which", ["rot", "rel"])
def test_backward_wrapper_checks_its_inputs(which):
    xs, kv, dout = _inputs(which, [37, 23])
    args = _t(xs) + [torch.from_numpy(kv)]
    fwd, bwd, ref = ((rot_attention_reference, rot_attention_backward,
                      rot_attention_backward_reference) if which == "rot" else
                     (rel_attention_reference, rel_attention_backward,
                      rel_attention_backward_reference))
    out, lse = fwd(*args)
    g = torch.from_numpy(dout)
    for a, b in zip(bwd(*args, out, lse, g), ref(*args, out, lse, g)):
        assert torch.equal(a, b)   # the CPU path is the plain version
    with pytest.raises(ValueError, match="lse"):
        bwd(*args, out, lse.double(), g)
    with pytest.raises(ValueError, match="shape"):
        bwd(*args, out[:, 1:], lse, g)
    with pytest.raises(ValueError, match="kv_len"):
        bwd(*args[:-1], args[-1].long(), out, lse, g)
