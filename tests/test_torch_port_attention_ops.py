"""Plain versions of the port's two attention kernels vs the JAX Pallas
kernels (interpret mode) and their XLA references: f32, ragged
kv_len >= 1, at the bar of tests/test_rot_attention.py (2e-5).  Also the
kv_len == 0 rule (zeros, lse = +inf) and the wrappers' device rule: CPU
tensors take the plain version, any other device a kernel or an error."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.ops.rel_attention import _rel_attention_pallas
from lasr_tpu.ops.rel_attention import _xla_reference as jax_rel_reference
from lasr_tpu.ops.rot_attention import _rot_attention_pallas
from lasr_tpu.ops.rot_attention import _xla_reference as jax_rot_reference
from lasr_tpu_torch.ops.rel_attention import (rel_attention_forward,
                                              rel_attention_reference)
from lasr_tpu_torch.ops.rot_attention import (rot_attention_forward,
                                              rot_attention_reference)

ATOL = 2e-5


def _rot_case(B=2, H=2, T=70, dk=40, M=64, seed=0):
    rng = np.random.default_rng(seed)
    BH = B * H
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    lens = rng.integers(1, T + 1, size=B)
    return (f(BH, T, dk), f(BH, T, M, sc=0.3), f(BH, T, dk), f(BH, T, dk),
            f(T, M, sc=0.3), np.repeat(lens, H).astype(np.int32))


def _rel_case(B=2, H=2, T=70, dk=40, seed=0):
    rng = np.random.default_rng(seed)
    BH = B * H
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lens = rng.integers(1, T + 1, size=B)
    return (f(BH, T, dk), f(BH, T, dk), f(BH, T, dk), f(BH, T, dk),
            f(H, 2 * T - 1, dk), np.repeat(lens, H).astype(np.int32))


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("seed,T", [(0, 70), (1, 33)])
def test_rot_plain_matches_pallas_and_xla(seed, T):
    args = _rot_case(T=T, seed=seed)
    out, lse = rot_attention_reference(*_torch(args))
    pal, pal_lse = _rot_attention_pallas(*map(jnp.asarray, args),
                                         interpret=True)
    xla = jax_rot_reference(*map(jnp.asarray, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(pal_lse), atol=ATOL)


@pytest.mark.parametrize("seed,T", [(0, 70), (1, 33)])
def test_rel_plain_matches_pallas_and_xla(seed, T):
    args = _rel_case(T=T, seed=seed)
    out, lse = rel_attention_reference(*_torch(args))
    pal, pal_lse = _rel_attention_pallas(*map(jnp.asarray, args), H=2,
                                         interpret=True)
    xla = jax_rel_reference(*map(jnp.asarray, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(pal), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(pal_lse), atol=ATOL)


@pytest.mark.parametrize("which", ["rot", "rel"])
def test_empty_rows_give_zeros(which):
    """kv_len == 0 (dummy batch-padding rows): zeros, lse = +inf; the other
    rows are unaffected."""
    case, ref = ((_rot_case, rot_attention_reference) if which == "rot"
                 else (_rel_case, rel_attention_reference))
    args = case(T=20, seed=5)
    out_full, _ = ref(*_torch(args))
    kv = args[-1].copy()
    kv[2:] = 0
    out, lse = ref(*_torch(args[:-1] + (kv,)))
    assert torch.all(out[2:] == 0)
    assert torch.all(torch.isinf(lse[2:])) and torch.all(lse[2:] > 0)
    np.testing.assert_array_equal(out[:2].numpy(), out_full[:2].numpy())


@pytest.mark.parametrize("which", ["rot", "rel"])
def test_wrapper_device_rule(which):
    fwd, ref, case = ((rot_attention_forward, rot_attention_reference,
                       _rot_case) if which == "rot" else
                      (rel_attention_forward, rel_attention_reference,
                       _rel_case))
    args = _torch(case(T=16, seed=3))
    before = fwd.launches
    out, lse = fwd(*args)
    want, want_lse = ref(*args)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert fwd.launches == before            # the plain version, no launch
    with pytest.raises(RuntimeError, match="no kernel"):
        fwd(*[a.to("meta") for a in args])
    with pytest.raises(TypeError):
        fwd(*[a.double() if a.is_floating_point() else a for a in args])
    with pytest.raises(ValueError):
        fwd(*args[:-1], args[-1].long())
