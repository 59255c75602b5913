"""Port frontend (peak norm + Kaldi log-mel fbank) vs lasr_tpu on ragged
seeded waves, at the Kaldi parity bar of lasr_tpu/ops/fbank.py (1e-3
max-abs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lasr_tpu.data.frontend import DeviceFrontend as JaxFrontend
from lasr_tpu.ops.fbank import log_mel_fbank as jax_fbank
from lasr_tpu.ops.fbank import peak_normalize as jax_norm
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.ops.fbank import (KaldiFbankConfig, fbank_num_frames,
                                      log_mel_fbank, peak_normalize)

TOL = 1e-3


def _waves(seed, B=3, S=8000):
    rng = np.random.default_rng(seed)
    wav = (0.3 * rng.standard_normal((B, S))).astype(np.float32)
    lens = np.asarray([S] + list(rng.integers(400, S, B - 1)), np.int32)
    for b, n in enumerate(lens):
        wav[b, n:] = 0.0
    return wav, lens


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bins", [80, 40])
def test_norm_fbank_matches_jax(seed, bins):
    wav, lens = _waves(seed)
    cfg = KaldiFbankConfig(num_mel_bins=bins)
    from lasr_tpu.ops.fbank import KaldiFbankConfig as JaxCfg
    want, want_len = jax_fbank(jax_norm(jnp.asarray(wav)), jnp.asarray(lens),
                               JaxCfg(num_mel_bins=bins))
    got, got_len = log_mel_fbank(peak_normalize(torch.from_numpy(wav)),
                                 torch.from_numpy(lens), cfg)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_device_frontend_matches_jax():
    wav, lens = _waves(2)
    chain = ["norm", "fbank:80", "specaug"]
    want, want_len = JaxFrontend(chain)(jnp.asarray(wav), jnp.asarray(lens))
    got, got_len = DeviceFrontend(chain)(torch.from_numpy(wav),
                                         torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # train mode: SpecAugment draws from the caller's generator only
    with pytest.raises(ValueError, match="generator"):
        DeviceFrontend(chain)(torch.from_numpy(wav), torch.from_numpy(lens),
                              train=True)
    aug, aug_len = DeviceFrontend(chain)(
        torch.from_numpy(wav), torch.from_numpy(lens),
        generator=torch.Generator().manual_seed(0), train=True)
    assert torch.equal(aug_len, got_len) and aug.shape == got.shape
    assert bool(torch.isfinite(aug).all()) and not torch.equal(aug, got)


def test_frame_count_and_int16_wire_format():
    assert fbank_num_frames(399) == 0 and fbank_num_frames(400) == 1
    assert fbank_num_frames(16000) == 98
    lens = torch.tensor([399, 400, 16000])
    assert fbank_num_frames(lens).tolist() == [0, 1, 98]
    wav, lens = _waves(3, B=2)
    pcm = np.round(wav * 32767).astype(np.int16)
    fe = DeviceFrontend(["norm", "fbank:80"])
    a, _ = fe(torch.from_numpy(pcm), torch.from_numpy(lens))
    b, _ = fe(torch.from_numpy(pcm.astype(np.float32) / 32768.0),
              torch.from_numpy(lens))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
