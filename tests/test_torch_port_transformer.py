"""The port's offline ``E2E_Transformer_CTC`` against lasr_tpu on
identical weights (carried across by the weight bridge) and seeded ragged
inputs: the encoder output with and without ``solo_pad``, the eval
forward and E2E_Loss within 2e-4, for the conv2d and linear input
layers; and its state_dict round-tripping through
``torch_compat.torch_to_flax``."""

import numpy as np
import pytest
import torch

import lasr_tpu.models.e2e_ctc_att as jax_ctc_att
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Transformer_CTC
from tests.torch_port_common import (OFFLINE, TOL, batch,
                                     check_forward_and_loss, pair,
                                     round_trip, t)


@pytest.mark.parametrize("input_layer", ["conv2d", "linear"])
def test_transformer_ctc_forward_and_loss(input_layer):
    kw = dict(OFFLINE, encoder_input_layer=input_layer)
    fm, v, pm = pair(jax_ctc_att.E2E_Transformer_CTC, E2E_Transformer_CTC,
                     kw, seed=1)
    x, xlen, _ = batch(seed=3)
    for solo in (False, True):
        hs, hs_len = fm.apply(v, x, xlen, solo_pad=solo, method=fm.encode)
        with torch.no_grad():
            phs, phs_len = pm.encode(t(x), t(xlen), solo_pad=solo)
        np.testing.assert_allclose(phs.numpy(), np.asarray(hs), atol=TOL)
        np.testing.assert_array_equal(phs_len.numpy(), np.asarray(hs_len))
    check_forward_and_loss(fm, v, pm, seed=1)


@pytest.mark.parametrize("input_layer", ["conv2d", "linear"])
def test_state_dict_round_trips_through_torch_compat(input_layer):
    _, v, pm = pair(jax_ctc_att.E2E_Transformer_CTC, E2E_Transformer_CTC,
                    dict(OFFLINE, encoder_input_layer=input_layer), seed=11)
    round_trip(v, pm)
