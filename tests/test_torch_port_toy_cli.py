"""The toy recipe's ``config.yaml`` (``E2E_Transformer_CTC``) through the
port's train CLI against ``bin/train.py``, in f32 and with ``-fp16 16``,
and the port's checkpoints through both decode CLIs with ``ctc_att``
(``tests/torch_port_toy.py`` says what is held and how closely)."""

import pytest

from tests.torch_port_toy import train_and_decode


@pytest.mark.parametrize("fp16", [32, 16])
def test_toy_config_trains_and_decodes_alike(fp16, tmp_path, monkeypatch,
                                             capsys):
    train_and_decode(tmp_path, monkeypatch, capsys, "config", fp16,
                     "ctc_att")
