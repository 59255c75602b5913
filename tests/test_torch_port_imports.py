"""The port imports no JAX (nor flax, orbax, tensorstore or zstandard)
and nothing of lasr_tpu, and its entry points refuse to fall back to the CPU when no
GPU is present."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import lasr_tpu_torch
for m in pkgutil.walk_packages(lasr_tpu_torch.__path__, "lasr_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
top = ("jax", "flax", "orbax", "tensorstore", "zstandard", "lasr_tpu")
bad = [n for n in sys.modules
       if n in top or n.startswith(tuple(t + "." for t in top))]
# the codecs, which the reader imports lazily, are among those walked
bad += [n for n in ("lasr_tpu_torch.data.flac", "lasr_tpu_torch.data.mp3",
                    "lasr_tpu_torch.data._mp3tables")
        if n not in sys.modules]
print(len([n for n in sys.modules if n.startswith("lasr_tpu_torch")]), bad)
sys.exit(1 if bad else 0)
"""


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "flax", "orbax", "tensorstore", "zstandard",
                   "lasr_tpu")


def test_importing_every_port_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 20


def _port_sources():
    pkg = os.path.join(REPO, "lasr_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_names_jax_or_lasr_tpu_in_an_import():
    """Lazy imports inside functions count too; the module name must match
    exactly (lasr_tpu_torch is not lasr_tpu)."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            bad += [f"{path}:{node.lineno} {n}" for n in names
                    if _is_forbidden(n)]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["resolve_device", "model", "decoder",
                                   "asrprocess", "trainer", "train_cli",
                                   "decode_cli", "transformer_model",
                                   "online_model", "longform", "lm",
                                   "rnnlm"])
def test_entry_points_raise_without_cuda(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from lasr_tpu_torch import resolve_device
    from lasr_tpu_torch.decode.beam import CTCAttBeamDecoder
    from lasr_tpu_torch.models.e2e_ctc_att import (E2E_Conformer_CTC,
                                                   E2E_Transformer_CTC)
    from lasr_tpu_torch.models.e2e_online import E2E_Transformer_CTC_Online
    from lasr_tpu_torch.bin import decode, train
    from lasr_tpu_torch.decode.lm import build_lm
    from lasr_tpu_torch.decode.longform import LongFormCTCAttDecoder
    from lasr_tpu_torch.modules.rnn import RNNCellStack
    from lasr_tpu_torch.data.frontend import DeviceFrontend
    from lasr_tpu_torch.models.losses import E2E_Loss
    from lasr_tpu_torch.process.asrprocess import ASRProcess
    from lasr_tpu_torch.train.optimizer import Adam
    from lasr_tpu_torch.train.trainer import Trainer
    tiny = dict(idim=20, odim=9, encoder_attention_dim=16,
                encoder_attention_heads=2, encoder_linear_units=32,
                encoder_num_blocks=1, decoder_attention_dim=16,
                decoder_attention_heads=2, decoder_linear_units=32,
                decoder_num_block=1)
    calls = {
        "resolve_device": lambda: resolve_device(None),
        "model": lambda: E2E_Conformer_CTC(**tiny),
        "decoder": lambda: CTCAttBeamDecoder(
            E2E_Conformer_CTC(**tiny, device="cpu")),
        "asrprocess": lambda: ASRProcess(str(tmp_path / "h.yaml"),
                                         str(tmp_path / "d.yaml"),
                                         str(tmp_path / "m.pt")),
        "trainer": lambda: Trainer(E2E_Conformer_CTC(**tiny, device="cpu"),
                                   E2E_Loss(9), Adam(),
                                   DeviceFrontend(["fbank:20"])),
        "train_cli": lambda: train.main(["-config", str(tmp_path / "c.yaml"),
                                         "-exp_dir", str(tmp_path)]),
        "decode_cli": lambda: decode.main([
            "-model_path", str(tmp_path), "-train_config",
            str(tmp_path / "h.yaml"), "-decode_config",
            str(tmp_path / "d.yaml"), "-output_file",
            str(tmp_path / "o.txt")]),
        "transformer_model": lambda: E2E_Transformer_CTC(**tiny),
        "online_model": lambda: E2E_Transformer_CTC_Online(
            idim=20, odim=9, encoder_attention_dim=16,
            encoder_attention_heads=2, encoder_linear_units=32,
            encoder_num_blocks=1, decoder_attention_dim=16,
            decoder_self_attention_heads=2, decoder_src_attention_heads=2,
            decoder_linear_units=32, decoder_num_block=1),
        "longform": lambda: LongFormCTCAttDecoder(CTCAttBeamDecoder(
            E2E_Conformer_CTC(**tiny, device="cpu"), device="cpu")),
        "lm": lambda: build_lm({"lm_rate": 0.0}),
        "rnnlm": lambda: RNNCellStack(input_dim=9, output_dim=9, n_layers=1,
                                      n_units=8),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert resolve_device("cpu") == torch.device("cpu")


def test_registry_translates_both_name_families():
    from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
    from lasr_tpu_torch.utils.registry import dynamic_import, translate_name
    assert dynamic_import(
        "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC") is E2E_Conformer_CTC
    with pytest.warns(UserWarning, match="reference class"):
        assert dynamic_import(
            "lasr.model.e2e_ctc_att.e2e_conformer:E2E_Conformer_CTC"
        ) is E2E_Conformer_CTC
    assert translate_name("lasr_tpu_torch.data.tokenizer:CharTokenizer") \
        == "lasr_tpu_torch.data.tokenizer:CharTokenizer"
    assert translate_name("lasr_tpux.a:B") == "lasr_tpux.a:B"
