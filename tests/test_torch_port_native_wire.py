"""The port's native WAV/FLAC loader, int16 wire and device audio pool
against lasr_tpu on the CPU.

  - ``data.native_loader`` (``csrc/wavio.cc``, built with g++ into
    ``lasr_tpu_torch/_build/``): bit-equal to lasr_tpu's native loader and
    to both packages' Python readers on WAV mono / stereo and FLAC mono /
    stereo, ``wav_info`` included.  These tests skip only where ``g++``
    is missing.
  - ``BatchAudioDataSet``: native batches equal lasr_tpu's, in float32
    and in the int16 wire format, with a nonzero ``pad_audio`` too, and
    equal the port's own Python-reader batches; ``wav_rows`` / ``wav_S``
    equal lasr_tpu's; the two validation errors.
  - ``Trainer.fit`` of a 1-block model over a PCM16 corpus: int16 wire
    with the device audio pool gives the float32 run's losses, every
    epoch-2 batch gathered from the pool; a world size above 1 takes the
    wire path.
"""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from lasr_tpu.data import dataset as jax_dataset
from lasr_tpu.data import native_loader as jax_native
from lasr_tpu.data import reader as jax_reader
from lasr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from lasr_tpu_torch.data import dataset, native_loader, reader
from lasr_tpu_torch.data.flac import write_flac
from lasr_tpu_torch.data.frontend import DeviceFrontend
from lasr_tpu_torch.data.tokenizer import CharTokenizer
from lasr_tpu_torch.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.models.losses import E2E_Loss
from lasr_tpu_torch.train import trainer as trainer_mod
from lasr_tpu_torch.train.optimizer import Adam
from tests.test_torch_port_cli import LETTERS, write_corpus
from tests.torch_port_common import TINY


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native loader cannot build here")


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    """{kind: (path, float wave (N,) or (N, C), rate)} of seeded files."""
    root = tmp_path_factory.mktemp("native_wire")
    rng = np.random.default_rng(0)
    out = {}
    for kind, n, ch, rate in (("wav_mono", 4321, 1, 16000),
                              ("wav_stereo", 1500, 2, 8000),
                              ("flac_mono", 5000, 1, 16000),
                              ("flac_stereo", 3001, 2, 22050)):
        w = rng.uniform(-0.9, 0.9, (n, ch) if ch > 1 else n)
        path = str(root / (kind + (".wav" if kind.startswith("wav")
                                   else ".flac")))
        if kind.startswith("wav"):
            reader.write_wav(path, w, rate)
        else:
            write_flac(path, w, rate)
        out[kind] = (path, w, rate)
    return out


def test_native_loader_builds_into_the_port_build_dir():
    _need_gxx()
    assert native_loader.available()
    lib = native_loader._LIB_PATH
    assert lib.parent.name == "_build" and lib.parent.parent.name == \
        "lasr_tpu_torch" and lib.exists()
    assert lib.stat().st_mtime >= native_loader._SRC.stat().st_mtime


@pytest.mark.parametrize("kind", ["wav_mono", "wav_stereo", "flac_mono",
                                  "flac_stereo"])
def test_native_read_equals_lasr_tpu_and_python_readers(audio, kind):
    _need_gxx()
    path, w, rate = audio[kind]
    ch = 1 if w.ndim == 1 else w.shape[1]
    assert native_loader.wav_info(path) == jax_native.wav_info(path) == \
        (len(w), rate, ch)
    got, sr = native_loader.read_wav_mono(path)
    want, jsr = jax_native.read_wav_mono(path)
    py, py_sr = reader.read_audio(path)
    jpy, _ = jax_reader.read_audio(path)
    assert sr == jsr == py_sr == rate
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, reader.average_channels(py)
                                  .astype(np.float32))
    np.testing.assert_array_equal(got, jax_reader.average_channels(jpy)
                                  .astype(np.float32))


def test_native_batch_equals_lasr_tpu(audio):
    _need_gxx()
    paths = [audio[k][0] for k in sorted(audio)]
    got = native_loader.read_batch(paths, 6000, n_threads=3)
    want = jax_native.read_batch(paths, 6000, n_threads=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(got[0][i, : got[1][i]],
                                      native_loader.read_wav_mono(p)[0])
        assert not got[0][i, got[1][i]:].any()


def _scp(root, audio, kinds):
    scp, txt = os.path.join(root, "wav.scp"), os.path.join(root, "text")
    with open(scp, "w") as s, open(txt, "w") as t:
        for i, k in enumerate(kinds):
            s.write(f"u{i} {audio[k][0]}\n")
            t.write(f"u{i} {LETTERS[i % len(LETTERS)] * 3}\n")
    dict_path = os.path.join(root, "dict.txt")
    with open(dict_path, "w") as f:
        f.write("\n".join(LETTERS) + "\n")
    return scp, txt, dict_path


def _pair_datasets(corpus, **kw):
    scp, txt, dict_path = corpus
    out = []
    for cls, tok in ((dataset.BatchAudioDataSet, CharTokenizer),
                     (jax_dataset.BatchAudioDataSet, JaxCharTokenizer)):
        ds = cls(wav_list=[scp], text_list=[txt], tokenizer=tok(dict_path),
                 batch_type="size", batch_size=3, min_duration=0.0,
                 text_freq=0.0, **kw)
        ds.load_check_data()
        out.append(ds)
    return out


def _batches(ds):
    return [ds.merge_batch([ds.train_set[i] for i in g])
            for g in ds.batch_indices()]


WIRES = {"float32": {}, "int16": dict(wire_dtype="int16"),
         "int16_pad": dict(wire_dtype="int16", pad_audio=0.25),
         "float32_pad": dict(pad_audio=-0.5),
         "pool": dict(wire_dtype="int16", device_audio_cache=True,
                      cache_audio_mb=1)}


@pytest.mark.parametrize("wire", list(WIRES))
def test_dataset_batches_equal_lasr_tpu(audio, tmp_path, monkeypatch, wire):
    _need_gxx()
    kinds = ["wav_mono", "flac_mono", "wav_stereo", "flac_stereo",
             "wav_mono"]
    corpus = _scp(str(tmp_path), audio, kinds)
    calls = []
    read_batch = native_loader.read_batch
    monkeypatch.setattr(native_loader, "read_batch",
                        lambda *a, **k: calls.append(a[0]) or
                        read_batch(*a, **k))
    port, jax_ds = _pair_datasets(corpus, **WIRES[wire])
    got, want = _batches(port), _batches(jax_ds)
    assert len(calls) == len(got) == 2     # every batch decoded natively
    dtype = np.int16 if "int16" in str(WIRES[wire]) else np.float32
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["wav_array"].dtype == w["wav_array"].dtype == dtype
        for k in ("wav_array", "wav_len", "token_id", "token_len"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        if wire == "pool":
            np.testing.assert_array_equal(g["wav_rows"], w["wav_rows"])
            assert g["wav_S"] == w["wav_S"] == g["wav_array"].shape[1]
    if wire == "pool":
        assert port.max_bucketed_samples() == jax_ds.max_bucketed_samples()
        assert all(v.dtype == np.int16 for v in port._wav_cache.values())
        # a padded batch: its pad rows point at the sentinel row n
        rows = port.merge_batch([port.train_set[0]],
                                pad_to=(3, 16000, 8))["wav_rows"]
        assert rows.tolist() == [port.train_set[0]["row"], 5, 5]
    # the Python readers give the same batches
    monkeypatch.setattr(native_loader, "available", lambda: False)
    python = _batches(_pair_datasets(corpus, **WIRES[wire])[0])
    for g, p in zip(got, python):
        np.testing.assert_array_equal(g["wav_array"], p["wav_array"])


@pytest.mark.parametrize("bad,match", [
    (dict(audio_trans=["soxspeed", "fbank:80"]), "soxspeed"),
    (dict(pad_audio=0.1), "pad_audio=0")])
def test_pool_validation_errors_equal_lasr_tpu(bad, match):
    errors = []
    for cls in (dataset.AudioDataSet, jax_dataset.AudioDataSet):
        with pytest.raises(ValueError, match=match) as e:
            cls(device_audio_cache=True, **bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---- the Trainer: int16 wire + device audio pool ----

ONE_BLOCK = dict(TINY, odim=len(LETTERS) + 6 + 1, encoder_num_blocks=1,
                 decoder_num_block=1)
CHAIN = ["norm", "fbank:20"]


@pytest.fixture(scope="module")
def pcm16_corpus(tmp_path_factory):
    # 16 kHz PCM16 WAVs only: int16 quantization is then lossless
    return write_corpus(str(tmp_path_factory.mktemp("pcm16")), n16=6, n8=0,
                        seed=5, secs=(0.55, 0.95), n_words=(1, 3),
                        word_len=(1, 4))


def _fit(corpus, exp_dir, world=1, **data_kw):
    scp, txt, dict_path = corpus
    ds = dataset.BatchAudioDataSet(
        wav_list=[scp], text_list=[txt], tokenizer=CharTokenizer(dict_path),
        audio_trans=CHAIN, batch_type="size", batch_size=3,
        min_duration=0.0, text_freq=0.0, **data_kw)
    ds.load_check_data()
    torch.manual_seed(0)
    model = E2E_Conformer_CTC(**ONE_BLOCK, device="cpu")
    trainer = trainer_mod.Trainer(
        model, E2E_Loss(ONE_BLOCK["odim"], smoothing=0.1, rate=0.3),
        Adam(lr=1e-3), DeviceFrontend(CHAIN), exp_dir=str(exp_dir),
        seed=0, log_interval=1, device="cpu")
    trainer._tb = False
    trainer.world = world
    trainer.fit(trainer.init_state(), ds, num_epochs=2, num_workers=2,
                save_checkpoints=False)
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fit_int16_pool_equals_float32_wire(pcm16_corpus, tmp_path,
                                            monkeypatch):
    resolved = []
    resolve = trainer_mod._DeviceAudioPool.resolve

    def spy(pool, batch):
        resolved.append("wav_array" not in batch)
        out = resolve(pool, batch)
        assert out["wav_array"].dtype == torch.int16 == pool.pool.dtype
        return out
    monkeypatch.setattr(trainer_mod._DeviceAudioPool, "resolve", spy)
    want = _fit(pcm16_corpus, tmp_path / "f32")
    got = _fit(pcm16_corpus, tmp_path / "pool", wire_dtype="int16",
               device_audio_cache=True)
    # epoch 1 carries and scatters its waves, epoch 2 gathers them all
    assert resolved == [False, False, True, True]
    assert [(x["epoch"], x["step"]) for x in got] == \
        [(x["epoch"], x["step"]) for x in want] == \
        [(0, 1), (0, 2), (1, 3), (1, 4)]
    for g, w in zip(got, want):
        for k in ("loss_main", "att_loss", "ctc_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} at step {w['step']}")


def test_fit_above_one_rank_takes_the_wire_path(pcm16_corpus, tmp_path,
                                                monkeypatch, caplog):
    def refuse(*a, **k):
        raise AssertionError("the pool was built")
    monkeypatch.setattr(trainer_mod, "_DeviceAudioPool", refuse)
    with caplog.at_level(logging.WARNING):
        lines = _fit(pcm16_corpus, tmp_path / "wire", world=2,
                     wire_dtype="int16", device_audio_cache=True)
    assert "falling back to the wire path" in caplog.text
    assert len(lines) == 4 and all(np.isfinite(x["loss_main"])
                                   for x in lines)
