"""The port's FLAC and mp3 codecs and the reader's dispatch against
``lasr_tpu``'s:

  - FLAC written by ``lasr_tpu``'s ``write_flac`` (mono with FIXED
    subframes and with LPC orders 2 and 4, stereo, 16 and 24 bits): both
    readers give bit-equal samples, and the port's ``write_flac`` writes
    byte-identical files;
  - mp3 streams from ``tests/mp3_craft.py`` (MPEG-1 and LSF intensity
    stereo) decoded bit-equal by both, an ID3v2 tag skipped, garbage
    raising ``Mp3Error``;
  - ``read_audio`` and every ``get_audio_*`` probe equal for wav, flac
    and mp3 files, and an unknown extension raising ``ValueError``;
  - the port's ``BatchAudioDataSet`` over a FLAC ``wav.scp`` yields
    ``lasr_tpu``'s batches, and the same batches as over the WAVs of the
    same PCM16; the port's ``ASRProcess`` (a tiny Conformer with the
    scaled absolute encoding, seeded weights) gives a FLAC file's
    features and tokens equal to its WAV's.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from lasr_tpu.data import dataset as jax_dataset
from lasr_tpu.data import flac as jax_flac
from lasr_tpu.data import mp3 as jax_mp3
from lasr_tpu.data import reader as jax_reader
from lasr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from lasr_tpu.models.e2e_ctc_att import E2E_Conformer_CTC
from lasr_tpu_torch.data import dataset, flac, mp3, reader
from lasr_tpu_torch.data.tokenizer import CharTokenizer
from lasr_tpu_torch.process.asrprocess import ASRProcess
from lasr_tpu_torch.utils.weights import flax_to_state_dict
from tests.mp3_craft import craft_intensity_stream
from tests.test_torch_port_cli import write_corpus
from tests.test_torch_port_data import _same_batches
from tests.torch_port_common import TINY, seeded_variables

FLAC_CASES = {
    "mono_fixed": dict(ch=1, lpc_order=None),
    "mono_lpc2": dict(ch=1, lpc_order=2),
    "mono_lpc4": dict(ch=1, lpc_order=4),
    "stereo": dict(ch=2, lpc_order=None),
    "stereo_24bit_lpc2": dict(ch=2, lpc_order=2, bits=24),
}


def _wave(seed, n, ch):
    """A seeded tone under noise, with a silent stretch (CONSTANT
    subframes) in its second block."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    w = np.stack([0.4 * np.sin(2 * np.pi * rng.uniform(100, 900) * t)
                  + 0.05 * rng.standard_normal(n) for _ in range(ch)], 1)
    w[4096:5000] = 0.0
    return w[:, 0] if ch == 1 else w


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_reads_bit_equal_and_writes_byte_identical(case, tmp_path):
    kw = dict(FLAC_CASES[case])
    wav = _wave(len(case), 11000, kw.pop("ch"))
    want_path, got_path = str(tmp_path / "j.flac"), str(tmp_path / "p.flac")
    jax_flac.write_flac(want_path, wav, 16000, **kw)
    flac.write_flac(got_path, wav, 16000, **kw)
    with open(want_path, "rb") as a, open(got_path, "rb") as b:
        assert a.read() == b.read()
    want, want_rate = jax_flac.read_flac(want_path)
    got, got_rate = flac.read_flac(want_path)
    assert got_rate == want_rate == 16000
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(reader.read_audio(want_path)[0], want)
    assert np.abs(got - wav).max() < 2.0 ** (1 - kw.get("bits", 16))


@pytest.mark.parametrize("mpeg1,mode_ext", [(True, 1), (False, 3)])
def test_mp3_streams_decode_bit_equal(mpeg1, mode_ext):
    data = craft_intensity_stream(mpeg1, n_frames=6, seed=3 + mode_ext,
                                  mode_ext=mode_ext)
    want, want_rate = jax_mp3.read_mp3(data)
    got, got_rate = mp3.read_mp3(data)
    assert got_rate == want_rate == (44100 if mpeg1 else 22050)
    assert got.shape == want.shape and got.shape[1] == 2
    assert np.abs(want).max() > 1e-4
    np.testing.assert_array_equal(got, want)
    tag = b"ID3\x04\x00\x00\x00\x00\x00\x20" + b"\x00" * 0x20
    np.testing.assert_array_equal(mp3.read_mp3(tag + data)[0], want)
    with pytest.raises(mp3.Mp3Error):
        mp3.read_mp3(b"\x00" * 4096)
    assert issubclass(mp3.Mp3Error, ValueError)


def test_read_audio_and_probes_equal_lasr_tpu(tmp_path):
    wav = _wave(5, 9000, 1)
    paths = {"wav": str(tmp_path / "x.wav"), "flac": str(tmp_path / "x.flac"),
             "mp3": str(tmp_path / "x.mp3")}
    reader.write_wav(paths["wav"], wav, 16000)
    flac.write_flac(paths["flac"], np.stack([wav, -wav], 1), 16000)
    with open(paths["mp3"], "wb") as f:
        f.write(craft_intensity_stream(False, n_frames=4, seed=2))
    for kind, path in paths.items():
        got, got_rate = reader.read_audio(path)
        want, want_rate = jax_reader.read_audio(path)
        assert got_rate == want_rate, kind
        np.testing.assert_array_equal(got, want, err_msg=kind)
        for probe in ("get_audio_frames", "get_audio_duration",
                      "get_audio_samplerate"):
            assert getattr(reader, probe)(path) == \
                getattr(jax_reader, probe)(path), (kind, probe)
    assert reader.get_audio_frames(paths["mp3"])[0] == \
        len(reader.read_audio(paths["mp3"])[0])
    other = tmp_path / "x.ogg"
    other.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="unknown audio type"):
        reader.read_audio(str(other))


def test_dataset_over_flac_scp_yields_lasr_tpu_batches(tmp_path):
    scp, txt, dict_path = write_corpus(str(tmp_path), n16=6, n8=2, seed=4)
    flac_scp = str(tmp_path / "flac.scp")
    with open(scp) as f, open(flac_scp, "w") as out:
        for line in f:
            uid, path = line.split()
            wav, rate = reader.read_wav(path)
            fpath = os.path.splitext(path)[0] + ".flac"
            flac.write_flac(fpath, wav, rate)
            out.write(f"{uid} {fpath}\n")
    args = dict(text_list=[txt], min_duration=0.0, text_freq=0.0,
                batch_type="size", batch_size=3)
    sets = {
        "jax_flac": jax_dataset.BatchAudioDataSet(
            wav_list=[flac_scp], tokenizer=JaxCharTokenizer(dict_path),
            **args),
        "flac": dataset.BatchAudioDataSet(
            wav_list=[flac_scp], tokenizer=CharTokenizer(dict_path), **args),
        "wav": dataset.BatchAudioDataSet(
            wav_list=[scp], tokenizer=CharTokenizer(dict_path), **args)}
    batches = {}
    for name, ds in sets.items():
        ds.load_check_data()
        batches[name] = list(ds.batches(shuffle=True, seed=1, num_workers=2))
    _same_batches(batches["jax_flac"], batches["flac"])
    _same_batches(batches["wav"], batches["flac"])


def test_asrprocess_reads_flac_as_wav(tmp_path):
    kw = dict(TINY, idim=80, encoder_pos_enc_layer_type="scaled_abs_pos",
              encoder_selfattention_layer_type="selfattn")
    x = np.zeros((1, 40, 80), np.float32)
    v = seeded_variables(E2E_Conformer_CTC(**kw), 3, x,
                         np.asarray([40], np.int32), np.ones((1, 3), np.int32))
    torch.save(flax_to_state_dict(v), tmp_path / "model.pt")
    (tmp_path / "dict.txt").write_text("A\nB\nC\n")
    with open(tmp_path / "hparams.yaml", "w") as f:
        yaml.safe_dump({
            "model_config": {
                "name": "lasr_tpu.models.e2e_ctc_att:E2E_Conformer_CTC",
                "kwargs": kw},
            "tokenizer_config": {
                "name": "lasr_tpu.data.tokenizer:CharTokenizer",
                "kwargs": {"dict_path": str(tmp_path / "dict.txt")}}}, f)
    with open(tmp_path / "decode.yaml", "w") as f:
        yaml.safe_dump({"decode_config": {
            "decode_method": "ctc_att", "beam": 3, "ctc_beam": 4,
            "ctc_weight": 0.5, "maxlenratio": 0.5}}, f)
    wav = _wave(6, 12000, 1)
    reader.write_wav(str(tmp_path / "x.wav"), wav, 16000)
    pcm16, _ = reader.read_wav(str(tmp_path / "x.wav"))
    flac.write_flac(str(tmp_path / "x.flac"), pcm16, 16000)
    asr = ASRProcess(str(tmp_path / "hparams.yaml"),
                     str(tmp_path / "decode.yaml"), str(tmp_path / "model.pt"),
                     device="cpu")
    w_wav, n_wav = asr.frontend_wave(str(tmp_path / "x.wav"))
    w_flac, n_flac = asr.frontend_wave(str(tmp_path / "x.flac"))
    assert n_flac == n_wav
    np.testing.assert_array_equal(w_flac, w_wav)
    got = asr(str(tmp_path / "x.flac"))
    assert got == asr(str(tmp_path / "x.wav")) and got[0]
