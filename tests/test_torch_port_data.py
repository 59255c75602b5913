"""The port's data layer against lasr_tpu's, on a seeded corpus written by
the test: 16 WAVs at 16 kHz and 2 at 8 kHz of 0.5-1.6 s.

  - both packages' ``BatchAudioDataSet`` keep the same ``train_set`` in the
    same order and the same groups (``batch_type`` size and duration), and
    ``batches(shuffle=True, seed, skip)`` yield identical batches: ids,
    ``token_id``, ``token_len``, ``wav_len`` and ``order_pad`` exactly,
    ``wav_array`` within 1e-6 (the 8 kHz files are resampled, and
    lasr_tpu may read through its native loader in float32);
  - the same with ``soxspeed``, and with ``cache_audio_mb`` on, in the
    second epoch (served from the cache);
  - ``resample_kaiser`` / ``resample_ratio`` within 1e-6 of lasr_tpu's;
  - the header probes, ``read_scp``, the edit-distance split and the WER
    accumulator equal lasr_tpu's;
  - what the port does not do raises: ``wire_dtype="int16"``,
    ``device_audio_cache``, a rank outside its sharding; FLAC or mp3
    files that hold neither raise the codecs' ``ValueError``.
"""

import numpy as np
import pytest

from lasr_tpu.data import dataset as jax_dataset
from lasr_tpu.data import reader as jax_reader
from lasr_tpu.data import resample as jax_resample
from lasr_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from lasr_tpu.process.asrprocess import ASRProcess as JaxASRProcess
from lasr_tpu.utils import text as jax_text
from lasr_tpu_torch.data import dataset, reader, resample
from lasr_tpu_torch.data.tokenizer import CharTokenizer
from lasr_tpu_torch.process.asrprocess import ASRProcess
from lasr_tpu_torch.utils import text
from tests.test_torch_port_cli import write_corpus

WAV_TOL = 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")))


def _pair(corpus, **kw):
    """(lasr_tpu's dataset, the port's), both loaded and checked."""
    scp, txt, dict_path = corpus
    args = dict(wav_list=[scp], text_list=[txt], min_duration=0.0,
                text_freq=0.0, **kw)
    jd = jax_dataset.BatchAudioDataSet(
        tokenizer=JaxCharTokenizer(dict_path), **args)
    pd = dataset.BatchAudioDataSet(tokenizer=CharTokenizer(dict_path),
                                   **args)
    jd.load_check_data()
    pd.load_check_data()
    return jd, pd


def _same_batches(jb, pb):
    assert len(jb) == len(pb) > 0
    for a, b in zip(jb, pb):
        assert a["id"] == b["id"]
        assert a["n_utts"] == b["n_utts"]
        assert a["order_pad"] == b["order_pad"]
        for k in ("token_id", "token_len", "wav_len"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["wav_array"].shape == b["wav_array"].shape
        np.testing.assert_allclose(b["wav_array"], a["wav_array"],
                                   atol=WAV_TOL, rtol=0)


BATCHING = {"size": dict(batch_type="size", batch_size=5),
            "duration": dict(batch_type="duration", batch_duration=4.0)}


@pytest.mark.parametrize("batching", list(BATCHING))
def test_train_set_and_groups_match(corpus, batching):
    jd, pd = _pair(corpus, **BATCHING[batching])
    assert [x["id"] for x in pd.train_set] == [x["id"] for x in jd.train_set]
    for a, b in zip(jd.train_set, pd.train_set):
        assert a["wav_len"] == b["wav_len"]
        assert a["n_samples"] == b["n_samples"]
        np.testing.assert_array_equal(a["token_id"], b["token_id"])
        assert a["row"] == b["row"]
    assert pd.batch_indices() == jd.batch_indices()
    assert len(pd) == len(jd) > 1
    for seed in (0, 7):
        assert pd.batch_indices(shuffle=True, seed=seed) == \
            jd.batch_indices(shuffle=True, seed=seed)
    for g in pd.batch_indices():
        assert pd.batch_shape(g) == jd.batch_shape(g)


@pytest.mark.parametrize("batching,seed,skip,trans", [
    ("size", 0, 0, ()),
    ("duration", 3, 1, ()),
    ("size", 5, 2, ("soxspeed",)),
])
def test_batches_match(corpus, batching, seed, skip, trans):
    kw = dict(BATCHING[batching],
              audio_trans=["norm", "fbank:80", *trans])
    jd, pd = _pair(corpus, **kw)
    jb = list(jd.batches(shuffle=True, seed=seed, skip=skip, num_workers=3))
    pb = list(pd.batches(shuffle=True, seed=seed, skip=skip, num_workers=3))
    assert len(pb) == len(pd) - skip
    _same_batches(jb, pb)
    if trans:
        # soxspeed changes lengths; the shape is known from the metadata
        for b, g in zip(pb, pd.batch_indices(shuffle=True, seed=seed)[skip:]):
            assert b["wav_array"].shape + b["token_id"].shape[1:] == \
                pd.batch_shape(g, perturb_seed=seed)


def test_cached_second_epoch_matches(corpus):
    jd, pd = _pair(corpus, cache_audio_mb=64, **BATCHING["duration"])
    for epoch in range(2):
        jb = list(jd.batches(shuffle=True, seed=epoch, num_workers=2))
        pb = list(pd.batches(shuffle=True, seed=epoch, num_workers=2))
        _same_batches(jb, pb)
    assert len(pd._wav_cache) == len(pd.train_set)
    assert pd._wav_cache_bytes == sum(w.nbytes
                                      for w in pd._wav_cache.values())


@pytest.mark.parametrize("src,dst", [(8000, 16000), (22050, 16000),
                                     (48000, 16000), (16000, 16000)])
def test_resample_kaiser_matches(src, dst):
    rng = np.random.default_rng(src)
    w = rng.standard_normal(int(0.3 * src))
    for quality in ("kaiser_fast", "kaiser_best"):
        got = resample.resample_kaiser(w, src, dst, quality)
        want = jax_resample.resample_kaiser(w, src, dst, quality)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    stereo = rng.standard_normal((int(0.1 * src), 2))
    np.testing.assert_allclose(resample.resample_kaiser(stereo, src, dst),
                               jax_resample.resample_kaiser(stereo, src, dst),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("num,den", [(10, 9), (10, 11), (1, 1)])
def test_resample_ratio_matches(num, den):
    w = np.random.default_rng(num + den).standard_normal(4000)
    got = resample.resample_ratio(w, num, den)
    np.testing.assert_allclose(got, jax_resample.resample_ratio(w, num, den),
                               atol=1e-6, rtol=0)
    assert len(got) == dataset._resample_out_len(len(w), num, den) == \
        jax_dataset._resample_out_len(len(w), num, den)


def test_helpers_match():
    for seed in (0, 1, 42):
        for uid in ("a", "utt001", "spk-7_x"):
            assert dataset._perturb_ratio(seed, uid) == \
                jax_dataset._perturb_ratio(seed, uid)
    assert dataset.SPEED_RATES == jax_dataset.SPEED_RATES
    assert dataset._SPEED_NUM_DEN == jax_dataset._SPEED_NUM_DEN
    for n, m in ((0, 8), (1, 8), (8, 8), (17, 16000)):
        assert dataset.round_up(n, m) == jax_dataset.round_up(n, m)
    arrays = [np.arange(3), np.arange(5)]
    np.testing.assert_array_equal(
        dataset.pad_stack(arrays, -1, 6, np.int32),
        jax_dataset.pad_stack(arrays, -1, 6, np.int32))


def test_reader_probes_match(corpus):
    scp, txt, _ = corpus
    assert reader.read_scp(scp) == jax_reader.read_scp(scp)
    assert reader.read_scp(txt) == jax_reader.read_scp(txt)
    for _, path in reader.read_scp(scp):
        assert reader.get_audio_frames(path) == \
            jax_reader.get_audio_frames(path)
        assert reader.get_audio_duration(path) == \
            jax_reader.get_audio_duration(path)
        assert reader.get_audio_samplerate(path) == \
            jax_reader.get_audio_samplerate(path)


def test_asrprocess_resamples_like_lasr_tpu(corpus):
    """The 16 kHz-only rule is gone: an 8 kHz WAV is read through the same
    resampler in both packages (``frontend_wave`` uses no state)."""
    path = reader.read_scp(corpus[0])[-1][1]
    assert reader.get_audio_samplerate(path) == 8000
    got, n = ASRProcess.frontend_wave(None, path)
    want, m = JaxASRProcess.frontend_wave(None, path)
    assert n == m == len(got)
    np.testing.assert_allclose(got, want, atol=WAV_TOL, rtol=0)


@pytest.mark.parametrize("ref,hyp", [
    ("ABCD", "ABCD"), ("ABCD", "AXCD"), ("ABCD", "ACD"), ("ABC", "ABBC"),
    ("", "AB"), ("KITTEN", "SITTING"), ("A B C", "A C D E")])
def test_error_rate_matches(ref, hyp):
    assert text.align_ops(ref, hyp) == jax_text.align_ops(ref, hyp)
    assert text.edit_distance(ref, hyp) == jax_text.edit_distance(ref, hyp)
    ours, theirs = text.ErrorRateAccumulator(), jax_text.ErrorRateAccumulator()
    for _ in range(2):
        assert ours.add(ref, hyp) == theirs.add(ref, hyp)
    assert ours.rate == theirs.rate
    assert ours.report() == theirs.report()


@pytest.mark.parametrize("kw,match", [
    (dict(wire_dtype="int16"), "int16"),
    (dict(device_audio_cache=True), "device_audio_cache"),
])
def test_unported_options_raise(corpus, kw, match):
    """Both options were refused until the port took them: now each is
    accepted, and what lasr_tpu refuses raises its ValueError."""
    ds = dataset.BatchAudioDataSet(wav_list=[corpus[0]],
                                   text_list=[corpus[1]], **kw)
    assert {k: getattr(ds, k) for k in kw} == kw
    for bad, words in ((dict(audio_trans=["soxspeed", "fbank:80"]),
                        "soxspeed"), (dict(pad_audio=0.5), "pad_audio")):
        for cls in (dataset.BatchAudioDataSet, jax_dataset.BatchAudioDataSet):
            with pytest.raises(ValueError, match=words):
                cls(wav_list=[corpus[0]], text_list=[corpus[1]],
                    **dict(kw, device_audio_cache=True, **bad))
    with pytest.raises(ValueError, match="wire_dtype"):
        dataset.AudioDataSet(wire_dtype="int8")


def test_multi_process_sharding_and_other_audio_raise(corpus, tmp_path):
    _, pd = _pair(corpus, **BATCHING["size"])
    with pytest.raises(ValueError, match="process_index 2 of 2"):
        next(pd.batches(process_index=2, process_count=2))
    with pytest.raises(ValueError, match="local_rank 1 of 1"):
        next(pd.batches(local_rank=1))
    # FLAC and mp3 are read (tests/test_torch_port_codecs.py); a file
    # that is neither raises the codec's ValueError, as in lasr_tpu
    for name, match in (("x.flac", "not a FLAC file"),
                        ("x.mp3", "no Layer III frames")):
        (tmp_path / name).write_bytes(b"\0" * 64)
        for fn in (reader.get_audio_frames, reader.read_audio,
                   jax_reader.get_audio_frames, jax_reader.read_audio):
            with pytest.raises(ValueError, match=match):
                fn(str(tmp_path / name))
