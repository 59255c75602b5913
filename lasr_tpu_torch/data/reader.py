"""Host-side audio reading and WAV writing (counterpart of
``lasr_tpu/data/reader.py``).

RIFF/WAVE parsing over numpy: PCM 8/16/24/32-bit and IEEE float 32/64,
any channel count, returning float64 in [-1, 1] with soundfile's scaling.
``read_audio`` dispatches on the extension: ``.wav`` here, ``.flac`` to
``data.flac`` and ``.mp3`` to ``data.mp3`` (first-party numpy codecs;
mono mp3 comes back as (N,)); another extension raises ``ValueError``.
Header-only probes (``get_audio_frames``, ``get_audio_duration``,
``get_audio_samplerate``; FLAC's STREAMINFO, mp3's frame headers) and the
Kaldi ``read_scp`` list parser serve the dataset.
"""

from __future__ import annotations

import os
import struct
from typing import IO, List, Tuple

import numpy as np


def _parse_wav_header(f: IO[bytes]):
    """Returns (audio_format, channels, sample_rate, bits, data_size)."""
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise ValueError("no data chunk found")
        chunk_id, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if chunk_id == b"fmt ":
            body = f.read(size)
            if len(body) < 16:
                raise ValueError("truncated fmt chunk")
            audio_format, channels, sample_rate = struct.unpack(
                "<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_format = struct.unpack("<H", body[24:26])[0]
            fmt = (audio_format, channels, sample_rate, bits)
            if size % 2:
                f.read(1)
        elif chunk_id == b"data":
            if fmt is None:
                raise ValueError("data chunk before fmt chunk")
            return fmt + (size,)
        else:
            f.seek(size + (size % 2), os.SEEK_CUR)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """WAV file → (waveform in [-1, 1], sample_rate); (N,) mono, (N, C)
    multi-channel, the layout soundfile.read produces."""
    with open(path, "rb") as f:
        audio_format, channels, rate, bits, size = _parse_wav_header(f)
        raw = f.read(size)
    if audio_format == 1:
        if bits == 16:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 32:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float64) \
                / 2147483648.0
        elif bits == 8:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64)
                    - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                   | (b[:, 2].astype(np.int32) << 16))
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            data = val.astype(np.float64) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:
        dtype = "<f4" if bits == 32 else "<f8"
        data = np.frombuffer(raw, dtype=dtype).astype(np.float64)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")
    if channels > 1:
        data = data.reshape(-1, channels)
    return data, rate


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    ext = _ext(path)
    if ext == ".wav":
        return read_wav(path)
    if ext == ".flac":
        from lasr_tpu_torch.data.flac import read_flac
        return read_flac(path)
    if ext == ".mp3":
        from lasr_tpu_torch.data.mp3 import read_mp3
        wav, rate = read_mp3(path)
        if wav.ndim == 2 and wav.shape[1] == 1:
            wav = wav[:, 0]
        return wav, rate
    raise ValueError(f"unknown audio type for {path}")


def get_audio_frames(path: str) -> Tuple[int, int]:
    """Header-only (num_frames, sample_rate) probe (wav / flac / mp3)."""
    if _ext(path) == ".flac":
        from lasr_tpu_torch.data.flac import flac_info
        fi = flac_info(path)
        return int(fi.total_samples), int(fi.sample_rate)
    if _ext(path) == ".mp3":
        from lasr_tpu_torch.data.mp3 import mp3_info
        rate, _, samples = mp3_info(path)
        return int(samples), int(rate)
    with open(path, "rb") as f:
        _, channels, rate, bits, size = _parse_wav_header(f)
    bytes_per_frame = channels * (bits // 8)
    return (size // bytes_per_frame if bytes_per_frame else 0), int(rate)


def get_audio_duration(path: str) -> float:
    frames, rate = get_audio_frames(path)
    return frames / rate if rate else 0.0


def get_audio_samplerate(path: str) -> int:
    return get_audio_frames(path)[1]


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """PCM16 WAV writer."""
    x = np.clip(np.asarray(data, dtype=np.float64), -1.0, 1.0)
    pcm = np.round(x * 32767.0).astype("<i2")
    channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    payload = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels,
                                      sample_rate, sample_rate * channels * 2,
                                      channels * 2, 16))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)


def read_scp(path: str) -> List[Tuple[str, str]]:
    """Parse ``<id> <rest-of-line>`` rows (wav.scp / text)."""
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rest = line.partition(" ")
            rows.append((key, rest))
    return rows


def read_list(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return f.read().splitlines()


def average_channels(wav: np.ndarray) -> np.ndarray:
    """The reference's ``avgchannel`` transform."""
    if wav.ndim == 2:
        return np.mean(wav, axis=1)
    return wav
