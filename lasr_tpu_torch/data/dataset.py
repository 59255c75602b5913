"""Datasets: Kaldi-scp loading, length-aware batching, bucketed padding
(counterpart of ``lasr_tpu/data/dataset.py``).

  - ``AudioDataSet``: rows of ``{id, wav, text}`` from parallel wav.scp /
    text lists (ids must match); ``load_check_data`` probes every WAV
    header and tokenizes every transcript.
  - ``BatchAudioDataSet``: the ``shuffle_seed`` shuffle, the stable sort by
    ``wav_len*16000 + token_len``, the duration / token / ``text_freq``
    filters, then groups by count (``batch_type: size``) or total seconds
    (``duration``).

Batches carry raw 16 kHz waveforms as numpy arrays (the frontend runs on
the device inside the train step), padded to buckets: samples up to
``sample_bucket`` multiples, token lengths to ``token_bucket`` multiples,
the batch up to ``batch_pad_multiple`` with zero-length rows that the loss
masks.  The worker threads read and pad on the host only; they never
touch the device.

Every ``random.Random`` call is the JAX package's, so both packages give
the same groups and the same epoch order for a seed.

Decoding: an all-WAV/FLAC batch goes through the native C++ loader
(``data.native_loader``, threads outside the GIL) where it builds, a
rate other than 16 kHz then Kaiser-resampled; other batches, or a host
without ``g++``, through the Python readers.  Both give the same bits.

``wire_dtype="int16"``: the decoded-audio cache and the batch's
``wav_array`` hold int16 on the readers' /32768 grid (PCM16 sources
round-trip exactly; the padding value is quantized too), half the bytes
of float32; the frontend dequantizes.  ``device_audio_cache``: every
batch also carries ``wav_rows`` (each row's stable dataset row, padding
rows the sentinel n) and ``wav_S``, from which the trainer's device
audio pool (``train.trainer._DeviceAudioPool``) keeps the waves on the
device after the first epoch; it needs waves that do not change with
the epoch (no ``soxspeed``) and zero padding (``pad_audio`` 0).

Data parallelism (``batches``): the hosts (``process_index`` of
``process_count``) take whole batches round-robin, as ``lasr_tpu``'s
processes do, and the ranks on a host (``local_rank`` of
``local_world_size``, one per GPU) take rows of the host's batch; each
rank reads only its rows' audio.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import random
import threading
import zlib
from math import ceil, gcd
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from lasr_tpu_torch.data import native_loader, reader, resample

SAMPLE_RATE = 16000

# sox speed-perturbation factors and their exact rational resample ratios:
# rate r stretches time by 1/r, n_out = ceil(n * num/den) (gcd-reduced)
SPEED_RATES = (1.0, 1.1, 0.9)
_SPEED_NUM_DEN = {0.9: (10, 9), 1.1: (10, 11), 1.0: (1, 1)}


def _resample_out_len(n: int, num: int, den: int) -> int:
    """Exact output length of resample.resample_{kaiser,ratio}."""
    if num == den:
        return n
    g = gcd(num, den)
    return ceil(n * (num // g) / (den // g))


def _perturb_ratio(seed: int, utt_id: str) -> float:
    """Deterministic per-(seed, utterance) speed factor: batch shapes are
    computable without reading audio, and a resumed run redraws the same
    factors."""
    h = zlib.crc32(f"{seed}:{utt_id}".encode())
    return SPEED_RATES[h % len(SPEED_RATES)]


def round_up(n: int, multiple: int) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


def _quantize_i16(w: np.ndarray) -> np.ndarray:
    """float [-1, 1) wave → int16 on the readers' /32768 grid; PCM-sourced
    samples round-trip exactly."""
    if w.dtype == np.int16:
        return w
    return np.clip(np.rint(w * 32768.0), -32768, 32767).astype(np.int16)


def _dequantize_i16(w: np.ndarray) -> np.ndarray:
    if w.dtype == np.int16:
        return w.astype(np.float32) / np.float32(32768.0)
    return w


def pad_stack(arrays: Sequence[np.ndarray], pad_value, length: int,
              dtype) -> np.ndarray:
    out = np.full((len(arrays), length) + arrays[0].shape[1:], pad_value,
                  dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, : len(a)] = a
    return out


class AudioDataSet:
    """Kaldi-scp dataset; one __getitem__ row = one utterance dict."""

    PAD_ID = 4  # BaseTokenizer.ID_VALUE_PAD

    def __init__(self, wav_list=None, text_list=None, feats_list=None,
                 tokenizer=None, audio_trans=("fbank:80",), feats_trans=None,
                 pad_audio=0, pad_feats=0,
                 sample_bucket: int = SAMPLE_RATE,
                 token_bucket: int = 8,
                 batch_pad_multiple: int = 1,
                 cache_audio_mb: int = 0,
                 wire_dtype: str = "float32",
                 device_audio_cache: bool = False):
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(
                f"wire_dtype must be 'float32' or 'int16', got {wire_dtype!r}")
        if device_audio_cache and audio_trans \
                and "soxspeed" in list(audio_trans):
            raise ValueError(
                "device_audio_cache requires epoch-invariant waveforms; "
                "soxspeed redraws the speed ratio per epoch — disable one")
        if device_audio_cache and pad_audio:
            raise ValueError(
                "device_audio_cache requires pad_audio=0 (the pool's "
                "sentinel row is zeros)")
        if isinstance(wav_list, str):
            wav_list = [wav_list]
        if isinstance(text_list, str):
            text_list = [text_list]
        self.wav_list = wav_list or []
        self.text_list = text_list or []
        self.feats_list = feats_list
        self.tokenizer = tokenizer
        self.audio_trans = list(audio_trans) if audio_trans else []
        self.feats_trans = feats_trans
        self.pad_audio = pad_audio
        self.pad_feats = pad_feats
        self.sample_bucket = sample_bucket
        self.token_bucket = token_bucket
        self.batch_pad_multiple = batch_pad_multiple
        # decoded-audio RAM cache (MB budget; 0 = off): the post-resample
        # 16 kHz waves (int16 under wire_dtype 'int16'), before soxspeed
        # (whose ratio changes with the epoch's seed), inserted until the
        # budget is spent
        self.cache_audio_mb = cache_audio_mb
        self.wire_dtype = wire_dtype
        self.device_audio_cache = device_audio_cache
        self._wav_cache: Dict[str, np.ndarray] = {}
        self._wav_cache_bytes = 0
        self._cache_lock = threading.Lock()
        self.train_set: List = []

    def __len__(self) -> int:
        return len(self.train_set)

    def __getitem__(self, index):
        return self.train_set[index]

    def load_check_data(self) -> None:
        self.load_dataset()
        self.check_dataset()
        # stable row ids (after shuffle / sort / filter)
        for i, it in enumerate(self.train_set):
            it["row"] = i

    def max_bucketed_samples(self) -> int:
        """Upper bound of any batch's padded S (the device pool's row
        width)."""
        n = max((self.expected_samples(it) for it in self.train_set),
                default=1)
        return round_up(n, self.sample_bucket)

    def load_dataset(self) -> None:
        for wav_path, text_path in zip(self.wav_list, self.text_list):
            wav_rows = reader.read_scp(wav_path)
            text_rows = reader.read_scp(text_path)
            if len(wav_rows) != len(text_rows):
                raise RuntimeError(
                    f"row count mismatch: {wav_path} has {len(wav_rows)}, "
                    f"{text_path} has {len(text_rows)}")
            for (wid, wpath), (tid, text) in zip(wav_rows, text_rows):
                if wid != tid:
                    raise RuntimeError(
                        f"input data id doesn't match {wid},{tid}")
                self.train_set.append({
                    "id": wid, "wav": wpath, "text": text.upper(),
                    "feats": "None"})

    def check_dataset(self) -> None:
        logging.info("Checking data (%d utts)", len(self.train_set))
        for item in self.train_set:
            if item["wav"] != "None":
                frames, rate = reader.get_audio_frames(item["wav"])
                item["wav_len"] = frames / rate
                # exact 16 kHz sample count after read-time resampling
                item["n_samples"] = _resample_out_len(frames, SAMPLE_RATE,
                                                      rate)
            else:
                item["wav_len"] = 0.0
                item["n_samples"] = 0
            if item["text"] != "None" and self.tokenizer is not None:
                item["token"], ids = self.tokenizer.encode(
                    item["text"], add_sos_eos=False)
                item["token_id"] = np.asarray(ids, dtype=np.int64)
                item["token_len"] = len(ids)
            else:
                item["token_id"] = np.asarray([0], dtype=np.int64)
                item["token_len"] = 0

    # ---- batch assembly ----

    def _read_waves(self, items: Sequence[Dict]) -> List[np.ndarray]:
        """Batch audio as 16 kHz waves, through the decoded-audio cache
        when ``cache_audio_mb`` is set: float32, or int16 when cached
        under ``wire_dtype='int16'`` (``merge_batch`` takes both)."""
        paths = [it["wav"] for it in items]
        if not self.cache_audio_mb:
            return self._decode_waves(paths)
        with self._cache_lock:
            missing = [p for p in paths if p not in self._wav_cache]
        decoded = dict(zip(missing, self._decode_waves(missing))) \
            if missing else {}
        budget = self.cache_audio_mb * 2 ** 20
        with self._cache_lock:
            for p, w in decoded.items():
                if self.wire_dtype == "int16":
                    w = decoded[p] = _quantize_i16(w)
                if p not in self._wav_cache and \
                        self._wav_cache_bytes + w.nbytes <= budget:
                    # a copy: the native loader's rows are views into the
                    # whole (B, max_s) batch buffer
                    self._wav_cache[p] = np.ascontiguousarray(w)
                    self._wav_cache_bytes += w.nbytes
            return [decoded[p] if p in decoded else self._wav_cache[p]
                    for p in paths]

    @staticmethod
    def _decode_waves(paths: Sequence[str]) -> List[np.ndarray]:
        """Decode audio paths: the native loader for an all-WAV/FLAC batch
        when it builds, the Python readers otherwise; 16 kHz float32."""
        if paths and all(p.lower().endswith((".wav", ".flac"))
                         for p in paths):
            try:
                if native_loader.available():
                    infos = [native_loader.wav_info(p) for p in paths]
                    max_s = max(max(n for n, _, _ in infos), 1)
                    wav, lens, rates = native_loader.read_batch(paths, max_s)
                    out = []
                    for i in range(len(paths)):
                        w = wav[i, : lens[i]]
                        if rates[i] != SAMPLE_RATE:
                            w = resample.resample_kaiser(
                                w, int(rates[i]), SAMPLE_RATE
                            ).astype(np.float32)
                        out.append(w)
                    return out
            except ValueError as e:
                logging.warning("native loader failed (%s); python "
                                "fallback", e)
        out = []
        for p in paths:
            wav, sr = reader.read_audio(p)
            wav = reader.average_channels(wav)
            if sr != SAMPLE_RATE:
                wav = resample.resample_kaiser(wav, sr, SAMPLE_RATE)
            out.append(np.asarray(wav, dtype=np.float32))
        return out

    def expected_samples(self, item: Dict, perturb_seed: int = 0) -> int:
        """Exact decoded length (16 kHz samples, soxspeed included) from
        the metadata, without reading audio."""
        n = item.get("n_samples", 0)
        if "soxspeed" in self.audio_trans:
            num, den = _SPEED_NUM_DEN[_perturb_ratio(perturb_seed,
                                                     item["id"])]
            n = _resample_out_len(n, num, den)
        return n

    def batch_shape(self, group: Sequence[int], perturb_seed: int = 0
                    ) -> Tuple[int, int, int]:
        """Padded (B, S, L) of ``merge_batch`` over these row indices."""
        items = [self.train_set[i] for i in group]
        S = round_up(max(self.expected_samples(it, perturb_seed)
                         for it in items), self.sample_bucket)
        L = round_up(max(it["token_len"] for it in items) or 1,
                     self.token_bucket)
        B = round_up(len(items), self.batch_pad_multiple)
        return B, S, L

    def _rank_batch(self, groups: Sequence[Sequence[int]],
                    process_index: int, local_rank: int,
                    local_world_size: int, perturb_seed: int) -> Dict:
        """Rank ``local_rank``'s rows of host ``process_index``'s batch in
        the global batch of ``groups`` (one group per host).  Every host's
        batch takes the largest of their ``batch_shape``s (``lasr_tpu``'s
        ``pad_shapes``), B rounded up to a multiple of
        ``local_world_size``."""
        B, S, L = np.max([self.batch_shape(g, perturb_seed)
                          for g in groups], axis=0).tolist()
        B = round_up(B, local_world_size)
        b = B // local_world_size
        global_len = np.zeros((len(groups) * B,), np.int32)
        for p, g in enumerate(groups):
            global_len[p * B: p * B + len(g)] = [
                self.expected_samples(self.train_set[i], perturb_seed)
                for i in g]
        row0 = process_index * B + local_rank * b
        mine = groups[process_index][local_rank * b: (local_rank + 1) * b]
        out = self.merge_batch([self.train_set[i] for i in mine],
                               perturb_seed, pad_to=(b, S, L))
        if not np.array_equal(out["wav_len"],
                              global_len[row0: row0 + b]):
            raise RuntimeError(
                f"decoded lengths {out['wav_len'].tolist()} differ from "
                f"the metadata's {global_len[row0: row0 + b].tolist()}")
        out.update(row0=row0, global_wav_len=global_len,
                   n_utts=sum(len(g) for g in groups))
        return out

    def merge_batch(self, items: Sequence[Dict], perturb_seed: int = 0,
                    pad_to: Optional[Tuple[int, int, int]] = None) -> Dict:
        """Read and host-transform the waveforms and pad to the bucketed
        (B, S, L), or to ``pad_to`` (B, S, L), which raises if the items
        need more.  With ``pad_to`` the items may be none (a rank's share
        of pad rows)."""
        waves = self._read_waves(items)
        if "soxspeed" in self.audio_trans:
            # speed perturbation: resampling the wave by 1/ratio at a fixed
            # rate is the sox `speed` time-stretch
            waves = [self._speed_perturb(
                _dequantize_i16(w), _perturb_ratio(perturb_seed, it["id"]))
                for w, it in zip(waves, items)]
        wave_lens = [len(w) for w in waves]

        S = round_up(max(wave_lens, default=1), self.sample_bucket)
        L = round_up(max((it["token_len"] for it in items), default=0) or 1,
                     self.token_bucket)
        B = round_up(len(items), self.batch_pad_multiple)
        if pad_to is not None:
            if pad_to[0] < len(items) or pad_to[1] < S or pad_to[2] < L:
                raise RuntimeError(
                    f"batch shape prediction too small: predicted {pad_to}, "
                    f"actual {(len(items), S, L)}: metadata and decoder "
                    f"disagree")
            B, S, L = pad_to

        if self.wire_dtype == "int16":
            pad_q = int(np.clip(round(float(self.pad_audio) * 32768.0),
                                -32768, 32767))
            wav_array = np.full((B, S), pad_q, dtype=np.int16)
            for i, w in enumerate(waves):
                wav_array[i, : len(w)] = _quantize_i16(w)
        else:
            wav_array = np.full((B, S), float(self.pad_audio),
                                dtype=np.float32)
            for i, w in enumerate(waves):
                wav_array[i, : len(w)] = _dequantize_i16(w)
        wav_len = np.zeros((B,), dtype=np.int32)
        wav_len[: len(items)] = wave_lens

        token_id = np.full((B, L), self.PAD_ID, dtype=np.int32)
        token_len = np.zeros((B,), dtype=np.int32)
        for i, it in enumerate(items):
            token_id[i, : it["token_len"]] = it["token_id"]
            token_len[i] = it["token_len"]

        out = {
            "id": [it["id"] for it in items],
            "wav": [it["wav"] for it in items],
            "text": [it["text"] for it in items],
            "wav_array": wav_array,
            "wav_len": wav_len,
            "token_id": token_id,
            "token_len": token_len,
            "n_utts": len(items),
        }
        if self.device_audio_cache:
            # padding rows point at the pool's zeros sentinel (row n)
            rows = np.full((B,), len(self.train_set), dtype=np.int32)
            rows[: len(items)] = [it["row"] for it in items]
            out["wav_rows"] = rows
            out["wav_S"] = int(S)
        return out

    @staticmethod
    def _speed_perturb(wav: np.ndarray, ratio: float) -> np.ndarray:
        """Speed perturbation by windowed-sinc resampling at a fixed output
        rate: rate r stretches time by 1/r."""
        if ratio == 1.0:
            return wav
        num, den = _SPEED_NUM_DEN.get(ratio, (round(1000 / ratio), 1000))
        return resample.resample_ratio(wav, num, den).astype(np.float32)

    def batch_indices(self, shuffle: bool = False, seed: int = 0
                      ) -> List[List[int]]:
        """Plain dataset: one utterance per batch (decode-style)."""
        idx = list(range(len(self.train_set)))
        if shuffle:
            random.Random(seed).shuffle(idx)
        return [[i] for i in idx]

    def batches(self, shuffle: bool = False, seed: int = 0,
                num_workers: int = 4, prefetch: int = 4,
                process_index: int = 0, process_count: int = 1,
                skip: int = 0, local_rank: int = 0,
                local_world_size: int = 1) -> Iterator[Dict]:
        """This rank's batches in order, read ahead by ``num_workers``
        threads.

        Worker w assembles batches w, w + n, w + 2n, ... into its own
        queue and the consumer drains the queues round-robin, so the order
        is ``batch_indices(shuffle, seed)``'s whatever the thread timing.
        ``skip``: drop the first N steps without reading their audio
        (mid-epoch resume: the order is a pure function of ``seed``).

        Data parallelism, as ``lasr_tpu``'s ``batches(process_index,
        process_count)``: the order is padded to a multiple of
        ``process_count`` by cycling batches from its head (tagged
        ``order_pad``, so that validation skips them) and host p takes
        batches p, p + P, ...; step s's global batch is the P host batches
        of order[s·P:(s+1)·P] padded to one shape.  Rank
        ``local_rank`` of the host takes rows ``local_rank·b`` to
        ``(local_rank+1)·b`` of its host batch (b = B / local_world_size,
        B padded to a multiple of it), padded to the global batch's
        sample and token lengths, so that every rank's frontend gives the
        same frame count.  Every batch also carries ``row0`` (its first
        row in the global batch), ``global_wav_len`` (the global batch's
        wave lengths, from the metadata), ``n_utts`` (the global batch's
        utterances) and ``order_pad``; one rank's batch is the whole
        global batch, at ``row0`` 0."""
        if not (0 <= process_index < process_count
                and 0 <= local_rank < local_world_size):
            raise ValueError(
                f"no such rank: process_index {process_index} of "
                f"{process_count}, local_rank {local_rank} of "
                f"{local_world_size}")
        order = self.batch_indices(shuffle=shuffle, seed=seed)
        n_real = len(order)
        P = process_count
        if P > 1 and order and len(order) % P:
            order = order + [order[i % len(order)]
                             for i in range(P - len(order) % P)]
        steps = [order[g: g + P] for g in range(0, len(order), P)][skip:]
        pad_flags = [skip * P + s * P + process_index >= n_real
                     for s in range(len(steps))]
        if not steps:
            return
        stop = object()

        def worker(sub, out_q):
            for pos, groups in sub:
                merged = self._rank_batch(groups, process_index,
                                          local_rank, local_world_size, seed)
                merged["order_pad"] = pad_flags[pos]
                out_q.put(merged)
            out_q.put(stop)

        indexed = list(enumerate(steps))

        n_workers = max(1, min(num_workers, len(indexed)))
        qs = [queue_mod.Queue(maxsize=max(1, prefetch // n_workers))
              for _ in range(n_workers)]
        threads = [threading.Thread(target=worker,
                                    args=(indexed[w::n_workers], qs[w]),
                                    daemon=True)
                   for w in range(n_workers)]
        for t in threads:
            t.start()
        done = [False] * n_workers
        pos = served = 0
        while served < len(indexed):
            w = pos % n_workers
            pos += 1
            if done[w]:
                continue
            item = qs[w].get()
            if item is stop:
                done[w] = True
                continue
            served += 1
            yield item
        for t in threads:
            t.join()


class BatchAudioDataSet(AudioDataSet):
    """Dataset-level dynamic batching."""

    def __init__(self, wav_list=None, text_list=None, feats_list=None,
                 tokenizer=None, audio_trans=("fbank:80",), feats_trans=None,
                 pad_audio=0, pad_feats=0,
                 batch_sort=True, batch_size=32, batch_duration=320,
                 batch_bin=32 * 500 * 80, batch_type="size",
                 max_duration=30, min_duration=0.3, text_freq=0.08,
                 min_token=0, max_token=5000,
                 sample_bucket: int = SAMPLE_RATE, token_bucket: int = 8,
                 batch_pad_multiple: int = 1, shuffle_seed: int = 1,
                 cache_audio_mb: int = 0,
                 wire_dtype: str = "float32",
                 device_audio_cache: bool = False):
        super().__init__(wav_list, text_list, feats_list, tokenizer,
                         audio_trans, feats_trans, pad_audio, pad_feats,
                         sample_bucket, token_bucket, batch_pad_multiple,
                         cache_audio_mb, wire_dtype, device_audio_cache)
        self.batch_type = batch_type
        self.batch_size = batch_size
        self.batch_bin = batch_bin
        self.batch_duration = batch_duration
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.text_freq = text_freq
        self.min_token = min_token
        self.max_token = max_token
        self.batch_sort = batch_sort
        self.shuffle_seed = shuffle_seed
        self._groups: List[List[int]] = []

    def check_dataset(self) -> None:
        super().check_dataset()
        rng = random.Random(self.shuffle_seed)
        rng.shuffle(self.train_set)  # decorrelate sources before stable sort
        if self.batch_sort:
            self.train_set.sort(
                key=lambda x: x["wav_len"] * SAMPLE_RATE + x["token_len"])
        before = len(self.train_set)
        self.train_set = [
            x for x in self.train_set
            if (self.min_duration <= x["wav_len"] <= self.max_duration
                and self.min_token <= x["token_len"] <= self.max_token
                and x["wav_len"] / (x["token_len"] + 0.1) > self.text_freq)]
        if before != len(self.train_set):
            logging.info("filtered %d → %d utterances", before,
                         len(self.train_set))
        if self.batch_type == "size":
            self._groups = [list(range(i, min(i + self.batch_size,
                                              len(self.train_set))))
                            for i in range(0, len(self.train_set),
                                           self.batch_size)]
        elif self.batch_type == "duration":
            self._groups = []
            cur: List[int] = []
            total = 0.0
            for i, item in enumerate(self.train_set):
                cur.append(i)
                total += item["wav_len"]
                if total >= self.batch_duration:
                    self._groups.append(cur)
                    cur, total = [], 0.0
            if cur:
                self._groups.append(cur)
        else:
            raise ValueError(f"unknown batch_type {self.batch_type}")

    def __len__(self) -> int:
        return len(self._groups)

    def __getitem__(self, index):
        return [self.train_set[i] for i in self._groups[index]]

    def batch_indices(self, shuffle: bool = False, seed: int = 0
                      ) -> List[List[int]]:
        groups = list(self._groups)
        if shuffle:
            random.Random(seed).shuffle(groups)
        return groups
