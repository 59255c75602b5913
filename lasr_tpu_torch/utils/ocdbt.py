"""Read and write ``lasr_tpu``'s orbax checkpoints without orbax,
tensorstore or a zstd package.

An orbax checkpoint directory (what ``ocp.StandardCheckpointer`` writes,
and each ``<step>/default`` of a ``CheckpointManager``) holds:

  - ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's key path
    (``"('params', 'encoder', …)"``) to its key types (2: a dict key, 1: a
    sequence index) and value type (``"None"`` for an empty optax state);
  - an OCDBT key-value store (tensorstore's ``ocdbt`` driver):
    ``manifest.ocdbt`` names the newest version's B-tree root; B-tree
    nodes and values live in data files ``d/<hash>`` (or under
    ``ocdbt.process_<i>/``), each node an envelope (magic, length,
    version, compression, body, CRC-32C), the body zstd-compressed or
    plain;
  - in that store, one zarr v2 array per leaf, named by the key path
    joined with ``.``: ``<name>/.zarray`` (JSON: shape, chunks, dtype,
    compressor, order, fill value) and a chunk per grid cell
    (``<name>/0.1``; ``<name>/0`` for a scalar), zstd-compressed or raw.

``OcdbtStore`` reads the store into one ``{key: value}`` view (values read
on demand), ``read_array`` assembles a zarr array from its chunks, and
``load_tree`` rebuilds the nested tree of torch tensors (``bfloat16``
leaves as ``torch.bfloat16``; lists where the keys are sequence
indices).  ``save_tree`` writes the same layout as orbax does for an
unsharded tree (one chunk per array, every chunk and node a zstd frame,
its blocks stored raw or run-length), which orbax reads back;
``save_step`` wraps it as a ``CheckpointManager``'s step directory.
"""

from __future__ import annotations

import json
import os
import struct
import time
import uuid
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from lasr_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
NULL_OFFSET = (1 << 64) - 1
# orbax's OCDBT settings (the writer's too)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """A forward reader over a node or manifest body."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError("ocdbt: truncated record")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError("ocdbt: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _open_envelope(blob: bytes, magic: int) -> bytes:
    """The body of an encoded manifest or node, its envelope checked."""
    if len(blob) < 18:
        raise ValueError("ocdbt: truncated envelope")
    got_magic, length = struct.unpack_from(">I", blob)[0], \
        struct.unpack_from("<Q", blob, 4)[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    if length != len(blob):
        raise ValueError("ocdbt: envelope length mismatch")
    if crc32c(blob[:-4]) != struct.unpack_from("<I", blob, len(blob) - 4)[0]:
        raise ValueError("ocdbt: CRC-32C mismatch")
    cur = _Cursor(blob[12:-4])
    if cur.varint() != 0:
        raise ValueError("ocdbt: unknown format version")
    compression = cur.u8()
    body = blob[12 + cur.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise ValueError(f"ocdbt: unknown compression {compression}")
    return body


def _envelope(body: bytes, magic: int) -> bytes:
    """``body`` as a zstd frame in the envelope ``_open_envelope``
    reads."""
    head = struct.pack(">I", magic)
    rest = _varint(0) + b"\x01" + b"".join(zstd_frame(body))
    blob = head + struct.pack("<Q", 4 + 8 + len(rest) + 4) + rest
    return blob + struct.pack("<I", crc32c(blob))


ZSTD_BLOCK = 1 << 17


def zstd_frame(data) -> List:
    """``data`` (bytes or a uint8 array) as one zstd frame, in pieces to
    write one after another: the header tensorstore writes (no content
    size, no checksum; a 128 KiB window), then each 128 KiB block stored
    raw, or run-length where it is one byte repeated."""
    data = memoryview(np.frombuffer(data, np.uint8))
    pieces: List = [b"\x28\xb5\x2f\xfd\x00\x38"]
    n = len(data)
    for start in range(0, max(n, 1), ZSTD_BLOCK):
        block = data[start:start + ZSTD_BLOCK]
        size, last = len(block), int(start + ZSTD_BLOCK >= n)
        arr = np.frombuffer(block, np.uint8)
        if size > 1 and (arr == arr[0]).all():
            pieces.append((size << 3 | 2 | last).to_bytes(3, "little")
                          + bytes(block[:1]))
        else:
            pieces += [(size << 3 | last).to_bytes(3, "little"), block]
    return pieces


def _read_file_table(cur: _Cursor) -> List[str]:
    """A data-file table: paths prefix-coded against the one before."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)              # each path's base-path length
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError("ocdbt: corrupt data-file table")
        prev = prev[:p] + cur.take(s)
        paths.append(prev.decode())
    return paths


def _write_file_table(paths: List[str]) -> bytes:
    return (_varint(len(paths)) + b"".join(_varint(0) for _ in paths[1:])
            + b"".join(_varint(len(p.encode())) for p in paths)
            + b"".join(_varint(0) for _ in paths)
            + b"".join(p.encode() for p in paths))


def _file_of(files: List[str], i: int) -> str:
    if i >= len(files):
        raise ValueError("ocdbt: a data-file index past its table")
    return files[i]


def _keys(cur: _Cursor, n: int, common: bool = False):
    """``n`` prefix-coded keys (and, in an interior node, the length of
    each subtree's common key prefix)."""
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    subtree = cur.varints(n) if common else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError("ocdbt: corrupt key prefix")
        prev = prev[:p] + cur.take(s)
        keys.append(prev)
    return keys, subtree


def _close_all(fds: Dict[str, int]) -> None:
    for fd in fds.values():
        os.close(fd)
    fds.clear()


class OcdbtStore:
    """The newest version of the OCDBT store under ``root`` as a
    ``{key: bytes}`` view: ``keys()`` lists it, ``read(key)`` fetches one
    value (inline in its B-tree leaf, or a byte range of a data file).
    Each data file is opened once and kept open until ``close()`` (or the
    end of a ``with`` block)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._fds: Dict[str, int] = {}
        weakref.finalize(self, _close_all, self._fds)
        with open(os.path.join(self.root, "manifest.ocdbt"), "rb") as f:
            body = _open_envelope(f.read(), MANIFEST_MAGIC)
        cur = _Cursor(body)
        cur.take(16)                                    # the store's uuid
        if cur.varint() != 0:
            raise ValueError("ocdbt: only single-file manifests are read")
        cur.varint()                                    # max inline bytes
        cur.varint()                                    # max node bytes
        cur.u8()                                        # version tree arity
        if cur.varint() == 1:
            cur.take(4)                                 # zstd level
        files = _read_file_table(cur)
        n = cur.varint()                                # inline versions
        self._values: Dict[bytes, object] = {}
        self._scratch: Dict[int, np.ndarray] = {}
        if n == 0:
            return
        generation = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        file_id, offset, length = (cur.varints(n) for _ in range(3))
        # the newest version is the last inline one
        i = max(range(n), key=generation.__getitem__)
        if offset[i] != NULL_OFFSET:
            self._walk((_file_of(files, file_id[i]), offset[i], length[i]),
                       height[i], b"")

    def _fd(self, rel: str) -> int:
        if rel not in self._fds:
            if os.path.isabs(rel) or ".." in rel.split("/"):
                raise ValueError(f"ocdbt: data file outside the store: "
                                 f"{rel!r}")
            self._fds[rel] = os.open(os.path.join(self.root, rel),
                                     os.O_RDONLY)
        return self._fds[rel]

    def close(self) -> None:
        _close_all(self._fds)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def scratch(self, slot: int, n: int) -> np.ndarray:
        """``n`` bytes of a buffer that the next call for ``slot`` reuses:
        the reader's chunks pass through two, so that a read touches fresh
        memory once, in the array it fills."""
        buf = self._scratch.get(slot)
        if buf is None or buf.size < n:
            buf = self._scratch[slot] = np.empty(n, np.uint8)
        return buf[:n]

    def _read_range(self, ref: Tuple[str, int, int],
                    slot: Optional[int] = None) -> np.ndarray:
        rel, offset, length = ref
        data = np.empty(length, np.uint8) if slot is None \
            else self.scratch(slot, length)
        fd, view, got = self._fd(rel), memoryview(data), 0
        while got < length:
            n = os.preadv(fd, [view[got:]], offset + got)
            if n == 0:
                raise ValueError(f"ocdbt: {rel} is truncated")
            got += n
        return data

    def _walk(self, ref, height: int, prefix: bytes) -> None:
        cur = _Cursor(_open_envelope(bytes(self._read_range(ref)),
                                     BTREE_MAGIC))
        if cur.u8() != height:
            raise ValueError("ocdbt: B-tree node height mismatch")
        files = _read_file_table(cur)
        n = cur.varint()
        if height == 0:
            keys, _ = _keys(cur, n)
            lengths = cur.varints(n)
            kinds = cur.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            ids = cur.varints(len(indirect))
            offsets = cur.varints(len(indirect))
            refs = {i: (_file_of(files, d), o, lengths[i])
                    for i, d, o in zip(indirect, ids, offsets)}
            for i, key in enumerate(keys):
                if kinds[i] not in (0, 1):
                    raise ValueError("ocdbt: unknown value kind")
                self._values[prefix + key] = refs[i] if kinds[i] \
                    else cur.take(lengths[i])
            return
        keys, subtree = _keys(cur, n, common=True)
        ids, offsets, lengths = (cur.varints(n) for _ in range(3))
        for i, key in enumerate(keys):
            self._walk((_file_of(files, ids[i]), offsets[i], lengths[i]),
                       height - 1, prefix + key[:subtree[i]])

    def keys(self) -> List[str]:
        return [k.decode() for k in self._values]

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str, slot: Optional[int] = None):
        """The value: ``bytes``, or a writable uint8 array when it lies in
        a data file (with ``slot``, in that scratch buffer, valid until its
        next use)."""
        value = self._values[key.encode()]
        return value if isinstance(value, bytes) \
            else self._read_range(value, slot)


# ---- zarr v2 arrays ----

def _numpy_dtype(name: str) -> np.dtype:
    """The storage dtype of a zarr dtype string (``bfloat16`` as its bits)."""
    return np.dtype("<u2") if name == "bfloat16" else np.dtype(name)


def _fill(value):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return value


def read_array(store: OcdbtStore, name: str) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``store``: its chunks (zstd or raw,
    C or F order) assembled, the missing ones filled with its fill value,
    cropped to the array's shape."""
    meta = json.loads(bytes(store.read(f"{name}/.zarray")))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: not a zarr v2 array")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor} is not read")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters are not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    stored = _numpy_dtype(meta["dtype"])
    native = stored.newbyteorder("=")
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, native)
    for cell in np.ndindex(*[-(-s // c) for s, c in zip(shape, chunks)]):
        key = f"{name}/" + (sep.join(map(str, cell)) if cell else "0")
        box = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(cell, chunks, shape))
        if key not in store:
            out[box] = _fill(meta.get("fill_value"))
            continue
        raw = store.read(key, slot=0)
        if compressor is not None:
            size = _chunk_bytes(chunks, stored)
            raw = zstd.decompress_to(raw, store.scratch(1, size))
        block = _chunk(raw, stored, chunks, order, key, meta)
        out[box] = block[tuple(slice(0, b.stop - b.start) for b in box)]
    tensor = torch.from_numpy(out)
    return tensor.view(torch.bfloat16) if meta["dtype"] == "bfloat16" \
        else tensor


def _chunk_bytes(chunks, stored: np.dtype) -> int:
    return int(np.prod(chunks, dtype=np.int64)) * stored.itemsize


def _chunk(raw, stored: np.dtype, chunks, order: str, key: str, meta):
    if len(raw) != _chunk_bytes(chunks, stored):
        raise ValueError(f"{key}: {len(raw)} bytes for a chunk of "
                         f"{list(chunks)} {meta['dtype']}")
    return np.frombuffer(raw, stored).reshape(chunks, order=order)


# ---- the tree ----

def is_checkpoint_dir(path: str) -> bool:
    """True for an orbax checkpoint directory (one holding ``_METADATA``
    and an OCDBT manifest)."""
    return os.path.isfile(os.path.join(path, "_METADATA")) and \
        os.path.isfile(os.path.join(path, "manifest.ocdbt"))


def load_tree(path: str, top: Optional[Iterable[str]] = None):
    """The nested tree of the orbax checkpoint directory ``path``: dicts,
    lists where the keys are sequence indices, torch tensor leaves, and
    None for an empty optax state.  With ``top``, only the entries under
    those top-level keys are read."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT checkpoints of zarr v2 arrays "
                         f"are read")
    root: Dict = {}
    lists = set()
    with OcdbtStore(path) as store:
        for entry in meta["tree_metadata"].values():
            keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
            if top is not None and keys[0][0] not in top:
                continue
            value = entry["value_metadata"]
            if value["value_type"] == "None" or \
                    value.get("skip_deserialize"):
                leaf = None
            elif value["value_type"] in ("np.ndarray", "jax.Array", "scalar"):
                leaf = read_array(store, ".".join(k for k, _ in keys))
            else:
                raise ValueError(f"{path}: leaf type "
                                 f"{value['value_type']!r} is not read")
            node = root
            for depth, (key, _) in enumerate(keys[:-1]):
                if keys[depth + 1][1] == 1:
                    lists.add(tuple(k for k, _ in keys[:depth + 1]))
                node = node.setdefault(key, {})
            if keys[0][1] == 1:
                lists.add(())
            node[keys[-1][0]] = leaf
    return _as_lists(root, (), lists)


def _as_lists(node, path, lists):
    if not isinstance(node, dict):
        return node
    out = {k: _as_lists(v, path + (k,), lists) for k, v in node.items()}
    if path in lists:
        return [out[k] for k in sorted(out, key=int)]
    return out


def _flatten(tree, path=()) -> Iterable[Tuple[Tuple, object]]:
    """((key, key_type) ..., leaf) pairs of a nested dict / list tree, as
    orbax keys them: a named tuple (an optax state) by its fields, an
    empty container as a None leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = dict(zip(tree._fields, tree))
    if isinstance(tree, (dict, list, tuple)) and not tree:
        yield path, None
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + ((str(k), 2),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + ((str(i), 1),))
    else:
        yield path, tree


def _zarr_leaf(value) -> Tuple[np.ndarray, str]:
    """(C-ordered little-endian array, zarr dtype string)."""
    if torch.is_tensor(value):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return value.contiguous().view(torch.uint16).numpy(), "bfloat16"
        value = value.numpy()
    arr = np.asarray(value)
    if arr.dtype.kind not in "biuf":
        raise TypeError(f"cannot write a {arr.dtype} leaf")
    arr = np.asarray(arr, order="C").astype(arr.dtype.newbyteorder("<"),
                                            copy=False)
    return arr, arr.dtype.str


def save_tree(path: str, tree) -> None:
    """Write ``tree`` (nested dicts / lists of tensors, numpy arrays,
    numbers or None) as an orbax checkpoint directory at ``path``, which
    must not exist: ``_CHECKPOINT_METADATA``, ``_METADATA`` and an OCDBT
    store of zarr v2 arrays in one data file, after which comes the single
    B-tree leaf.  Each array is one chunk, as orbax chunks an unsharded
    array, and each chunk a zstd frame (``zstd_frame``), as orbax's
    compressor setting ``{"id": "zstd", "level": 1}`` says."""
    os.makedirs(path)
    now = time.time_ns()
    data_name = f"d/{uuid.uuid4().hex}"
    os.makedirs(os.path.join(path, "d"))
    # each value: the pieces to write one after another
    values: Dict[bytes, List] = {}
    tree_meta = {}
    for keys, leaf in _flatten(tree):
        names = tuple(k for k, _ in keys)
        key_meta = [{"key": k, "key_type": t} for k, t in keys]
        if leaf is None:
            tree_meta[str(names)] = {
                "key_metadata": key_meta,
                "value_metadata": {"value_type": "None",
                                   "skip_deserialize": True}}
            continue
        arr, dtype = _zarr_leaf(leaf)
        name = ".".join(names)
        zarray = {"chunks": list(arr.shape),
                  "compressor": {"id": "zstd", "level": 1},
                  "dimension_separator": ".", "dtype": dtype,
                  "fill_value": None, "filters": None, "order": "C",
                  "shape": list(arr.shape), "zarr_format": 2}
        values[f"{name}/.zarray".encode()] = [json.dumps(
            zarray, sort_keys=True, separators=(",", ":")).encode()]
        chunk = ".".join("0" for _ in arr.shape) or "0"
        values[f"{name}/{chunk}".encode()] = zstd_frame(arr.reshape(-1))
        tree_meta[str(names)] = {
            "key_metadata": key_meta,
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}

    keys = sorted(values)
    lengths = {k: sum(len(p) for p in v) for k, v in values.items()}
    offsets: Dict[bytes, int] = {}
    indirect_bytes = 0
    with open(os.path.join(path, data_name), "wb") as f:
        for k in keys:
            if lengths[k] > MAX_INLINE_VALUE_BYTES:
                offsets[k] = indirect_bytes
                f.writelines(values[k])
                indirect_bytes += lengths[k]
        node = _leaf_node(keys, values, lengths, offsets, data_name)
        f.write(node)
    if len(node) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"{path}: {len(keys)} keys do not fit one B-tree "
                         f"leaf")
    manifest = (uuid.uuid4().bytes + _varint(0)
                + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES) + bytes([4])
                + _varint(1) + struct.pack("<i", 0)         # zstd, level 0
                + _write_file_table([data_name]) + _varint(1)
                + _varint(1) + bytes([0]) + _varint(0)
                + _varint(indirect_bytes) + _varint(len(node))
                + _varint(len(keys)) + _varint(len(node))
                + _varint(indirect_bytes) + struct.pack("<Q", now)
                + _varint(0))
    with open(os.path.join(path, "manifest.ocdbt"), "wb") as f:
        f.write(_envelope(manifest, MANIFEST_MAGIC))
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    _write_checkpoint_metadata(path, HANDLER, now)


def _leaf_node(keys: List[bytes], values: Dict[bytes, List],
               lengths: Dict[bytes, int], offsets: Dict[bytes, int],
               data_name: str) -> bytes:
    prefix, prev = [], b""
    for k in keys:
        n = 0
        while n < min(len(k), len(prev)) and k[n] == prev[n]:
            n += 1
        prefix.append(n)
        prev = k
    indirect = [k for k in keys if k in offsets]
    body = (bytes([0]) + _write_file_table([data_name] if indirect else [])
            + _varint(len(keys))
            + b"".join(_varint(p) for p in prefix[1:])
            + b"".join(_varint(len(k) - p) for k, p in zip(keys, prefix))
            + b"".join(k[p:] for k, p in zip(keys, prefix))
            + b"".join(_varint(lengths[k]) for k in keys)
            + b"".join(_varint(1 if k in offsets else 0) for k in keys)
            + b"".join(_varint(0) for _ in indirect)
            + b"".join(_varint(offsets[k]) for k in indirect)
            + b"".join(bytes(p) for k in keys if k not in offsets
                       for p in values[k]))
    return _envelope(body, BTREE_MAGIC)


def _write_checkpoint_metadata(path: str, handlers, now: int) -> None:
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": handlers, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)


def save_step(directory: str, step: int, tree) -> str:
    """Write ``tree`` as step ``step`` of a ``CheckpointManager``
    directory (``<directory>/<step>/default``, the step's
    ``_CHECKPOINT_METADATA`` beside it); returns the step directory."""
    step_dir = os.path.join(directory, str(step))
    save_tree(os.path.join(step_dir, "default"), tree)
    _write_checkpoint_metadata(step_dir, {"default": HANDLER}, time.time_ns())
    return step_dir
