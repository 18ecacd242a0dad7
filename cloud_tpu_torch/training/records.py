"""Streaming record input pipeline (port of ``cloud_tpu/training/records.py``).

The at-scale analogue of tf.data + TFRecord: files are the unit of host
sharding, decode happens on the host CPU, and a background prefetcher
keeps the copy to the card ahead of the train step, so the card never
waits on the host.  Files written here and by the JAX package are the
same bytes for the same payloads.

Three layers, each usable alone:

* **Wire framing** — ``RecordWriter`` / ``read_records`` speak the TFRecord
  format (u64 length + masked crc32c, then payload + masked crc32c), so
  files written here load in ``tf.data.TFRecordDataset`` and reference
  TFRecord files stream here, without TensorFlow installed.
* **Codecs** — ``encode_tensor_record``/``decode_tensor_record`` (npz-framed
  dict-of-arrays; the fast native path) and ``encode_example``/
  ``decode_example`` (a hand-rolled ``tf.train.Example`` protobuf subset:
  bytes/float/int64 lists — enough to parse the reference's datasets).
* **Pipeline** — ``RecordDataset`` (per-host file shards by the rank and
  world size of ``torch.distributed`` when it is initialized, else host 0
  of 1; shuffle buffer, batching; the zero-arg-callable contract
  ``Trainer.fit`` expects) and ``prefetch_to_device`` (background thread
  overlapping host decode + transfer with device compute — owned by
  ``training.pipeline_io``, re-exported here).

Paths are local (glob patterns supported).  ``gs://`` paths raise
``NotImplementedError``: they come with the cloud layers (ROADMAP.md
A.6).
"""

from __future__ import annotations

import glob as glob_lib
import io
import itertools
import logging
import os
import struct
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — required by the TFRecord framing.  Hot path lives
# in the native library (training/cpp/records_native.cc, slicing-by-8,
# ctypes-bound, built lazily); the pure-Python table fallback keeps the
# format usable when no toolchain exists.
# ---------------------------------------------------------------------------

_CRC_POLY = 0x82F63B78
_CRC_TABLE: Optional[List[int]] = None

_CPP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
_LIB_NAME = "libcloud_tpu_torch_records.so"
_native_lib = None
_native_tried = False
_native_lock = threading.Lock()


def _native():
    """Load (building if stale) the native records library via the shared
    loader; None if that fails (pure-Python paths take over)."""
    global _native_lib, _native_tried
    if _native_tried:
        return _native_lib
    with _native_lock:
        if _native_tried:
            return _native_lib
        import ctypes

        from cloud_tpu_torch.utils.native import load_native_lib

        lib = load_native_lib(_CPP_DIR, _LIB_NAME,
                              what="native records hot path")
        if lib is not None:
            lib.ctpu_records_crc32c.restype = ctypes.c_uint32
            lib.ctpu_records_crc32c.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64
            ]
            lib.ctpu_records_masked_crc32c.restype = ctypes.c_uint32
            lib.ctpu_records_masked_crc32c.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64
            ]
            lib.ctpu_records_scan.restype = ctypes.c_int64
            lib.ctpu_records_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int32),
            ]
        _native_lib = lib
        _native_tried = True
        return _native_lib


def _table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (_CRC_POLY if c & 1 else 0)
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_python(data: bytes) -> int:
    table = _table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    lib = _native()
    if lib is not None:
        return lib.ctpu_records_crc32c(data, len(data))
    return _crc32c_python(data)


def masked_crc32c(data: bytes) -> int:
    """TFRecord's rotated+offset crc (format spec: tensorflow
    core/lib/hash/crc32c.h)."""
    lib = _native()
    if lib is not None:
        return lib.ctpu_records_masked_crc32c(data, len(data))
    crc = _crc32c_python(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Wire framing
# ---------------------------------------------------------------------------


_GCS_LATER = ("record files on gs:// are not ported yet: they come with the "
              "cloud layers (ROADMAP.md A.6)")


def _refuse_gcs(path: str) -> None:
    if path.startswith("gs://"):
        raise NotImplementedError(f"{path}: {_GCS_LATER}")


class RecordWriter:
    """Writes TFRecord-framed records to one local file."""

    def __init__(self, path: str):
        _refuse_gcs(path)
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._file = open(path, "wb")

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", masked_crc32c(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", masked_crc32c(payload)))

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


#: Refill size for the native read path — bounds peak memory at roughly
#: one chunk (+ one in-flight record) regardless of file size.
_SCAN_CHUNK_BYTES = 8 * 1024 * 1024


def _scan_records_native(f, path: str, verify: bool):
    """Stream frames from file-like ``f`` via the native batch scanner:
    read a chunk, parse every complete frame in ONE C call per 4096
    records (crc verification included), keep the partial tail for the
    next refill.  Constant memory in the file size; records larger than
    the chunk grow the buffer only until their frame completes.

    Error parity with the Python framing loop: frames scanned before a
    corruption are yielded first, then the error raises.
    """
    import ctypes

    lib = _native()
    batch = 4096
    offsets = (ctypes.c_uint64 * batch)()
    lengths = (ctypes.c_uint64 * batch)()
    consumed = ctypes.c_uint64()
    status = ctypes.c_int32()
    buf = bytearray()
    eof = False
    while True:
        if not eof:
            chunk = f.read(_SCAN_CHUNK_BYTES)
            if chunk:
                buf += chunk
            else:
                eof = True
        pos = 0
        # from_buffer: a pointer into the bytearray, no copy.  The buffer
        # is not resized while scanning this fill.  The export object is
        # held in a named variable and dropped explicitly below — the
        # tail-trim resize would raise BufferError while any export is
        # alive, and relying on CPython refcounting to collect an
        # anonymous temporary is not a portable guarantee.
        anchor = ctypes.c_char.from_buffer(buf) if buf else None
        base = ctypes.addressof(anchor) if anchor is not None else 0
        # One memoryview per fill, released before the tail-trim below (a
        # live export blocks bytearray resizing); slicing the view keeps
        # payload extraction at ONE copy instead of bytearray-slice + bytes.
        view = memoryview(buf) if buf else None
        try:
            while pos < len(buf):
                count = lib.ctpu_records_scan(
                    ctypes.c_void_p(base + pos), len(buf) - pos,
                    1 if verify else 0, offsets, lengths,
                    batch, ctypes.byref(consumed), ctypes.byref(status),
                )
                for i in range(count):
                    start = pos + offsets[i]
                    yield bytes(view[start:start + lengths[i]])
                if status.value == 1:
                    raise ValueError(f"corrupt record length crc in {path}")
                if status.value == 2:
                    raise ValueError(
                        f"corrupt record payload crc in {path}"
                    )
                pos += consumed.value
                if consumed.value == 0:
                    break  # partial frame — refill (or truncated at EOF)
        finally:
            if view is not None:
                view.release()
            del anchor  # drop the ctypes buffer export before resizing
        if pos:
            del buf[:pos]  # keep only the partial tail
        if eof:
            if buf:
                raise ValueError(f"truncated record in {path}")
            return


def read_records(path: str, *, verify: bool = False) -> Iterator[bytes]:
    """Stream raw record payloads from one TFRecord-framed file.

    With the native library available, frames are parsed and
    crc-verified by the batched C scanner over fixed-size refills
    (constant memory); the framing-loop fallback streams record by
    record in Python.
    """
    _refuse_gcs(path)
    f = open(path, "rb")
    if _native() is not None:
        try:
            yield from _scan_records_native(f, path, verify)
        finally:
            f.close()
        return
    try:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise ValueError(f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header)
            header_crc_bytes = f.read(4)
            if len(header_crc_bytes) != 4:
                raise ValueError(f"truncated record header crc in {path}")
            (header_crc,) = struct.unpack("<I", header_crc_bytes)
            if verify and masked_crc32c(header) != header_crc:
                raise ValueError(f"corrupt record length crc in {path}")
            payload = f.read(length)
            if len(payload) != length:
                raise ValueError(f"truncated record payload in {path}")
            payload_crc_bytes = f.read(4)
            if len(payload_crc_bytes) != 4:
                raise ValueError(f"truncated record payload crc in {path}")
            (payload_crc,) = struct.unpack("<I", payload_crc_bytes)
            if verify and masked_crc32c(payload) != payload_crc:
                raise ValueError(f"corrupt record payload crc in {path}")
            yield payload
    finally:
        f.close()


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


_TENSOR_MAGIC = b"CTR1"


def encode_tensor_record(tensors: Dict[str, np.ndarray]) -> bytes:
    """Native codec: one record = one example as a dict of arrays.

    Wire layout: magic, then a JSON header (name -> [dtype, shape]) length-
    prefixed, then each array's raw bytes in header order.  Chosen over
    npz because np.savez routes through zipfile — ~0.3 ms per example,
    which caps a streaming pipeline at ~3k examples/s; this framing
    decodes via zero-copy ``np.frombuffer`` an order of magnitude faster.
    """
    import json as json_lib

    header = {}
    chunks = []
    for name, value in tensors.items():
        # np.asarray, not ascontiguousarray: the latter promotes 0-d
        # scalars to shape (1,).  tobytes() already emits C order.
        arr = np.asarray(value)
        header[name] = [arr.dtype.str, list(arr.shape)]
        chunks.append(arr.tobytes())
    header_bytes = json_lib.dumps(header).encode()
    return b"".join(
        [_TENSOR_MAGIC, struct.pack("<I", len(header_bytes)), header_bytes]
        + chunks
    )


def decode_tensor_record(payload: bytes) -> Dict[str, np.ndarray]:
    import json as json_lib

    if payload[:4] != _TENSOR_MAGIC:
        # Back-compat: npz-framed records from earlier writers.
        with np.load(io.BytesIO(payload)) as npz:
            return {k: npz[k] for k in npz.files}
    (header_len,) = struct.unpack("<I", payload[4:8])
    header = json_lib.loads(payload[8 : 8 + header_len].decode())
    out = {}
    offset = 8 + header_len
    for name, (dtype_str, shape) in header.items():
        dtype = np.dtype(dtype_str)
        count = int(np.prod(shape)) if shape else 1
        out[name] = np.frombuffer(
            payload, dtype, count, offset=offset
        ).reshape(shape)
        offset += count * dtype.itemsize
    return out


# --- tf.train.Example protobuf subset (no TF, no protoc) -------------------
#
# Wire schema (tensorflow/core/example/{example,feature}.proto):
#   Example      { Features features = 1; }
#   Features     { map<string, Feature> feature = 1; }   (map entry: key=1, value=2)
#   Feature      { oneof { BytesList bytes_list = 1; FloatList float_list = 2;
#                          Int64List int64_list = 3; } }
#   BytesList    { repeated bytes value = 1; }
#   FloatList    { repeated float value = 1 [packed = true]; }
#   Int64List    { repeated int64 value = 1 [packed = true]; }


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _encode_feature(values) -> bytes:
    arr = np.asarray(values)
    if arr.dtype.kind in ("S", "U", "O") or isinstance(values, (bytes, str)):
        items = values if isinstance(values, (list, tuple)) else [values]
        body = b"".join(
            _len_delimited(1, v.encode() if isinstance(v, str) else bytes(v))
            for v in items
        )
        return _len_delimited(1, body)  # bytes_list
    if arr.dtype.kind == "f":
        packed = arr.astype("<f4").ravel().tobytes()
        return _len_delimited(2, _len_delimited(1, packed))  # float_list
    if arr.dtype.kind in ("i", "u", "b"):
        body = b"".join(
            _varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in arr.ravel()
        )
        return _len_delimited(3, _len_delimited(1, body))  # int64_list
    raise TypeError(f"unsupported feature dtype: {arr.dtype}")


def encode_example(features: Dict[str, Union[np.ndarray, bytes, str, list]]) -> bytes:
    """Encode a flat feature dict as a serialized ``tf.train.Example``."""
    entries = []
    for name, values in features.items():
        entry = _len_delimited(1, name.encode()) + _len_delimited(
            2, _encode_feature(values)
        )
        entries.append(_len_delimited(1, entry))  # Features.feature map entry
    return _len_delimited(1, b"".join(entries))  # Example.features


def _decode_feature(data: bytes):
    tag, pos = _read_varint(data, 0)
    field = tag >> 3
    length, pos = _read_varint(data, pos)
    body = data[pos : pos + length]
    if field == 1:  # bytes_list
        out = []
        p = 0
        while p < len(body):
            _, p = _read_varint(body, p)  # tag (field 1, wire 2)
            n, p = _read_varint(body, p)
            out.append(body[p : p + n])
            p += n
        return out
    if field == 2:  # float_list (packed)
        p = 0
        floats = []
        while p < len(body):
            t, p = _read_varint(body, p)
            if t & 7 == 2:  # packed
                n, p = _read_varint(body, p)
                floats.append(np.frombuffer(body, "<f4", n // 4, offset=p))
                p += n
            else:  # unpacked single float
                floats.append(np.frombuffer(body, "<f4", 1, offset=p))
                p += 4
        return np.concatenate(floats) if floats else np.zeros(0, "<f4")
    if field == 3:  # int64_list (packed varints)
        p = 0
        ints = []
        while p < len(body):
            t, p = _read_varint(body, p)
            if t & 7 == 2:
                n, p = _read_varint(body, p)
                end = p + n
                while p < end:
                    v, p = _read_varint(body, p)
                    ints.append(v - (1 << 64) if v >> 63 else v)
            else:
                v, p = _read_varint(body, p)
                ints.append(v - (1 << 64) if v >> 63 else v)
        return np.array(ints, np.int64)
    raise ValueError(f"unknown Feature field {field}")


def decode_example(payload: bytes) -> Dict[str, object]:
    """Parse a serialized ``tf.train.Example`` into {name: values}.

    bytes_list -> list[bytes]; float_list -> float32 array; int64_list ->
    int64 array.
    """
    # Unwrap Example.features
    tag, pos = _read_varint(payload, 0)
    if tag >> 3 != 1:
        raise ValueError("not an Example proto")
    length, pos = _read_varint(payload, pos)
    features = payload[pos : pos + length]

    out: Dict[str, object] = {}
    p = 0
    while p < len(features):
        tag, p = _read_varint(features, p)  # map entry (field 1)
        n, p = _read_varint(features, p)
        entry = features[p : p + n]
        p += n
        # entry: key (field 1, string) + value (field 2, Feature)
        ep = 0
        name = None
        value = None
        while ep < len(entry):
            etag, ep = _read_varint(entry, ep)
            en, ep = _read_varint(entry, ep)
            chunk = entry[ep : ep + en]
            ep += en
            if etag >> 3 == 1:
                name = chunk.decode()
            else:
                value = _decode_feature(chunk)
        out[name] = value
    return out


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def _process_shard():
    """This process's (index, count) of the data: under an installed mesh
    (``parallel.use_mesh``), its data coordinate over ``dp`` x ``fsdp``
    and their product (ranks that differ only in ``tp`` or ``sp`` read
    the same files); else the rank and world size of ``torch.distributed``
    when it is initialized; else (0, 1)."""
    import torch.distributed as dist

    from cloud_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.get_global_mesh()
    if mesh is not None:
        index, count = 0, 1
        for axis in (mesh_lib.AXIS_DP, mesh_lib.AXIS_FSDP):
            index = index * mesh.axis_size(axis) + mesh.axis_index(axis)
            count *= mesh.axis_size(axis)
        return index, count
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _list_files(patterns: Sequence[str]) -> List[str]:
    files: List[str] = []
    for pattern in patterns:
        _refuse_gcs(pattern)
        if glob_lib.has_magic(pattern):
            files.extend(sorted(glob_lib.glob(pattern)))
        else:
            if not os.path.exists(pattern):
                # Fail at construction like the glob branch, not from the
                # prefetch thread mid-training.
                raise ValueError(f"record file not found: {pattern}")
            files.append(pattern)
    if not files:
        raise ValueError(f"no record files match {list(patterns)}")
    return sorted(files)


class RecordDataset:
    """Re-iterable batched dataset streaming from record files.

    Sharding: with N hosts (under an installed mesh, ``parallel.use_mesh``,
    the data coordinate over ``dp`` x ``fsdp`` and their product, so ranks
    that differ only in ``tp`` or ``sp`` read the same files; else
    ``torch.distributed``'s rank and world size when it is initialized,
    else 1; or ``process_index``/``process_count``), host i reads files
    ``files[i::N]`` — disjoint shards, no coordination (the tf.data
    ``shard(num_shards, index)`` pattern the reference's input pipelines
    relied on).  When there are fewer files than hosts, records are strided
    instead (host i keeps records where ``record_idx % N == i``), trading
    read amplification for correctness.

    ``decode`` maps a raw payload to a {name: array} example; defaults to
    the native tensor codec.  Batches are stacked along a new leading axis.
    The instance is a zero-arg callable yielding a fresh iterator — the
    ``Trainer.fit`` contract.

    ``decode_threads`` runs decode in an ordered thread pool.  Leave at 0
    (serial) unless your decode RELEASES THE GIL — measured on this repo's
    pure-Python codecs the pool is ~30% slower (GIL-bound decode gains no
    parallelism, pays submit overhead).  The win case is C-backed
    decompression: JPEG/PNG decode, zlib, np-heavy augmentation.

    Resume: shuffle order (file order AND buffer draws) is derived per
    epoch from ``(seed, epoch)``, and ``state_dict()`` /
    ``load_state_dict()`` implement the exactly-once fast-forward
    contract shared with :class:`~cloud_tpu_torch.training.data.ArrayDataset`
    — a restored trainer replays epoch E from its B-th batch with the
    identical stream an uninterrupted run would have produced.  Skipped
    batches are still decoded (the shuffle-buffer state must advance
    identically) but never collated or yielded.
    """

    def __init__(
        self,
        files: Union[str, Sequence[str]],
        batch_size: int,
        *,
        decode: Optional[Callable[[bytes], Dict[str, np.ndarray]]] = None,
        shuffle_buffer: int = 0,
        seed: int = 0,
        drop_remainder: bool = True,
        shard_by_process: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        verify: bool = False,
        decode_threads: int = 0,
    ):
        patterns = [files] if isinstance(files, str) else list(files)
        self.files = _list_files(patterns)
        self.batch_size = batch_size
        self.decode = decode or decode_tensor_record
        self.decode_threads = decode_threads
        self.shuffle_buffer = shuffle_buffer
        self.drop_remainder = drop_remainder
        self.verify = verify
        self.seed = int(seed)
        self._epoch = 0  # epochs issued so far (next __call__ uses this)
        self._skip = 0   # one-shot batch fast-forward for the next epoch
        if shard_by_process:
            if process_index is None or process_count is None:
                process_index, process_count = _process_shard()
        else:
            process_index, process_count = 0, 1
        self.process_index = process_index
        self.process_count = process_count
        if len(self.files) >= self.process_count:
            self.shard_files = self.files[process_index::process_count]
            self._stride_records = False
        else:
            self.shard_files = list(self.files)
            self._stride_records = True

    def _payloads(self, rng: np.random.Generator) -> Iterator[bytes]:
        files = list(self.shard_files)
        # In record-striding mode the keep predicate depends on the GLOBAL
        # record index, which is only consistent across hosts when every
        # host walks the files in the same (canonical) order — shuffling
        # there would silently break shard disjointness for differently
        # seeded hosts.  Shuffling still happens via the example buffer.
        if self.shuffle_buffer and not self._stride_records:
            rng.shuffle(files)
        idx = 0
        for path in files:
            for payload in read_records(path, verify=self.verify):
                keep = (
                    not self._stride_records
                    or idx % self.process_count == self.process_index
                )
                idx += 1
                if keep:
                    yield payload

    def _examples(self, rng: np.random.Generator, payloads=None
                  ) -> Iterator[Dict[str, np.ndarray]]:
        if payloads is None:
            payloads = self._payloads(rng)
        if self.decode_threads <= 0:
            for payload in payloads:
                yield self.decode(payload)
            return
        # Ordered parallel decode: submit up to threads*4 payloads ahead,
        # always yield the oldest future — order (and therefore multi-host
        # determinism) is preserved while decode overlaps file reads.
        import collections
        from concurrent.futures import ThreadPoolExecutor

        inflight: "collections.deque" = collections.deque()
        max_inflight = self.decode_threads * 4
        with ThreadPoolExecutor(max_workers=self.decode_threads) as pool:
            for payload in payloads:
                inflight.append(pool.submit(self.decode, payload))
                if len(inflight) >= max_inflight:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()

    def _shuffled(self, rng: np.random.Generator
                  ) -> Iterator[Dict[str, np.ndarray]]:
        if not self.shuffle_buffer:
            yield from self._examples(rng)
            return
        buf: List[Dict[str, np.ndarray]] = []
        for example in self._examples(rng):
            buf.append(example)
            if len(buf) >= self.shuffle_buffer:
                pick = rng.integers(len(buf))
                buf[pick], buf[-1] = buf[-1], buf[pick]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf

    def state_dict(self) -> Dict[str, int]:
        """Reproducibility state (the trainer records the authoritative
        consumed-batch position; this is the dataset-side complement)."""
        return {"epoch": self._epoch, "seed": self.seed}

    def load_state_dict(self, state: Dict) -> None:
        """Fast-forward: the next iterator produces epoch
        ``state["epoch"]`` with its first ``state["batches_consumed"]``
        batches skipped (positions come from the trainer-boundary count
        a checkpoint recorded, so prefetched-but-unconsumed batches are
        not marked done).  A ``seed`` in the state is ADOPTED (with a
        loud warning on mismatch): the position only names the right
        batches under the shuffle order it was recorded in."""
        saved = state.get("seed")
        if saved is not None and int(saved) != self.seed:
            logger.warning(
                "restored iterator position was recorded under shuffle "
                "seed %s but this dataset was built with seed %d; "
                "adopting the checkpoint's seed so the replayed stream "
                "is the one the position points into", saved, self.seed,
            )
            self.seed = int(saved)
        self._epoch = int(state.get("epoch", 0))
        self._skip = int(state.get("batches_consumed", 0))

    def __call__(self) -> Iterator[Dict[str, np.ndarray]]:
        # Epoch/skip captured eagerly so a prefetcher that builds the
        # iterator without pulling still advances the epoch counter.
        epoch = self._epoch
        self._epoch += 1
        skip, self._skip = self._skip, 0
        return self._iter_epoch(epoch, skip)

    def _iter_epoch(self, epoch: int, skip: int
                    ) -> Iterator[Dict[str, np.ndarray]]:
        # Pipeline throughput producers (default exporter telemetry, like
        # the trainer's MetricsCallback): per-batch counter bumps are a
        # ctypes call each — noise against decode cost — and the
        # examples/sec gauge updates via the shared windowed-rate helper
        # (one window = 32 batches), with the tail flushed at stream end.
        from time import perf_counter

        from cloud_tpu_torch.monitoring import metrics as _metrics

        rate = _metrics.WindowedRate(
            "data/examples_per_sec", 32 * self.batch_size
        )
        rate.restart(perf_counter())

        def account(n: int) -> None:
            _metrics.counter_inc("data/batches")
            _metrics.counter_inc("data/examples", n)
            rate.add(perf_counter(), n)

        # account() runs BEFORE each yield and the flush sits in a
        # finally: a consumer that stops early (steps_per_epoch break,
        # abandoned prefetch) suspends the generator at the yield and
        # GCs it — counting after the yield would drop the last batch
        # and skip the tail flush.
        rng = np.random.default_rng((self.seed, epoch))
        skipped = 0
        if skip and not self.shuffle_buffer:
            # No shuffle-buffer state to advance: fast-forward at the
            # RECORD level instead of the example level.  The framing is
            # still read (crc verify and stride accounting unchanged) but
            # skipped batches are never decoded — at a deep resume point
            # that is the difference between a seek-speed fast-forward
            # and re-decoding hours of JPEG/zlib just to discard it.
            payloads = self._payloads(rng)
            for _ in itertools.islice(payloads, skip * self.batch_size):
                pass  # a stream shorter than the skip yields nothing, as before
            source = self._examples(rng, payloads)
            skipped = skip  # already skipped; the loop below starts live
        else:
            source = self._shuffled(rng)
        try:
            batch: List[Dict[str, np.ndarray]] = []
            for example in source:
                batch.append(example)
                if len(batch) == self.batch_size:
                    if skipped < skip:
                        # Resume fast-forward: the batch was already
                        # consumed by the interrupted run — advance the
                        # stream (shuffle state included) without
                        # collating, accounting, or yielding it.
                        skipped += 1
                        batch = []
                        continue
                    account(self.batch_size)
                    yield self._collate(batch)
                    batch = []
            if batch and not self.drop_remainder:
                if skipped < skip:
                    return
                account(len(batch))
                yield self._collate(batch)
        finally:
            rate.flush(perf_counter())

    @staticmethod
    def _collate(examples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        keys = examples[0].keys()
        return {k: np.stack([e[k] for e in examples]) for k in keys}


def write_records(
    path_template: str,
    examples: Iterator[Dict[str, np.ndarray]],
    *,
    num_shards: int = 1,
    encode: Callable[[Dict[str, np.ndarray]], bytes] = encode_tensor_record,
) -> List[str]:
    """Write examples round-robin into ``num_shards`` TFRecord-framed files.

    ``path_template`` must contain ``{shard}`` when num_shards > 1, e.g.
    ``/data/train-{shard:05d}-of-00004.rec``.
    """
    if num_shards > 1 and "{shard" not in path_template:
        raise ValueError("path_template needs a {shard} placeholder")
    paths = [
        path_template.format(shard=i) if "{shard" in path_template
        else path_template
        for i in range(num_shards)
    ]
    writers = [RecordWriter(p) for p in paths]
    try:
        for i, example in enumerate(examples):
            writers[i % num_shards].write(encode(example))
    finally:
        for w in writers:
            w.close()
    return paths


# The background prefetcher grew up here but serves every input pipeline
# (in-memory arrays, validation, fused multi-step windows), so it now
# lives in ``pipeline_io``; these aliases keep the long-standing import
# path (``records.prefetch_to_device``) working.
from cloud_tpu_torch.training.pipeline_io import (  # noqa: E402,F401 — re-export
    PrefetchIterator as _PrefetchIterator,
    prefetch_to_device,
)
