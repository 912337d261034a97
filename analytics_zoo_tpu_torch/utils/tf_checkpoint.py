"""A reader for TensorFlow's tensor-bundle checkpoints, without TensorFlow.

The port's stand-in for `tf.train.load_checkpoint`, which the JAX
package's `models/bert.load_tf_checkpoint` calls (a Google BERT checkpoint
is a TF1 bundle). A bundle is two kinds of file beside one prefix:

- `<prefix>.index`: a sorted string table in LevelDB's format. Data blocks
  of prefix-compressed entries (shared key bytes, unshared key bytes and
  value length as varints, then the key's tail and the value), each block
  followed by a 5-byte trailer (a compression type byte and the masked
  CRC32C of the block and that byte), an index block whose values are the
  data blocks' handles (offset and size as varints), and a 48-byte footer
  (the meta-index and index handles, zero padding, the magic number
  0xdb4775248b80fb57). TF writes the table uncompressed; any other type
  byte raises.
- `<prefix>.data-NNNNN-of-MMMMM`: the tensors' bytes, shard by shard.

The index maps the empty key to a `BundleHeaderProto` (shard count,
endianness) and every tensor's name to a `BundleEntryProto` (dtype, shape,
shard, offset, size and the masked CRC32C of its bytes). The few protobuf
fields needed are decoded by hand, with `utils/tensorboard.py`'s wire
helpers. A tensor's bytes are read only when it is asked for, and checked
against their CRC: a checkpoint holds entries the model never asks for
(`global_step`, the Adam slots `*/adam_m` and `*/adam_v`), and those are
never read.

Errors: a name the checkpoint lacks raises KeyError; a dtype the reader
does not take (strings, resources, quantized types) or a partitioned
(sliced) entry raises TypeError; a file that is not a bundle raises
ValueError; a checksum that does not match raises `DataLossError`, a
ValueError.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from analytics_zoo_tpu_torch.utils.crc import masked_crc32c
from analytics_zoo_tpu_torch.utils.tensorboard import (_iter_fields,
                                                        _read_varint)

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48          # two block handles padded to 40, the magic
_NO_COMPRESSION = 0

# TF's DataType enum -> numpy dtype. bfloat16 (14) is read as float32
# (exact: its 16 bits are a float32's upper half); numpy has no bfloat16.
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
           14: "bfloat16", 17: np.uint16, 19: np.float16, 22: np.uint32,
           23: np.uint64}
_DTYPE_NAMES = {7: "DT_STRING", 8: "DT_COMPLEX64", 18: "DT_COMPLEX128",
                20: "DT_RESOURCE", 21: "DT_VARIANT"}


class DataLossError(ValueError):
    """A block or a tensor whose bytes do not match their checksum."""


class Entry(NamedTuple):
    dtype: int
    shape: Tuple[int, ...]
    shard: int
    offset: int
    size: int
    crc: int
    sliced: bool


def _block(data: bytes, offset: int, size: int, what: str) -> bytes:
    """One table block, its trailer checked."""
    end = offset + size
    if end + 5 > len(data):
        raise ValueError(f"{what}: block [{offset}, {end}) runs past the "
                         "end of the index file")
    contents = data[offset:end]
    kind = data[end]
    if kind != _NO_COMPRESSION:
        raise ValueError(f"{what}: block compression type {kind}; TF "
                         "writes bundle indexes uncompressed (type 0)")
    (stored,) = struct.unpack_from("<I", data, end + 1)
    if masked_crc32c(contents + bytes([kind])) != stored:
        raise DataLossError(f"{what}: block at {offset} fails its CRC")
    return contents


def _block_entries(block: bytes) -> List[Tuple[bytes, bytes]]:
    """(key, value) pairs of a block, prefix compression undone."""
    if len(block) < 4:
        raise ValueError("index block shorter than its restart count")
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 * (n_restarts + 1)
    if limit < 0:
        raise ValueError("index block restart array overruns the block")
    out, key, off = [], b"", 0
    while off < limit:
        shared, off = _read_varint(block, off)
        unshared, off = _read_varint(block, off)
        vlen, off = _read_varint(block, off)
        if shared > len(key) or off + unshared + vlen > limit:
            raise ValueError("corrupt index block entry")
        key = key[:shared] + block[off:off + unshared]
        off += unshared
        out.append((key, block[off:off + vlen]))
        off += vlen
    return out


def _handle(buf: bytes, off: int = 0) -> Tuple[int, int, int]:
    """(offset, size, next offset) of a varint-encoded block handle."""
    offset, off = _read_varint(buf, off)
    size, off = _read_varint(buf, off)
    return offset, size, off


def _read_table(path: str) -> Dict[bytes, bytes]:
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < FOOTER_BYTES:
        raise ValueError(f"{path}: too short for a table footer")
    footer = data[-FOOTER_BYTES:]
    (magic,) = struct.unpack_from("<Q", footer, FOOTER_BYTES - 8)
    if magic != TABLE_MAGIC:
        raise ValueError(f"{path}: not a TF bundle index (magic "
                         f"{magic:#x})")
    _, _, off = _handle(footer)                     # meta-index: unused
    idx_off, idx_size, _ = _handle(footer, off)
    table: Dict[bytes, bytes] = {}
    for _, handle in _block_entries(_block(data, idx_off, idx_size, path)):
        offset, size, _ = _handle(handle)
        table.update(_block_entries(_block(data, offset, size, path)))
    return table


def _shape(buf: bytes) -> Tuple[int, ...]:
    dims = []
    for field, wire, value in _iter_fields(buf):
        if field == 2 and wire == 2:                # repeated Dim
            size = 0
            for f2, w2, v2 in _iter_fields(value):
                if f2 == 1 and w2 == 0:
                    size = v2
            dims.append(size)
        elif field == 3 and wire == 0 and value:
            raise ValueError("checkpoint tensor of unknown rank")
    return tuple(dims)


def _entry(buf: bytes) -> Entry:
    dtype = shard = offset = size = crc = 0
    shape: Tuple[int, ...] = ()
    sliced = False
    for field, wire, value in _iter_fields(buf):
        if field == 1 and wire == 0:
            dtype = value
        elif field == 2 and wire == 2:
            shape = _shape(value)
        elif field == 3 and wire == 0:
            shard = value
        elif field == 4 and wire == 0:
            offset = value
        elif field == 5 and wire == 0:
            size = value
        elif field == 6 and wire == 5:
            (crc,) = struct.unpack("<I", value)
        elif field == 7:
            sliced = True
    return Entry(dtype, shape, shard, offset, size, crc, sliced)


def _header(buf: bytes) -> Tuple[int, int]:
    """(shard count, endianness: 0 little, 1 big)."""
    shards, endian = 1, 0
    for field, wire, value in _iter_fields(buf):
        if field == 1 and wire == 0:
            shards = value
        elif field == 2 and wire == 0:
            endian = value
    return shards, endian


def _resolve_prefix(path: str) -> str:
    """A bundle prefix, a directory holding a `checkpoint` state file (its
    `model_checkpoint_path`), or a prefix's `.index` file."""
    if os.path.isdir(path):
        state = os.path.join(path, "checkpoint")
        if not os.path.exists(state):
            raise FileNotFoundError(f"{path}: no `checkpoint` file in the "
                                    "directory; pass the bundle prefix")
        with open(state) as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key.strip() == "model_checkpoint_path":
                    name = value.strip().strip('"')
                    return name if os.path.isabs(name) \
                        else os.path.join(path, name)
        raise ValueError(f"{state}: no model_checkpoint_path")
    if path.endswith(".index"):
        path = path[:-len(".index")]
    if not os.path.exists(path + ".index"):
        raise FileNotFoundError(f"no TF checkpoint at {path} "
                                f"({path}.index is missing)")
    return path


class CheckpointReader:
    """`tf.train.load_checkpoint`'s reader over one bundle."""

    def __init__(self, path: str):
        self.prefix = _resolve_prefix(path)
        table = _read_table(self.prefix + ".index")
        header = table.pop(b"", None)
        self.num_shards, endian = _header(header or b"")
        if endian != 0:
            raise ValueError(f"{self.prefix}: big-endian bundle; only "
                             "little-endian bundles are read")
        self._entries = {k.decode("utf-8"): v for k, v in table.items()}

    def _get_entry(self, name: str) -> Entry:
        if name not in self._entries:
            raise KeyError(f"{name} not found in checkpoint {self.prefix}")
        return _entry(self._entries[name])

    def has_tensor(self, name: str) -> bool:
        return name in self._entries

    def get_variable_to_shape_map(self) -> Dict[str, List[int]]:
        return {name: list(_entry(v).shape)
                for name, v in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        """The named tensor as a numpy array (bfloat16 as float32)."""
        e = self._get_entry(name)
        if e.sliced:
            raise TypeError(f"{name}: a partitioned (sliced) entry; the "
                            "reader takes whole tensors only")
        kind = _DTYPES.get(e.dtype)
        if kind is None:
            raise TypeError(
                f"{name}: dtype {_DTYPE_NAMES.get(e.dtype, e.dtype)} is not "
                "read by the port (numeric and bool tensors only)")
        np_dtype = np.dtype(np.uint16 if kind == "bfloat16" else kind)
        count = int(np.prod(e.shape, dtype=np.int64))
        if e.size != count * np_dtype.itemsize:
            raise ValueError(f"{name}: {e.size} bytes for shape {e.shape} "
                             f"of {np_dtype}")
        shard = (f"{self.prefix}.data-{e.shard:05d}-of-"
                 f"{self.num_shards:05d}")
        with open(shard, "rb") as fh:
            fh.seek(e.offset)
            raw = fh.read(e.size)
        if len(raw) != e.size:
            raise DataLossError(f"{name}: {shard} ends before the tensor")
        if masked_crc32c(raw) != e.crc:
            raise DataLossError(f"{name}: checksum mismatch in {shard}")
        arr = np.frombuffer(raw, np_dtype).reshape(e.shape)
        if kind == "bfloat16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.copy()


def load_checkpoint(path: str) -> CheckpointReader:
    """`tf.train.load_checkpoint`: a reader over the bundle at `path` (a
    prefix, or a directory with a `checkpoint` state file)."""
    return CheckpointReader(path)
