"""flax's msgpack checkpoint format, written and read without flax or msgpack
(the counterpart of ``flax.serialization`` as horovod_tpu uses it).

Written from flax 0.12.3's ``flax/serialization.py``: ``to_state_dict`` /
``from_state_dict``, ``_ndarray_to_bytes``, ``_msgpack_ext_pack`` /
``_msgpack_ext_unpack``, ``_chunk`` / ``_unchunk``, ``msgpack_serialize``,
``msgpack_restore``.  A tree written here is byte for byte the file
``flax.serialization.to_bytes`` writes for the same tree (numpy leaves on
flax's side, tensors or numpy leaves here), so a checkpoint of either
package restores in the other.

The format:

* the state dict: lists and tuples become maps ``{"0": ..., "1": ...}``,
  a namedtuple a map of its fields, dict keys ``str(k)`` (two keys that
  stringify alike raise); maps keep insertion order;
* msgpack as msgpack-python packs it with ``use_bin_type`` and
  ``strict_types``: nil, bool, the narrowest int form (positive and
  negative fixint, uint8-64, int8-64), a Python float as float64 (float32
  is also read), str, bin, array, map, ext;
* ext 1 is an array: the msgpack of ``(shape, dtype name, C-order
  bytes)``; ext 3 a numpy scalar, the same triple of shape ``()``; ext 2
  a complex number, the msgpack of ``(real, imag)``.  bfloat16 goes by
  the name ``"bfloat16"`` and its 16-bit patterns;
* an array of more than :data:`MAX_CHUNK_SIZE` bytes is written as
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of flat pieces (msgpack's objects end at 2**31 - 1 bytes).

An array's bytes are not copied into the output: :func:`to_pieces` gives
the file as a list of small header buffers and memoryviews of the
arrays, which a writer hands to the file in turn.  Reading copies each
array once into a fresh tensor.  Arrays come back as CPU tensors (a
``torch.bfloat16`` tensor for ``"bfloat16"``), numpy scalars as numpy
scalars (a 0-d tensor for bfloat16).
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

# msgpack's limit is 2**31 - 1 bytes an object; flax leaves a margin.
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# Array dtype names as numpy (and ml_dtypes, for bfloat16) name them.
TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
DTYPE_NAMES = {dt: name for name, dt in TORCH_DTYPES.items()}

# Header bytes up to this size are gathered into one buffer; a larger
# array's bytes stay a memoryview of the array.
_INLINE_BYTES = 4096


# ---------------------------------------------------------------------------
# State dicts (flax's registry for dict, list, tuple and namedtuple)
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_state_dict(x) -> Any:
    """Containers as flax's state dicts: dicts with ``str`` keys, lists
    and tuples as ``{"0": ...}``; leaves unchanged."""
    if _is_namedtuple(x):
        return {k: to_state_dict(getattr(x, k)) for k in x._fields}
    if isinstance(x, dict):
        keys = {str(k) for k in x}
        if len(keys) != len(x):
            raise ValueError(
                "Dict keys do not have a unique string representation: "
                f"{sorted(keys)} vs given: {list(x)}")
        return {str(k): to_state_dict(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(x)}
    return x


def _where(path) -> str:
    return "/".join(path)


def from_state_dict(target, state, leaf=None, path=(".",)) -> Any:
    """``target``'s structure with the values of ``state`` (flax's
    ``from_state_dict``): the target's keys drive the walk, a key it has
    and ``state`` lacks raises naming its path, keys only ``state`` has
    are ignored, lists and tuples must have the stored length.  A leaf
    becomes ``leaf(target_leaf, value, path)``, by default the stored
    value."""
    if _is_namedtuple(target) or isinstance(target, (dict, list, tuple)):
        if not isinstance(state, dict):
            raise ValueError(
                f"the target has a {type(target).__name__} at path "
                f"{_where(path)}, the state dict a "
                f"{type(state).__name__}")
    if _is_namedtuple(target):
        if set(state) != set(target._fields):
            raise ValueError(
                "The field names of the state dict and the named tuple do "
                f"not match, got {set(state)} and {set(target._fields)} at "
                f"path {_where(path)}")
        return type(target)(**{
            k: from_state_dict(getattr(target, k), state[k], leaf,
                               path + (k,)) for k in target._fields})
    if isinstance(target, dict):
        missing = {str(k) for k in target} - set(state)
        if missing:
            raise ValueError(
                "The target dict keys and state dict keys do not match, "
                f"target dict contains keys {missing} which are not present "
                f"in state dict at path {_where(path)}")
        return {k: from_state_dict(v, state[str(k)], leaf, path + (str(k),))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(
                "The size of the list and the state dict do not match, got "
                f"{len(target)} and {len(state)} at path {_where(path)}")
        out = [from_state_dict(x, state[str(i)], leaf, path + (str(i),))
               for i, x in enumerate(target)]
        return tuple(out) if isinstance(target, tuple) else out
    return state if leaf is None else leaf(target, state, path)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _int(x: int) -> bytes:
    """msgpack-python's narrowest form of an int."""
    if x >= 0:
        if x < 0x80:
            return struct.pack("B", x)
        if x < 0x100:
            return struct.pack(">BB", 0xcc, x)
        if x < 0x10000:
            return struct.pack(">BH", 0xcd, x)
        if x < 0x100000000:
            return struct.pack(">BI", 0xce, x)
        if x < 0x10000000000000000:
            return struct.pack(">BQ", 0xcf, x)
        raise OverflowError(f"int {x} does not fit in 64 bits")
    if x >= -32:
        return struct.pack("b", x)
    if x >= -0x80:
        return struct.pack(">Bb", 0xd0, x)
    if x >= -0x8000:
        return struct.pack(">Bh", 0xd1, x)
    if x >= -0x80000000:
        return struct.pack(">Bi", 0xd2, x)
    if x >= -0x8000000000000000:
        return struct.pack(">Bq", 0xd3, x)
    raise OverflowError(f"int {x} does not fit in 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes, what: str) -> bytes:
    """The header of a str/bin/array/map of ``n`` items or bytes: a fix
    form below ``fix_max`` (when the kind has one), else 8/16/32-bit."""
    if fix is not None and n < fix_max:
        return struct.pack("B", fix | n)
    c8, c16, c32 = codes
    if c8 is not None and n < 0x100:
        return struct.pack(">BB", c8, n)
    if n < 0x10000:
        return struct.pack(">BH", c16, n)
    if n < 0x100000000:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"{what} of {n} is too large for msgpack")


def _str(n):
    return _sized(n, 0xa0, 32, (0xd9, 0xda, 0xdb), "str")


def _bin(n):
    return _sized(n, None, 0, (0xc4, 0xc5, 0xc6), "bin")


def _array(n):
    return _sized(n, 0x90, 16, (None, 0xdc, 0xdd), "array")


def _map(n):
    return _sized(n, 0x80, 16, (None, 0xde, 0xdf), "map")


_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _ext(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return struct.pack(">Bb", _FIXEXT[n], code)
    if n < 0x100:
        return struct.pack(">BBb", 0xc7, n, code)
    if n < 0x10000:
        return struct.pack(">BHb", 0xc8, n, code)
    return struct.pack(">BIb", 0xc9, n, code)


def _array_bytes(x):
    """``(shape, dtype name, memoryview of the C-order bytes)`` of a
    tensor or numpy array, without copying a contiguous CPU array."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.resolve_conj().resolve_neg().contiguous()
        if t.dtype not in DTYPE_NAMES:
            raise ValueError(f"no msgpack dtype name for {t.dtype}")
        if not t.numel():  # (an empty tensor may have stride 0)
            return tuple(t.shape), DTYPE_NAMES[t.dtype], memoryview(b"")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return tuple(t.shape), DTYPE_NAMES[t.dtype], memoryview(raw)
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    # The shape is taken first: ascontiguousarray makes a 0-d array 1-d.
    flat = np.ascontiguousarray(a).reshape(-1)
    return a.shape, a.dtype.name, memoryview(flat.view(np.uint8))


class _Writer:
    """msgpack output as pieces: small headers gathered into one buffer,
    an array's bytes left as a memoryview of the array."""

    def __init__(self) -> None:
        self.pieces: List[Any] = []
        self.buf = bytearray()

    def raw(self, mv) -> None:
        if len(mv) <= _INLINE_BYTES:
            self.buf += mv
            return
        if self.buf:
            self.pieces.append(bytes(self.buf))
            self.buf = bytearray()
        self.pieces.append(mv)

    def done(self) -> List[Any]:
        if self.buf:
            self.pieces.append(bytes(self.buf))
            self.buf = bytearray()
        return self.pieces

    def ndarray(self, code: int, x) -> None:
        shape, name, mv = _array_bytes(x)
        head = bytearray(_array(3))
        head += _array(len(shape))
        for n in shape:
            head += _int(int(n))
        encoded = name.encode()
        head += _str(len(encoded)) + encoded
        head += _bin(len(mv))
        self.buf += _ext(code, len(head) + len(mv)) + head
        self.raw(mv)

    def pack(self, x) -> None:
        buf = self.buf
        t = type(x)
        if x is None:
            buf.append(0xc0)
        elif t is bool:
            buf.append(0xc3 if x else 0xc2)
        elif t is int:
            buf += _int(x)
        elif t is float:
            buf += struct.pack(">Bd", 0xcb, x)
        elif t is str:
            encoded = x.encode("utf-8")
            buf += _str(len(encoded)) + encoded
        elif t in (bytes, bytearray, memoryview):
            mv = memoryview(x).cast("B")
            buf += _bin(len(mv))
            self.raw(mv)
        elif isinstance(x, dict):
            buf += _map(len(x))
            for k, v in x.items():
                self.pack(k)
                self.pack(v)
        elif t in (list, tuple):
            buf += _array(len(x))
            for v in x:
                self.pack(v)
        elif isinstance(x, (torch.Tensor, np.ndarray)):
            self.ndarray(_EXT_NDARRAY, x)
        elif isinstance(x, np.generic):
            self.ndarray(_EXT_NPSCALAR, np.asarray(x))
        elif t is complex:
            body = struct.pack(">BBdBd", 0x92, 0xcb, x.real, 0xcb, x.imag)
            buf += _ext(_EXT_COMPLEX, len(body)) + body
        else:
            raise TypeError(f"can not serialize {t.__name__!r} object")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """A large array as flax's canonical dict of flat chunks."""
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = x.numel() if isinstance(x, torch.Tensor) else x.size
    chunksize = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + chunksize] for j, i in
                       enumerate(range(0, size, chunksize))}}


def _chunk_leaves(x):
    """Arrays over MAX_CHUNK_SIZE bytes chunked, through dicts only (as
    flax's ``_chunk_array_leaves_in_place``)."""
    if isinstance(x, dict):
        return {k: _chunk_leaves(v) for k, v in x.items()}
    if isinstance(x, (torch.Tensor, np.ndarray)) and \
            _nbytes(x) > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def _pieces(pytree) -> List[Any]:
    w = _Writer()
    w.pack(_chunk_leaves(pytree))
    return w.done()


def _sorted_dicts(x):
    """``x`` as ``jax.tree_util.tree_map`` rebuilds it: dict keys sorted."""
    if isinstance(x, dict):
        return {k: _sorted_dicts(x[k]) for k in sorted(x)}
    if isinstance(x, list):
        return [_sorted_dicts(v) for v in x]
    return x


def msgpack_serialize(pytree, in_place: bool = False) -> bytes:
    """A tree of dicts, lists and array or Python leaves as msgpack
    bytes, arrays over MAX_CHUNK_SIZE bytes chunked.  As flax's, dict
    keys are sorted unless ``in_place`` (flax copies the tree with
    ``tree_map`` first, which sorts them; ``to_bytes`` does not)."""
    return b"".join(_pieces(pytree if in_place else _sorted_dicts(pytree)))


def to_pieces(target) -> List[Any]:
    """:func:`to_bytes` as a list of buffers (small headers, memoryviews
    of the arrays) to write in order."""
    return _pieces(to_state_dict(target))


def to_bytes(target) -> bytes:
    """``flax.serialization.to_bytes``: the state dict of ``target`` as
    msgpack bytes."""
    return b"".join(to_pieces(target))


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _tensor(shape, name: str, mv):
    """A fresh CPU tensor of the bytes in ``mv``."""
    if name not in TORCH_DTYPES:
        raise ValueError(f"array dtype {name!r} is not in the format")
    t = torch.empty(tuple(shape), dtype=TORCH_DTYPES[name])
    raw = t.reshape(-1).view(torch.uint8)
    if raw.numel() != len(mv):
        raise ValueError(f"array of shape {tuple(shape)} {name} holds "
                         f"{len(mv)} bytes, not {raw.numel()}")
    if len(mv):
        raw.numpy()[:] = np.frombuffer(mv, dtype=np.uint8)
    return t


def _scalar(name: str, mv):
    if name == "bfloat16":  # numpy has no bfloat16 of its own
        return _tensor((), name, mv)
    return np.frombuffer(mv, dtype=np.dtype(name))[0]


class _Reader:
    def __init__(self, data) -> None:
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int):
        end = self.pos + n
        if end > len(self.mv):
            raise ValueError("msgpack data ends inside an object")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        out = struct.unpack_from(fmt, self.mv, self.pos)
        self.pos += struct.calcsize(fmt)
        return out[0]

    def ext(self, code: int, n: int):
        body = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            inner = _Reader(body)
            shape, name, data = inner.read(raw=True)
            name = bytes(name).decode()
            return (_tensor(shape, name, data) if code == _EXT_NDARRAY
                    else _scalar(name, data))
        if code == _EXT_COMPLEX:
            re, im = _Reader(body).read()
            return complex(re, im)
        raise ValueError(f"msgpack ext code {code} is not in the format")

    def read(self, raw: bool = False):
        """One object.  ``raw``: str and bin come back as memoryviews
        (the ext triples' dtype name and bytes)."""
        b = self.mv[self.pos]
        self.pos += 1
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, raw)
        if 0x90 <= b <= 0x9f:
            return [self.read(raw) for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.string(b & 0x1f, raw)
        if b == 0xc0:
            return None
        if b == 0xc2:
            return False
        if b == 0xc3:
            return True
        if b in (0xc4, 0xc5, 0xc6):
            n = self.unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b])
            data = self.take(n)
            return data if raw else bytes(data)
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xca:
            return self.unpack(">f")
        if b == 0xcb:
            return self.unpack(">d")
        if 0xcc <= b <= 0xd3:
            return self.unpack((">B", ">H", ">I", ">Q",
                                ">b", ">h", ">i", ">q")[b - 0xcc])
        if 0xd4 <= b <= 0xd8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            return self.string(
                self.unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b]), raw)
        if b in (0xdc, 0xdd):
            n = self.unpack(">H" if b == 0xdc else ">I")
            return [self.read(raw) for _ in range(n)]
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"), raw)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the format")

    def string(self, n: int, raw: bool):
        data = self.take(n)
        return data if raw else str(data, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.read(raw)
            if not isinstance(k, (str, bytes, memoryview)):
                raise ValueError(f"{type(k).__name__} is not allowed for "
                                 "map key")
            out[k] = self.read(raw)
        return out


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            return _unchunk(x)
        return {k: _unchunk_leaves(v) for k, v in x.items()}
    return x


def msgpack_restore(data) -> Any:
    """msgpack bytes (any buffer) back to a tree of dicts, lists and
    leaves, chunked arrays joined."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} bytes after the msgpack "
                         "object")
    return _unchunk_leaves(out)


def from_bytes(target, data) -> Any:
    """``flax.serialization.from_bytes``: ``data`` restored into the
    structure of ``target``."""
    return from_state_dict(target, msgpack_restore(data))
