"""A small msgpack codec for flax checkpoints, without flax or msgpack.

The JAX package writes its ``.ckpt`` files with
``flax.serialization.msgpack_serialize`` (flax/serialization.py:249-392):
a msgpack map of nested maps whose leaves are

* ext code 1, an ndarray: the msgpack array ``[shape, dtype name,
  C-order bytes]`` packed into the ext's data;
* ext code 3, a numpy scalar: the same triple of a 0-d array;
* the chunked-array map ``{"__msgpack_chunked_array__": True, "shape":
  {"0": ...}, "chunks": {"0": ndarray, ...}}`` for a leaf of more than
  ``MAX_CHUNK_SIZE`` bytes (one msgpack object holds at most 2**31 - 1).

``unpackb`` reads that format (maps, str, bin, arrays, ints, floats, nil,
bools and those two ext codes; any other ext code raises) and returns
nested dicts of numpy arrays; a ``bfloat16`` leaf, which numpy cannot
hold without ``ml_dtypes``, becomes a ``torch.bfloat16`` tensor through a
``uint16`` view. ``packb`` writes it: every map's keys sorted (flax
serializes a copy made by ``jax.tree_util``, which sorts dict keys), each
value in the smallest msgpack form, as msgpack-python packs it, so that
its bytes equal flax's for the same tree.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: leaves larger than this many bytes
# are written as chunked-array maps
MAX_CHUNK_SIZE = 2**30

# ---------------------------------------------------------------- encoder


def _pack_uint(n: int, out: bytearray) -> None:
    if n < 0x80:
        out.append(n)
    elif n <= 0xFF:
        out += b"\xcc" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    elif n <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", n)
    else:
        raise OverflowError(f"integer {n} does not fit in 64 bits")


def _pack_int(n: int, out: bytearray) -> None:
    if n >= 0:
        _pack_uint(n, out)
    elif n >= -32:
        out += struct.pack(">b", n)
    elif n >= -0x80:
        out += b"\xd0" + struct.pack(">b", n)
    elif n >= -0x8000:
        out += b"\xd1" + struct.pack(">h", n)
    elif n >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", n)
    elif n >= -0x8000000000000000:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"integer {n} does not fit in 64 bits")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    """A length header: the fix form (``fix | n``) below ``fix_max``,
    else the first of ``codes`` (8-, 16-, 32-bit length; None where that
    form does not exist) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _array_payload(shape, dtype_name: str, buffer: bytes) -> bytes:
    out = bytearray()
    _pack([list(shape), dtype_name, buffer], out)
    return bytes(out)


def _array_parts(x) -> tuple:
    """(shape, dtype name, C-order bytes) of an ndarray, numpy scalar or
    tensor; a bf16 tensor is named ``bfloat16`` as flax names it."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise TypeError(f"cannot serialize an array of dtype {a.dtype}")
    return a.shape, a.dtype.name, a.tobytes("C")


def _pack(x: Any, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif type(x) is bytes:
        _pack_len(len(x), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif type(x) in (list, tuple):
        _pack_len(len(x), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        _pack_len(len(x), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_payload(*_array_parts(x)), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(*_array_parts(x)), out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _chunked(a, itemsize: int, max_chunk: int) -> dict:
    """flax's ``_chunk``: the flat array in pieces of ``max_chunk`` bytes,
    keys in flax's insertion order."""
    size = max(1, int(max_chunk / itemsize))
    flat = a.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(a.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.shape[0], size))}}


def _prepare(x: Any, max_chunk: int) -> Any:
    """The tree as flax serializes it: dict keys sorted, array leaves over
    ``max_chunk`` bytes chunked."""
    if isinstance(x, dict):
        return {k: _prepare(x[k], max_chunk) for k in sorted(x)}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype != torch.bfloat16:
            x = x.numpy()
        elif x.numel() * 2 > max_chunk:
            return _chunked(x, 2, max_chunk)
    if isinstance(x, np.ndarray) and x.nbytes > max_chunk:
        return _chunked(x, x.dtype.itemsize, max_chunk)
    return x


def packb(tree: Any, max_chunk: int = MAX_CHUNK_SIZE) -> bytes:
    """msgpack bytes of a tree of dicts with array, tensor, numpy-scalar
    and Python-scalar leaves, as ``flax.serialization.msgpack_serialize``
    writes them."""
    out = bytearray()
    _pack(_prepare(tree, max_chunk), out)
    return bytes(out)


# ---------------------------------------------------------------- decoder


def _dtype(name: bytes | str):
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return torch.bfloat16
    try:
        return np.dtype(name)
    except TypeError as e:
        raise ValueError(f"unsupported array dtype {name!r}") from e


def _array_from(data: bytes):
    shape, name, buffer = _Reader(data, raw=True).read_all()
    dtype = _dtype(name)
    if dtype is torch.bfloat16:
        bits = np.frombuffer(buffer, np.uint16).reshape(shape)
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return np.frombuffer(buffer, dtype).reshape(shape)


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read_all(self):
        obj = self.read()
        if self.pos != len(self.data):
            raise ValueError(f"{len(self.data) - self.pos} bytes after the "
                             "msgpack object")
        return obj

    def text(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            a = _array_from(data)
            return a if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f"msgpack ext code {code} is not a flax array")

    def read(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.read_map(b & 0x0F)
        if b < 0xA0:
            return [self.read() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        formats = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in formats:
            return self.unpack(formats[b])
        lengths = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:
            return self.take(self.unpack(lengths[b - 0xC4]))
        if 0xC7 <= b <= 0xC9:
            return self.ext(self.unpack(lengths[b - 0xC7]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.text(self.unpack(lengths[b - 0xD9]))
        if b in (0xDC, 0xDD):
            n = self.unpack(lengths[b - 0xDB])
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(lengths[b - 0xDD]))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(x: Any) -> Any:
    if not isinstance(x, dict):
        return x
    if CHUNKED in x:
        shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
        chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in x.items()}


def unpackb(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data``: nested dicts (lists for msgpack arrays) of numpy arrays and
    scalars, chunked arrays joined; bf16 leaves as ``torch.bfloat16``."""
    return _unchunk(_Reader(data).read_all())
