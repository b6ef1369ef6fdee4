"""A msgpack codec for flax's checkpoint format, with no ``msgpack`` or
``flax`` package: the counterpart of ``flax.serialization.to_bytes`` /
``msgpack_restore``, which the JAX package's ``train/checkpoint.py``
writes and reads.

Covered: maps (string keys), arrays, str, bin, int, float, nil and bool;
flax's ndarray ext type (code 1: a msgpack array ``(shape, dtype name,
raw C-order bytes)`` in bin), its numpy-scalar ext type (code 3, the same
payload, decoded to a 0-d array's item) and its chunked form for arrays
over :data:`MAX_CHUNK_SIZE` bytes (``{"__msgpack_chunked_array__": True,
"shape": {"0": ...}, "chunks": {"0": flat array, ...}}``), which
:func:`unpackb` joins back into one array.

:func:`packb` writes what ``flax.serialization.to_bytes`` writes for a
tree of dicts and numpy arrays: keys sorted (the order jax's tree
utilities give a dict), each value in
msgpack's smallest encoding, floats as float64, arrays as ext type 1.
Arrays come back as numpy arrays; ``bfloat16`` ones (numpy has no such
dtype) as ``torch.bfloat16`` tensors.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

#: flax's ext type codes (``flax.serialization._MsgpackExtType``)
EXT_NDARRAY = 1
EXT_NPSCALAR = 3
#: flax chunks arrays above this many bytes (``MAX_CHUNK_SIZE``)
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
#: key order of an int8 dense block (``serve.quant``), kept as it is
_QUANT_ORDER = ["kernel", "qscale", "bias"]


# ------------------------------------------------------------------ encode


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"),
                                 (-0x8000000000000000, 0xD3, ">q")):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(out: bytearray, n: int, fix: Tuple[int, int], codes) -> None:
    """A length header: the fix form ``(base, max)`` when it fits, else the
    8/16/32-bit codes in order (None where the family has no 8-bit form)."""
    base, fix_max = fix
    if n <= fix_max:
        out.append(base | n)
        return
    for limit, code, fmt in ((0xFF, codes[0], ">B"), (0xFFFF, codes[1], ">H"),
                             (0xFFFFFFFF, codes[2], ">I")):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"msgpack object of length {n} is too long")


def _pack_bin(out: bytearray, data: bytes) -> None:
    n = len(data)
    for limit, code, fmt in ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"),
                             (0xFFFFFFFF, 0xC6, ">I")):
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            out += data
            return
    raise OverflowError(f"bin of {n} bytes is too long for msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += bytes((0xC7, n))
    elif n <= 0xFFFF:
        out.append(0xC8)
        out += struct.pack(">H", n)
    else:
        out.append(0xC9)
        out += struct.pack(">I", n)
    out.append(code)
    out += data


def _dtype_name(arr) -> str:
    import torch

    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).replace("torch.", "")
    return arr.dtype.name


def _array_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``."""
    import torch

    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        raw = (t.view(torch.int16).numpy().tobytes()
               if t.dtype == torch.bfloat16 else t.numpy().tobytes())
        shape = tuple(t.shape)
    else:
        raw, shape = np.ascontiguousarray(arr).tobytes(), arr.shape
    out = bytearray()
    _pack(out, [list(shape), _dtype_name(arr), raw])
    return bytes(out)


def _pack(out: bytearray, v: Any) -> None:
    import torch

    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, (bytes, bytearray)):
        _pack_bin(out, bytes(v))
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _pack_len(out, len(data), (0xA0, 31), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, dict):
        _pack_len(out, len(v), (0x80, 15), (None, 0xDE, 0xDF))
        # jax's tree order: sorted keys — except an int8 dense block, which
        # JAX's ``quantize_params`` builds as (kernel, qscale, bias) and
        # flax writes in that order
        items = v.items() if list(v) == _QUANT_ORDER else sorted(v.items())
        for k, x in items:
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), (0x90, 15), (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"cannot msgpack a {type(v).__name__}")


def _chunked(arr: np.ndarray) -> Dict[str, Any]:
    """flax's ``_chunk``: the flattened array in pieces of at most
    :data:`MAX_CHUNK_SIZE` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _chunk_leaves(tree):
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunked(tree)
    return tree


def packb(tree: Any) -> bytes:
    """``tree`` (dicts of numpy arrays, tensors and scalars) as flax's
    ``to_bytes`` encodes it."""
    out = bytearray()
    _pack(out, _chunk_leaves(tree))
    return bytes(out)


# ------------------------------------------------------------------ decode


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array_from_payload(data: bytes):
    shape, name, raw = _unpack(_Reader(data))
    shape = tuple(shape)
    if name == "bfloat16":
        import torch

        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _unpack(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
    if b in ints:
        v = r.unpack(ints[b])
        return float(v) if b in (0xCA, 0xCB) else v
    lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
            0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext or b in (0xC7, 0xC8, 0xC9):
        n = fixext[b] if b in fixext else r.unpack(lens[b])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b not in lens:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one this "
                         "codec reads")
    n = r.unpack(lens[b])
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if b in (0xD9, 0xDA, 0xDB):
        return bytes(r.take(n)).decode("utf-8")
    if b in (0xDC, 0xDD):
        return [_unpack(r) for _ in range(n)]
    return _map(r, n)


def _map(r: _Reader, n: int) -> Dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """The tree flax's ``msgpack_restore`` returns for ``data`` (chunked
    arrays joined); raises ``ValueError`` on bytes it cannot decode."""
    r = _Reader(bytes(data))
    try:
        tree = _unpack(r)
    except (struct.error, UnicodeDecodeError, TypeError, KeyError) as e:
        raise ValueError(f"undecodable msgpack data: {e}") from e
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of trailing data "
                         "after the msgpack object")
    return _unchunk_leaves(tree)
