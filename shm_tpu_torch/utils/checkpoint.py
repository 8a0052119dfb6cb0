"""Reader and writer of flax msgpack checkpoints, in pure Python (no ``msgpack``
package).

The JAX package writes a checkpoint with ``flax.serialization.to_bytes``: a
msgpack map of nested maps whose leaves are numpy arrays, each packed as
msgpack ext type 1 holding a nested msgpack array ``(shape, dtype_name,
row-major bytes)`` (``flax.serialization._ndarray_to_bytes``); numpy scalars
use ext type 3 with the same payload. :func:`load_checkpoint` decodes that
into a nested ``dict`` of numpy arrays; :func:`save_checkpoint` writes such a
tree back in the same encoding, so that a checkpoint written by the port is
restored by ``flax.serialization.from_bytes`` and by this reader alike.

The decoder covers the msgpack types such a file can hold: nil, bool, ints,
floats, str, bin, array, map and ext.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode_ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("utf-8")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name))
    return arr.reshape(tuple(shape), order="C")


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _decode_ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _decode_ndarray(payload)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _decode(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:                                  # positive fixint
        return b
    if b >= 0xE0:                                  # negative fixint
        return b - 0x100
    if 0x80 <= b <= 0x8F:                          # fixmap
        return _decode_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:                          # fixarray
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:                          # fixstr
        return r.take(b & 0x1F).decode("utf-8")
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):                    # bin 8/16/32
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return r.take(n)
    if b in (0xC7, 0xC8, 0xC9):                    # ext 8/16/32
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    if 0xCC <= b <= 0xD3:                          # uint / int 8..64
        fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[b]
        return r.unpack(fmt)
    if 0xD4 <= b <= 0xD8:                          # fixext 1/2/4/8/16
        n = 1 << (b - 0xD4)
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    if b in (0xD9, 0xDA, 0xDB):                    # str 8/16/32
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return r.take(n).decode("utf-8")
    if b in (0xDC, 0xDD):                          # array 16/32
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_decode(r) for _ in range(n)]
    if b in (0xDE, 0xDF):                          # map 16/32
        n = r.unpack(">H" if b == 0xDE else ">I")
        return _decode_map(r, n)
    raise ValueError(f"invalid msgpack type byte 0x{b:02x} at {r.pos - 1}")


def _decode_map(r: _Reader, n: int) -> Dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of ``data``."""
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(data):
        raise ValueError(f"trailing bytes after msgpack object "
                         f"({len(data) - r.pos} left)")
    return obj


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """Nested dict of numpy arrays from a flax ``to_bytes`` checkpoint file."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"Missing checkpoint: {p}")
    tree = unpackb(p.read_bytes())
    if not isinstance(tree, dict):
        raise ValueError(f"{p}: expected a msgpack map at the top level")
    return tree


def _pack_len(n: int, fix: Optional[int], fix_max: int, codes) -> bytes:
    """Length header: the fix form up to ``fix_max``, else the 8/16/32-bit
    form of ``codes`` (None where msgpack has no such width)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"object too large for msgpack ({n})")


def packb(obj: Any) -> bytes:
    """Encode nil, bool, int, float (as float64), str, bytes, list/tuple, dict
    and numpy arrays (ext type 1, as flax packs them) as msgpack."""
    if obj is None:
        return b"\xc0"
    if isinstance(obj, (bool, np.bool_)):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, (int, np.integer)):
        n = int(obj)
        if 0 <= n <= 0x7F:
            return bytes([n])
        if -32 <= n < 0:
            return struct.pack(">b", n)
        for code, fmt, lo, hi in ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF),
                                  (0xCE, ">I", 0, 0xFFFFFFFF),
                                  (0xCF, ">Q", 0, 2 ** 64 - 1),
                                  (0xD0, ">b", -2 ** 7, -1),
                                  (0xD1, ">h", -2 ** 15, -1),
                                  (0xD2, ">i", -2 ** 31, -1),
                                  (0xD3, ">q", -2 ** 63, -1)):
            if lo <= n <= hi:
                return bytes([code]) + struct.pack(fmt, n)
        raise ValueError(f"integer out of msgpack range: {n}")
    if isinstance(obj, (float, np.floating)):
        return b"\xcb" + struct.pack(">d", float(obj))
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        return _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, (bytes, bytearray)):
        return _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return (_pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD))
                + b"".join(packb(x) for x in obj))
    if isinstance(obj, dict):
        return (_pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF))
                + b"".join(packb(k) + packb(v) for k, v in obj.items()))
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object arrays cannot be serialized")
        payload = packb((list(obj.shape), obj.dtype.name, obj.tobytes("C")))
        return (_pack_len(len(payload), None, 0, (0xC7, 0xC8, 0xC9))
                + struct.pack(">b", _EXT_NDARRAY) + payload)
    raise TypeError(f"cannot pack {type(obj).__name__} as msgpack")


def save_checkpoint(tree: Dict[str, Any], path: str | Path) -> None:
    """Write a nested dict of numpy arrays as a flax-readable msgpack file."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(packb(tree))


__all__ = ["load_checkpoint", "save_checkpoint", "unpackb", "packb"]
