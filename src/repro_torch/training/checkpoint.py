"""Msgpack checkpointing for param/optimizer trees, without ``msgpack``.

The port's counterpart of ``repro.training.checkpoint``, byte-compatible
with its files: a checkpoint written by either package restores in the
other.  Trees are flattened to (path, array) pairs keyed as JAX keys them
(``a/b/0``; a NamedTuple's fields as ``.step``, ``.m``, ``.v``; dict keys
sorted), and each array is stored with dtype/shape headers.  bfloat16
leaves travel as their 16-bit patterns under the dtype name ``bfloat16``,
so neither ``msgpack`` nor ``ml_dtypes`` is needed: the small codec below
writes and reads the msgpack subset such a file holds (maps, str, int, bin
and arrays of ints) exactly as ``msgpack.packb(payload, use_bin_type=True)``
encodes it.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Iterator

import numpy as np
import torch

# ---------------------------------------------------------------- the codec


#: msgpack's integer forms past the fixints, smallest first, as msgpack
#: picks them: (least, most, type byte, struct format)
_INTS = ((0, 0xFF, 0xCC, ">BB"), (-0x80, -1, 0xD0, ">Bb"),
         (0, 0xFFFF, 0xCD, ">BH"), (-0x8000, -1, 0xD1, ">Bh"),
         (0, 0xFFFFFFFF, 0xCE, ">BI"), (-0x80000000, -1, 0xD2, ">Bi"),
         (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">BQ"),
         (-0x8000000000000000, -1, 0xD3, ">Bq"))


def _int(n: int) -> bytes:
    if -0x20 <= n < 0x80:
        return struct.pack("b" if n < 0 else "B", n)
    for lo, hi, tag, fmt in _INTS:
        if lo <= n <= hi:
            return struct.pack(fmt, tag, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _header(n: int, fix: int | None, fix_max: int, tags: tuple) -> bytes:
    """A length header: the fix form below ``fix_max``, else the 8-, 16- or
    32-bit form (``tags``; None where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        return struct.pack("B", fix | n)
    for tag, fmt, hi in zip(tags, (">BB", ">BH", ">BI"),
                            (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= hi:
            return struct.pack(fmt, tag, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack(obj, out: list) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"the checkpoint codec packs no {type(obj).__name__}")
    if isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out += [_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)), b]
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out += [_header(len(obj), None, 0, (0xC4, 0xC5, 0xC6)), obj]
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"the checkpoint codec packs no {type(obj).__name__}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for maps, str, int, bin
    and arrays."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def unpackb(data: bytes):
    """The inverse of ``packb`` (``msgpack.unpackb(data, raw=False)`` on
    that subset); raises ``ValueError`` on any other type."""
    view = memoryview(data)
    obj, end = _unpack(view, 0)
    if end != len(view):
        raise ValueError(f"{len(view) - end} bytes after the msgpack object")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H",
        0xC6: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


def _unpack(v: memoryview, i: int):
    tag = v[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xE0:
        return tag - 0x100, i
    if tag in _FIXED:
        fmt = _FIXED[tag]
        return struct.unpack_from(fmt, v, i)[0], i + struct.calcsize(fmt)
    if 0xA0 <= tag < 0xC0:
        kind, n = "str", tag & 0x1F
    elif 0x80 <= tag < 0x90:
        kind, n = "map", tag & 0x0F
    elif 0x90 <= tag < 0xA0:
        kind, n = "array", tag & 0x0F
    elif tag in _LEN:
        fmt = _LEN[tag]
        n = struct.unpack_from(fmt, v, i)[0]
        i += struct.calcsize(fmt)
        kind = ("str" if tag in (0xD9, 0xDA, 0xDB) else
                "bin" if tag in (0xC4, 0xC5, 0xC6) else
                "array" if tag in (0xDC, 0xDD) else "map")
    else:
        raise ValueError(f"msgpack type byte 0x{tag:02x} is not in the "
                         "checkpoint subset")
    if kind == "str":
        return str(v[i:i + n], "utf-8"), i + n
    if kind == "bin":
        return bytes(v[i:i + n]), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            x, i = _unpack(v, i)
            out.append(x)
        return out, i
    d = {}
    for _ in range(n):
        k, i = _unpack(v, i)
        d[k], i = _unpack(v, i)
    return d, i


# ------------------------------------------------------------ the checkpoint


def _flatten(tree, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(key, leaf) in JAX's flattening order, keyed as its ``_key_str``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif hasattr(tree, "_fields"):            # a NamedTuple: GetAttrKey
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _unflatten(tree, leaves: dict, path: tuple = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, path + (str(k),))
                for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, n), leaves,
                                       path + (f".{n}",))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, path + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(path)]


def _record(leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _tensor(rec: dict, like) -> torch.Tensor:
    shape = tuple(rec["shape"])
    bf16 = rec["dtype"] == "bfloat16"
    arr = np.frombuffer(rec["data"], np.int16 if bf16 else rec["dtype"])
    t = torch.from_numpy(arr.reshape(shape).copy())
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    payload = {"step": int(step),
               "arrays": {k: _record(leaf) for k, leaf in _flatten(tree)}}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    chunks: list = []
    _pack(payload, chunks)
    with open(tmp, "wb") as f:
        f.writelines(chunks)
    os.replace(tmp, path)


def restore_checkpoint(path: str, tree_like: Any) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (shapes must match):
    tensors of the checkpoint's dtypes, each on its ``tree_like`` leaf's
    device (the CPU where that leaf is not a tensor)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    arrays = payload["arrays"]
    leaves = {}
    for k, leaf in _flatten(tree_like):
        if k not in arrays:
            raise KeyError(f"checkpoint missing leaf {k}")
        rec = arrays[k]
        if tuple(rec["shape"]) != tuple(np.shape(leaf)):
            raise ValueError(
                f"shape mismatch for {k}: ckpt {tuple(rec['shape'])} vs "
                f"{tuple(np.shape(leaf))}"
            )
        leaves[k] = _tensor(rec, leaf)
    return _unflatten(tree_like, leaves), int(payload["step"])
