"""Checkpoints in the JAX package's format, without flax or msgpack.

Port of ``nextbestpath_tpu/utils/checkpoint.py``. A checkpoint is a pickle
of ``{"epoch": int, "variables": bytes, "extra": dict}`` (and
``"opt_state": bytes`` when saved with one), each ``bytes`` the output of
``flax.serialization.to_bytes``: msgpack of the nested state dict with
array leaves as msgpack extension types. This module reads and writes that
msgpack itself, in pure Python:

* maps, arrays, str, bin, ints, floats, nil and bools;
* ext 1, an ndarray, packed as the msgpack triple (shape, dtype name, C
  bytes); ext 2, a complex (real, imag); ext 3, a numpy scalar packed as a
  0-d ndarray;
* flax's ``__msgpack_chunked_array__`` maps (arrays over 1 GiB), which the
  reader reassembles and the writer refuses to make.

The trees are nested dicts with numpy leaves; ``models/convert.py`` maps
the NBP's onto a ``state_dict``. A file this module writes loads in the
JAX package's ``load_checkpoint`` with a flax template.
"""

from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_LEAF_BYTES = 2 ** 30  # flax chunks array leaves past this size


class _Reader:
    """msgpack decoder over one buffer; ``raw`` keeps str as bytes (the
    ndarray triple's dtype name, as flax unpacks it)."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_unpack(code, self.take(n))

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self.take(self.unpack(sized[b])))
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            return self.ext(self.unpack(sized[b]))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            return self.str_(self.unpack(sized[b]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte {b:#04x} is not supported")

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray_from_bytes(data) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data, raw=True).read()
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 leaves need ml_dtypes, which the port "
                         "does not use; the NBP's parameters are f32")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext_unpack(code: int, data) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(data).read()
        return complex(re, im)
    raise ValueError(f"msgpack extension type {code} is not supported")


def _unchunk(tree: Any) -> Any:
    """Reassemble flax's chunked array leaves, in place."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree that ``flax.serialization.msgpack_restore`` gives."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         f"object")
    return _unchunk(tree)


def _int(n: int) -> bytes:
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"),
                              (0, 2 ** 64 - 1, 0xCF, ">Q"),
                              (-0x80, -1, 0xD0, ">b"),
                              (-0x8000, -1, 0xD1, ">h"),
                              (-0x80000000, -1, 0xD2, ">i"),
                              (-2 ** 63, -1, 0xD3, ">q")):
        if lo <= n <= hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _sized(n: int, fix: Optional[Tuple[int, int]], codes) -> bytes:
    """The header of a str, bin, array or map of n entries: a fix form
    ``(base, limit)`` when it fits, else the 8/16/32-bit sized codes."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0x100, 0x10000, 0x100000000)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack object of {n} entries is too large")


def _ext(code: int, data: List, out: List) -> None:
    """An ext object whose payload is the chunks ``data``."""
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = sum(memoryview(c).nbytes for c in data)
    head = (bytes([fixed[n]]) if n in fixed
            else _sized(n, None, (0xC7, 0xC8, 0xC9)))
    out.append(head + struct.pack(">b", code))
    out.extend(data)


def _ndarray_chunks(arr: np.ndarray) -> List:
    """The (shape, dtype name, C bytes) triple; the bytes are a flat u8
    view of the array (a copy only when it is not C-contiguous)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be saved")
    data = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    chunks: List = []
    _pack((arr.shape, arr.dtype.name, data), chunks)
    return chunks


def _pack(x: Any, out: List) -> None:
    """Append the msgpack encoding of x to ``out`` as chunks, so that array
    data is copied once, by the final join."""
    if x is None:
        out.append(b"\xc0")
    elif isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        if x.nbytes > MAX_LEAF_BYTES:
            raise ValueError(f"an array leaf of {x.nbytes} bytes would need "
                             f"flax's chunked form, which is not written")
        _ext(_EXT_NDARRAY, _ndarray_chunks(x), out)
    elif isinstance(x, np.generic):  # before float: np.float64 is a float
        _ext(_EXT_NPSCALAR, _ndarray_chunks(np.asarray(x)), out)
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, complex):
        data: List = []
        _pack((x.real, x.imag), data)
        _ext(_EXT_COMPLEX, data, out)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        out.append(_sized(len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + b)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        out.append(_sized(memoryview(x).nbytes, None, (0xC4, 0xC5, 0xC6)))
        out.append(x)
    elif isinstance(x, (list, tuple)):
        out.append(_sized(len(x), (0x90, 16), (None, 0xDC, 0xDD)))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_sized(len(x), (0x80, 16), (None, 0xDE, 0xDF)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(x).__name__} as msgpack")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for a tree
    of dicts with numpy leaves (torch tensors are taken as numpy)."""
    out: List = []
    _pack(_to_numpy(tree), out)
    return b"".join(out)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):  # a torch tensor
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(path: str, variables: Any, opt_state: Any = None,
                    epoch: int = 0, extra: Optional[Dict[str, Any]] = None
                    ) -> None:
    """Write ``variables`` (and ``opt_state``) as the JAX package's
    ``save_checkpoint`` does, atomically: a per-process temporary file,
    synced, then renamed over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"epoch": epoch, "variables": msgpack_serialize(variables),
               "extra": extra or {}}
    if opt_state is not None:
        payload["opt_state"] = msgpack_serialize(opt_state)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """(variables, opt_state or None, epoch, extra) of a checkpoint, the
    trees as nested dicts with numpy leaves. Reads only files this program
    or the JAX package wrote: it unpickles them."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    opt = payload.get("opt_state")
    return (msgpack_restore(payload["variables"]),
            None if opt is None else msgpack_restore(opt),
            payload["epoch"], payload.get("extra", {}))


def save_nbp(path: str, model, epoch: int = 0,
             extra: Optional[Dict[str, Any]] = None) -> None:
    """Save an unfolded ``models.unet.NBP`` as flax ``params`` and
    ``batch_stats``, ``log_vars`` included."""
    from ..models.convert import state_dict_to_flax

    params, stats = state_dict_to_flax(model.state_dict())
    save_checkpoint(path, {"params": params, "batch_stats": stats},
                    epoch=epoch, extra=extra)


def load_nbp(path: str, model) -> Tuple[int, Dict[str, Any]]:
    """Load a checkpoint's NBP variables into ``model`` (strict); returns
    (epoch, extra)."""
    import torch

    from ..models.convert import flax_to_state_dict

    variables, _, epoch, extra = load_checkpoint(path)
    sd = flax_to_state_dict(variables["params"], variables["batch_stats"])
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    return epoch, extra
