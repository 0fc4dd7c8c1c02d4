"""The native replay record store (the LMDB-tier analog), bound with ctypes.

Port of ``nextbestpath_tpu/train/replay_native.py``: one record a
``train.replay.Experience`` in the JAX package's binary format (a header of
eight little-endian int64 — the gain count, pose index, the byte lengths of
the model input, layout and pixels, and the input's (C, H, W) — then the raw
arrays), appended and read through ``native/replay_store.cpp``, so that each
package reads the other's files.

The library is the repository's tracked ``native/libreplay_store.so``, read
only (the JAX package loads the same file). When it does not load on this
machine, ``native/replay_store.cpp`` is built with ``g++`` into the
git-ignored ``nextbestpath_tpu_torch/_build/``; nothing is written under
``native/``. ``native_available()`` is False only when neither loads.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import struct
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

from .replay import Experience

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE = os.path.join(_HERE, "..", "..", "native")
TRACKED_LIB = os.path.normpath(os.path.join(_NATIVE, "libreplay_store.so"))
SOURCE = os.path.normpath(os.path.join(_NATIVE, "replay_store.cpp"))
BUILT_LIB = os.path.join(_HERE, "..", "_build", "libreplay_store.so")
_lib: Optional[ctypes.CDLL] = None


def _build() -> Optional[str]:
    """``native/replay_store.cpp`` compiled into ``_build/`` (once); None
    when there is no source or no g++, or the build fails."""
    if os.path.exists(BUILT_LIB):
        return BUILT_LIB
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(SOURCE):
        return None
    os.makedirs(os.path.dirname(BUILT_LIB), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(BUILT_LIB))
    os.close(fd)
    proc = subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                           "-o", tmp, SOURCE], capture_output=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        return None
    os.replace(tmp, BUILT_LIB)
    return BUILT_LIB


def _open_lib(path: str) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    lib = _open_lib(TRACKED_LIB) if os.path.exists(TRACKED_LIB) else None
    if lib is None:
        built = _build()
        lib = _open_lib(built) if built is not None else None
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, res, args in (
            ("replay_open", ctypes.c_void_p, [ctypes.c_char_p]),
            ("replay_count", ctypes.c_int64, [ctypes.c_void_p]),
            ("replay_append", ctypes.c_int64,
             [ctypes.c_void_p, u8p, ctypes.c_uint64]),
            ("replay_record_len", ctypes.c_int64,
             [ctypes.c_void_p, ctypes.c_int64]),
            ("replay_read", ctypes.c_int64,
             [ctypes.c_void_p, ctypes.c_int64, u8p, ctypes.c_uint64]),
            ("replay_close", None, [ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def _pack(e: Experience) -> bytes:
    """A record: the header, then the f16 input, u8 layout, i32 pixels and
    f32 gains."""
    mi_arr = np.ascontiguousarray(e.model_input, np.float16)
    c, h, w = mi_arr.shape
    mi = mi_arr.tobytes()
    gl = np.ascontiguousarray(e.gt_layout, np.uint8).tobytes()
    px = np.ascontiguousarray(e.pixels, np.int32).tobytes()
    gn = np.ascontiguousarray(e.gains, np.float32).tobytes()
    header = struct.pack("<8q", len(e.pixels), e.pose_i, len(mi), len(gl),
                         len(px), c, h, w)
    return header + mi + gl + px + gn


def _unpack(buf: bytes) -> Experience:
    k, pose_i, n_mi, n_gl, n_px, c, h, w = struct.unpack_from("<8q", buf, 0)
    off = 8 * 8
    mi = np.frombuffer(buf, np.float16, count=n_mi // 2, offset=off
                       ).reshape(c, h, w)
    off += n_mi
    gl = np.frombuffer(buf, np.uint8, count=n_gl, offset=off).reshape(h, w)
    off += n_gl
    px = np.frombuffer(buf, np.int32, count=n_px // 4, offset=off
                       ).reshape(-1, 3)
    off += n_px
    gn = np.frombuffer(buf, np.float32, count=k, offset=off)
    return Experience(model_input=mi.copy(), gt_layout=gl.copy(),
                      pixels=px.copy(), gains=gn.copy(), pose_i=int(pose_i))


class NativeReplayStore:
    """Append and read Experience records through the native store."""

    def __init__(self, path: str):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("the native replay store is not available: "
                               "native/libreplay_store.so does not load and "
                               "native/replay_store.cpp cannot be built")
        self._lib = lib
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._handle = lib.replay_open(path.encode())
        if not self._handle:
            raise IOError(f"cannot open replay store at {path}")

    def __len__(self) -> int:
        return int(self._lib.replay_count(self._handle))

    def append(self, e: Experience) -> int:
        data = _pack(e)
        arr = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return int(self._lib.replay_append(self._handle, arr, len(data)))

    def read(self, index: int) -> Experience:
        n = int(self._lib.replay_record_len(self._handle, index))
        if n < 0:
            raise IndexError(index)
        buf = (ctypes.c_uint8 * n)()
        if self._lib.replay_read(self._handle, index, buf, n) != n:
            raise IOError(f"short read at record {index}")
        return _unpack(bytes(buf))

    def read_all(self) -> List[Experience]:
        return [self.read(i) for i in range(len(self))]

    def close(self) -> None:
        if self._handle:
            self._lib.replay_close(self._handle)
            self._handle = None
