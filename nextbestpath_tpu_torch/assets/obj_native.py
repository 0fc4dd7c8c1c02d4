"""ctypes binding of the native OBJ parser (``native/obj_fast.cpp``).

Port of ``nextbestpath_tpu/assets/obj_native.py``. The library is the
tracked ``native/libobj_fast.so``, read only; when it does not load, the
source is built with ``g++`` into the git-ignored ``_build/``
(``native.py``). Only when neither loads does ``load_obj_fast`` fall back
to the python parser (``obj_io.load_obj``, the same output), and
``native_available()`` says so.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..native import load_native
from .obj_io import load_obj as _py_load_obj

_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native("obj_fast")
    if lib is None:
        return None
    for name, res, args in (
            ("obj_parse", ctypes.c_void_p, [ctypes.c_char_p]),
            ("obj_n_verts", ctypes.c_int64, [ctypes.c_void_p]),
            ("obj_n_faces", ctypes.c_int64, [ctypes.c_void_p]),
            ("obj_copy", None, [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int32)]),
            ("obj_free", None, [ctypes.c_void_p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _lib = lib
    return lib


def load_obj_fast(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(verts f32 (V, 3), faces i32 (F, 3)), as ``obj_io.load_obj``."""
    lib = _load_lib()
    if lib is None:
        return _py_load_obj(path)
    handle = lib.obj_parse(path.encode())
    if not handle:
        raise IOError(f"obj_fast failed to open {path}")
    try:
        nv = lib.obj_n_verts(handle)
        nf = lib.obj_n_faces(handle)
        verts = np.empty((nv, 3), np.float32)
        faces = np.empty((max(nf, 1), 3), np.int32)
        lib.obj_copy(handle,
                     verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                     faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if nf == 0:
            faces = np.zeros((0, 3), np.int32)
        return verts, faces
    finally:
        lib.obj_free(handle)


def native_available() -> bool:
    return _load_lib() is not None
