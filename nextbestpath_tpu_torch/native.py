"""Loading the repository's native host libraries with ctypes.

A library is the tracked ``native/lib<name>.so``, read only (the JAX
package loads the same file). When it does not load on this machine,
``native/<name>.cpp`` is built with ``g++`` into the git-ignored
``nextbestpath_tpu_torch/_build/``; nothing is written under ``native/``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE_DIR = os.path.normpath(os.path.join(_HERE, "..", "native"))
BUILD_DIR = os.path.join(_HERE, "_build")


def _build(source: str, built: str) -> Optional[str]:
    """``source`` compiled into ``built`` (once); None when there is no
    source or no g++, or the build fails."""
    if os.path.exists(built):
        return built
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(source):
        return None
    os.makedirs(os.path.dirname(built), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(built))
    os.close(fd)
    proc = subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                           "-o", tmp, source], capture_output=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        return None
    os.replace(tmp, built)
    return built


def _open(path: str) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def load_native(name: str) -> Optional[ctypes.CDLL]:
    """``native/lib<name>.so``, else ``native/<name>.cpp`` built into
    ``_build/``; None when neither loads."""
    tracked = os.path.join(NATIVE_DIR, f"lib{name}.so")
    lib = _open(tracked) if os.path.exists(tracked) else None
    if lib is None:
        built = _build(os.path.join(NATIVE_DIR, f"{name}.cpp"),
                       os.path.join(BUILD_DIR, f"lib{name}.so"))
        lib = _open(built) if built is not None else None
    return lib
