"""Build and load the port's native mesh library (``meshops.cpp``, ctypes).

The library is compiled at first use with the flags of the JAX package's
``native/build.py`` (``g++ -O3 -march=native -shared -fPIC``), so that both
packages run the same code on one machine, into ``nunerf_tpu_torch/build/``
(listed in ``.gitignore``), and rebuilt when the source is newer than the
library.  A
failed build raises: the numpy versions in ``tracing/mesh_ops.py`` compute a
different remesh and curvature, so they are never a silent fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG_DIR, "native", "meshops.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
LIB = os.path.join(BUILD_DIR, "libmeshops.so")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _compile():
    """Compile into a temporary file and move it into place, so concurrent
    test workers never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SRC} with {CXX} failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib):
    from ctypes import POINTER, c_float, c_int, c_int32, c_int64, c_void_p
    fp = POINTER(c_float)
    ip = POINTER(c_int32)
    lib.extract_isosurface.argtypes = [
        fp, c_int, c_int, c_int, c_float,
        POINTER(fp), POINTER(c_int64), POINTER(ip), POINTER(c_int64)]
    lib.extract_isosurface.restype = c_int
    lib.meshops_free.argtypes = [c_void_p]
    lib.vertex_normals_curvature.argtypes = [
        fp, c_int64, ip, c_int64, fp, fp]
    lib.vertex_normals_curvature.restype = c_int
    lib.cluster_remesh.argtypes = [
        fp, c_int64, ip, c_int64, c_float,
        POINTER(fp), POINTER(c_int64), POINTER(ip), POINTER(c_int64)]
    lib.cluster_remesh.restype = c_int
    lib.bvh_build.argtypes = [
        fp, c_int64, ip, c_int64, c_int,
        POINTER(fp), POINTER(ip), POINTER(ip), POINTER(c_int64),
        POINTER(ip)]
    lib.bvh_build.restype = c_int
    return lib


def get_lib():
    """The loaded library, compiled first if it is missing or older than its
    source.  Raises ``RuntimeError`` when the compiler fails."""
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIB)
                    or os.path.getmtime(LIB) < os.path.getmtime(SRC)):
                _compile()
            _lib = _bind(ctypes.CDLL(LIB))
        return _lib
