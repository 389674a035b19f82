"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``nunerf_tpu_torch/build/`` (listed in ``.gitignore``), and loaded with
``ctypes``.  A library is named by the hash of its source and of the
``csrc/*.cuh`` headers beside it, so an edited source is rebuilt and an
unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card")
    return path


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every header beside it (a header may be included)
    for f in [f"{name}.cu"] + sorted(h for h in os.listdir(CSRC_DIR) if h.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def sources():
    """Names of the CUDA sources under ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build_all(names=None) -> dict:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together; returns ``{name: library path}``.
    ``nvcc``'s ``-Xptxas -v`` report goes to ``build/<name>.ptxas.txt``."""
    names = sources() if names is None else list(names)
    libs = {n: library_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(libs[n])]
    if not todo:
        return libs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    try:
        for n in todo:
            tmp = f"{libs[n]}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            with open(os.path.join(BUILD_DIR, f"{n}.ptxas.txt"), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu:\n{out[-4000:]}")
            else:
                os.replace(tmp, libs[n])
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path."""
    return build_all([name])[name]


def load_from(name: str, path: str) -> ctypes.CDLL:
    """Load the library at ``path`` in the place of ``csrc/<name>.cu``'s own:
    ``load(name)`` returns it from then on (a profiling build of the same
    source with other ``-D`` flags)."""
    with _lock:
        _loaded[name] = ctypes.CDLL(path)
        return _loaded[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
