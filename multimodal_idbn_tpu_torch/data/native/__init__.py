"""ctypes binding of the native dot-pattern generator.

The port's own copy of multimodal_idbn_tpu/data/native/__init__.py, over
its own byte-for-byte copy of ``dotgen.cpp``: for a seed and per-sample dot
counts it gives the same images and features as the JAX package's native
backend. The library is built with ``g++ -O3 -shared -fPIC -std=c++17``
(with ``-fopenmp`` when that builds) at first use, never when the module
is imported, into ``multimodal_idbn_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and written to a temporary
file that is renamed into place, so concurrent builds never leave a
partial library. Nothing is written beside the source, and the JAX
package's ``_dotgen.so`` is never loaded.

``native_available()`` builds on first use and says whether the library
loads: ``backend="auto"`` of ``data.numerosity`` takes the Python
generator when it does not, as the JAX package does (with the same
printed line), and ``backend="native"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "dotgen.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the built library lives: ``_build/dotgen-<hash>.so``."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"dotgen-{digest}.so"


def _compile_library(out: Path) -> bool:
    """Build ``out`` from the source, with OpenMP when it builds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    for extra in (["-fopenmp"], []):
        cmd = ["g++", *CXX_FLAGS, *extra, "-o", str(tmp), str(_SRC)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return False
        if res.returncode == 0:
            os.replace(tmp, out)
            return True
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.exists() and not _compile_library(path):
            _build_failed = True
            print("[dotgen] native build failed; using Python generator",
                  file=sys.stderr)
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.generate_dot_dataset.argtypes = [
            ctypes.c_uint64, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.generate_dot_dataset.restype = None
        lib.dotgen_version.argtypes = []
        lib.dotgen_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def generate_dot_dataset_native(seed: int, numerosities: np.ndarray,
                                side: int = 100, r_min: int = 2,
                                r_max: int = 6, max_tries: int = 200):
    """Images and geometry features for per-sample dot counts.

    Returns (images [N, side, side] f32, cumArea, CH, density, N_placed).
    Deterministic per (seed, index); parallel over samples."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native dotgen unavailable")
    nums = np.ascontiguousarray(numerosities, np.int32)
    n = len(nums)
    images = np.zeros((n, side, side), np.float32)
    cum_area = np.zeros(n, np.float32)
    ch = np.zeros(n, np.float32)
    density = np.zeros(n, np.float32)
    n_placed = np.zeros(n, np.int32)
    lib.generate_dot_dataset(
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), n, nums, side, r_min,
        r_max, max_tries, images.reshape(-1), cum_area, ch, density,
        n_placed)
    return images, cum_area, ch, density, n_placed
