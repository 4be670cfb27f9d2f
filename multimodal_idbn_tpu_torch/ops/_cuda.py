"""Build and bind the port's CUDA kernels (nvcc into a shared library
with a plain C interface, loaded with ctypes).

No JAX counterpart: Pallas kernels are compiled by JAX itself. Each
source under ``csrc/`` becomes one library in ``_build/`` (listed in
``.gitignore``), named by a hash of its sources so an edited kernel is
never served from a stale build. Nothing is built when a module is
imported: a library is built at its first launch, or up front by
``build_all``, which runs one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode",
              "arch=compute_90a,code=sm_90a", "-Xcompiler", "-fPIC",
              "-shared", "-Xptxas", "-v")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH); the CUDA kernels cannot be built")
    return found


LIBRARIES: List["CudaLibrary"] = []


class CudaLibrary:
    """One kernel source, its built library and its launch counts.

    ``functions`` maps each exported C launcher to its ctypes argtypes;
    every one returns a ``cudaError_t`` as int. ``launches`` counts the
    kernel launches made through ``launch``, and ``launches_by_entry`` the
    launches of each launcher. A source with more than one kernel body
    names them in ``bodies``, and ``launches_by_body`` counts the launches
    of each. ``helpers`` are exported functions that launch nothing
    (called through ``call``, never counted).
    """

    def __init__(self, source: str, functions: Dict[str, Sequence],
                 helpers: Optional[Dict[str, Sequence]] = None,
                 bodies: Sequence[str] = ()):
        self.source = CSRC / source
        self.functions = dict(functions)
        self.helpers = dict(helpers or {})
        self.launches_by_entry = dict.fromkeys(self.functions, 0)
        self.launches_by_body = dict.fromkeys(bodies, 0)
        self._lib: Optional[ctypes.CDLL] = None
        LIBRARIES.append(self)

    @property
    def launches(self) -> int:
        return sum(self.launches_by_entry.values())

    def reset_launches(self) -> None:
        self.launches_by_entry = dict.fromkeys(self.functions, 0)
        self.launches_by_body = dict.fromkeys(self.launches_by_body, 0)

    def _sources(self) -> List[Path]:
        return [self.source] + sorted(CSRC.glob("*.cuh"))

    @property
    def so_path(self) -> Path:
        h = hashlib.sha256()
        for p in self._sources():
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    @property
    def log_path(self) -> Path:
        return self.so_path.with_suffix(".log")

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Start nvcc unless the library exists; returns the process and
        the temporary output it writes (renamed into place when done)."""
        if self.so_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.so_path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        with open(self.log_path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT)
        return proc, tmp

    def finish_build(self,
                     build: Optional[Tuple[subprocess.Popen, Path]]) -> None:
        if build is None:
            return
        proc, tmp = build
        rc = proc.wait()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(rc {rc}):\n{self.log_path.read_text()}")
        os.replace(tmp, self.so_path)

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.so_path))
            for name, argtypes in {**self.functions,
                                   **self.helpers}.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _check(self, name: str, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib().kernel_error_string(err).decode()
            raise RuntimeError(f"{self.source.name}:{name} {what} failed: "
                               f"{msg} ({err})")

    def launch(self, name: str, *args, body: Optional[str] = None) -> None:
        """Call one exported launcher on the current stream; count it (and
        the kernel body it runs) and raise if the launch was refused."""
        err = getattr(self.lib(), name)(*args)
        self.launches_by_entry[name] += 1
        if body is not None:
            self.launches_by_body[body] += 1
        self._check(name, err, "launch")

    def call(self, name: str, *args) -> None:
        """Call one helper, which launches nothing; raise on an error."""
        self._check(name, getattr(self.lib(), name)(*args), "call")


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Build every library not yet built, one nvcc each, in parallel."""
    libs = list(libs)
    builds = [lib.start_build() for lib in libs]
    errors = []
    for lib, build in zip(libs, builds):
        try:
            lib.finish_build(build)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device as a ``cudaStream_t``
    (through torch's raw accessor where it has one: several times cheaper
    than building a ``torch.cuda.Stream``, and a half-step is short)."""
    if _RAW_STREAM is not None and t.device.index is not None:
        return ctypes.c_void_p(_RAW_STREAM(t.device.index))
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check_cuda_operands(*tensors: Optional[torch.Tensor]) -> None:
    """Every operand: float32, contiguous, on the first operand's device."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"operand on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"operand dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
