"""Build and load the package's native libraries at first use.

Each :class:`Library` compiles its sources from ``csrc/`` into
BUILD_DIR with nvcc (the CUDA kernels) or g++ (the host MQ replay),
names the shared library by the hash of its sources, headers and
flags, and loads it with ctypes. A failed build raises with the
compiler's output; nothing falls back to another implementation. Every
compile and every load is counted per library by the build sentinel
(analysis/retrace.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from ..analysis import retrace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"   # where nvcc is when not on PATH


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if not os.path.exists(NVCC_DEFAULT):
        raise RuntimeError("nvcc not found on PATH or at " + NVCC_DEFAULT
                           + "; the CUDA kernels cannot be built")
    return NVCC_DEFAULT


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH; the host MQ replay "
                           "library cannot be built")
    return found


class Library:
    """One shared library built from ``sources`` (file names under
    ``csrc/``; headers are hashed, not compiled). ``functions`` maps each
    exported symbol to its (argtypes, restype). ``launches`` counts the
    kernel launches its wrapper made (:meth:`count_launch`, under a lock
    of its own: launches come from many threads)."""

    def __init__(self, name: str, sources: tuple, functions: dict,
                 cuda: bool = True) -> None:
        self.name = name
        self.sources = tuple(os.path.join(CSRC, s) for s in sources)
        self.functions = functions
        self.cuda = cuda
        self.launches = 0
        self.build_seconds = 0.0
        self.build_log = ""        # compiler output: registers, smem, spills
        self._lib = None
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()

    def count_launch(self) -> None:
        """Add one to ``launches``."""
        with self._count_lock:
            self.launches += 1

    def _flags(self) -> tuple:
        return NVCC_FLAGS if self.cuda else GXX_FLAGS

    def path(self) -> str:
        """Where this source set's library lives once built."""
        h = hashlib.sha256(" ".join(self._flags()).encode())
        for src in self.sources:
            with open(src, "rb") as fh:
                h.update(fh.read())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{h.hexdigest()[:12]}.so")

    def build(self) -> str:
        """Compile the library if this source set has none yet; return
        its path."""
        with self._lock:
            return self._build_locked()

    def _build_locked(self) -> str:
        lib = self.path()
        if os.path.exists(lib):
            return lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        units = [s for s in self.sources if not s.endswith((".cuh", ".h"))]
        cmd = [_nvcc() if self.cuda else _gxx(), *self._flags(),
               "-I", CSRC, "-o", tmp, *units]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"building {self.name} failed:\n"
                               + self.build_log)
        os.replace(tmp, lib)
        retrace.record_build(self.name)
        return lib

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if needed, with every
        function's argtypes and restype declared."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self._build_locked())
                retrace.record_load(self.name)
                for sym, (argtypes, restype) in self.functions.items():
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = restype
                self._lib = lib
            return self._lib


def kernel_library(name: str, sources: tuple, n_ptrs_in: int,
                   n_ints: int, n_ptrs_out: int,
                   occupancy: bool = False) -> Library:
    """A CUDA kernel library whose entry ``<name>_launch`` takes input
    pointers, int scalars, output pointers and the stream, and returns
    the CUDA error code of the launch. With ``occupancy`` it also
    exports ``<name>_occupancy(L, int *blocks_per_sm)`` (see
    :func:`resident_blocks`)."""
    argtypes = ([ctypes.c_void_p] * n_ptrs_in + [ctypes.c_int] * n_ints
                + [ctypes.c_void_p] * (n_ptrs_out + 1))
    functions = {f"{name}_launch": (argtypes, ctypes.c_int)}
    if occupancy:
        functions[f"{name}_occupancy"] = (
            [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int)
    return Library(name, sources, functions)


def cuda_device(device) -> torch.device:
    """``device`` as a CUDA device with its index: a bare "cuda" is the
    calling thread's current device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def resident_blocks(kernel: Library, L: int, device="cuda") -> int:
    """Thread blocks of ``kernel`` that one SM of ``device`` holds at
    once at plane budget ``L``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    out = ctypes.c_int(0)
    fn = getattr(kernel.library(), f"{kernel.name}_occupancy")
    # The C call queries the thread's current device.
    with torch.cuda.device(cuda_device(device)):
        err = fn(L, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{kernel.name} occupancy query failed: CUDA "
                           f"error {err}")
    return out.value


def launch(kernel: Library, fn_args: tuple, device) -> None:
    """Launch ``kernel`` on ``device``'s current stream after the
    capability check; raise on a refused launch; count it. The C launch
    runs in the calling thread's current CUDA device, so the call is
    made with ``device`` current: a thread whose current device is
    another card would pair that card with this device's stream."""
    from .support import require_kernels

    require_kernels(device)
    device = cuda_device(device)
    fn = getattr(kernel.library(), f"{kernel.name}_launch")
    with torch.cuda.device(device):
        err = fn(*fn_args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} launch failed: CUDA error {err}")
    kernel.count_launch()


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype, shape,
                 device) -> None:
    """Raise unless ``t`` is what the kernel takes: a contiguous tensor
    of this dtype and shape on this device."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)} on {device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
