"""Build and load the hand-written CUDA kernels (``csrc/topk_kernels.cu``).

The source has a plain C interface, so it is compiled by ``nvcc`` alone into
a shared library and loaded with ``ctypes`` — seconds, not the minutes a
build against PyTorch's headers takes. The library goes to
``build/kernels/`` beside the package (listed in ``.gitignore``), named by a
hash of the source and flags, at first use in a process; a changed source
rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "topk_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of every entry point: (restype, argtypes).
_SIGNATURES = {
    "bsr_matmul_blockmax2": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "bsr_gather_rescore": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
    "bsr_matmul_blockmax": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "bsr_error_string": (ctypes.c_char_p, [_I]),
}


class KernelLibrary:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float, log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s  #: 0.0 when an up-to-date library was reused
        self.log = log          #: nvcc's -Xptxas -v report (registers, spills)

    def check(self, name: str, err: int) -> None:
        """Raise on a non-zero ``cudaGetLastError()`` from an entry point."""
        if err:
            msg = self.lib.bsr_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({err})")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, float, str]:
    """Compile the source unless a library for it already exists; returns
    (library path, build seconds, compiler report)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libbsr_topk_{tag}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, time.perf_counter() - t0, proc.stderr


_LIBRARY: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The process's kernel library, built and loaded on first call."""
    global _LIBRARY
    if _LIBRARY is None:
        path, build_s, log = build()
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIBRARY = KernelLibrary(lib, path, build_s, log)
    return _LIBRARY
