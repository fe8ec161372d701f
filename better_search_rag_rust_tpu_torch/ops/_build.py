"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface, so it is compiled by ``nvcc`` alone into
a shared library of its own and loaded with ``ctypes`` — seconds, not the
minutes a build against PyTorch's headers takes. The libraries go to
``build/kernels/`` beside the package (listed in ``.gitignore``), each named
by a hash of its source and the flags, at first use in a process; a changed
source rebuilds. The first :func:`library` call starts one ``nvcc`` for every
source whose library is missing, all at once, and waits for them together.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: Per source (by library name): its file and the C signature of every entry
#: point, (restype, argtypes).
SOURCES = {
    "topk": (CSRC / "topk_kernels.cu", {
        "bsr_matmul_blockmax2": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
        "bsr_gather_rescore": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
        "bsr_matmul_blockmax": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
        "bsr_matmul_blockmax_only": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
        "bsr_gather_rows": (_I, [_P, _P, _I, _I, _I, ctypes.c_longlong, _P, _P]),
        "bsr_block_scores": (_I, [_P, _P, _I, _I, _I, _I, _P, _P]),
        "bsr_matmul_blockmax2x": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                       _P, _P, _P, _P, _P, _P, _P]),
        "bsr_gather_copy": (_I, [_P, _P, _I, _I, _I, _I, _P, _P]),
        "bsr_gather_rescore_mm": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
                                       _P, _P, _P]),
        "bsr_gather_cross": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
        "bsr_error_string": (ctypes.c_char_p, [_I]),
    }),
    "attention": (CSRC / "attention_kernels.cu", {
        "bsr_fused_attention": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P]),
        "bsr_fused_attention_qkv": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P]),
        "bsr_fused_attention_qkv_bwd": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P]),
        "bsr_error_string": (ctypes.c_char_p, [_I]),
    }),
}


class KernelLibrary:
    """One loaded kernel library plus what its build reported."""

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


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives, tagged by a hash of the
    source and the flags."""
    src = SOURCES[name][0].read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbsr_{name}_{tag}.so"


def build_all() -> Dict[str, tuple[Path, float, str]]:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together; returns {name: (library path, build seconds, compiler
    report)}."""
    results: Dict[str, tuple[Path, float, str]] = {}
    procs = {}
    for name, (source, _sig) in SOURCES.items():
        out = library_path(name)
        if out.exists():
            results[name] = (out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        procs[name] = (proc, tmp, out, source, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, source, t0) in procs.items():
        _stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {source}:\n"
                          f"{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        results[name] = (out, time.perf_counter() - t0, stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


_LIBRARIES: Dict[str, KernelLibrary] = {}
_BUILT: Dict[str, tuple[Path, float, str]] = {}
#: Serializes the first build and load: a server's threads (connections, the
#: batcher's former) may reach their first search together, and two
#: concurrent ``build_all`` calls would race on the same ``{pid}.tmp`` file.
_LOCK = threading.Lock()


def library(name: str = "topk") -> KernelLibrary:
    """The process's kernel library ``name``, every missing library built
    (in parallel) and this one loaded on first call; thread-safe."""
    lib = _LIBRARIES.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        return _load(name)


def _load(name: str) -> KernelLibrary:
    if name not in _LIBRARIES:
        if name not in _BUILT:
            _BUILT.update(build_all())
        path, build_s, log = _BUILT[name]
        lib = ctypes.CDLL(str(path))
        for fn_name, (restype, argtypes) in SOURCES[name][1].items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIBRARIES[name] = KernelLibrary(lib, path, build_s, log)
    return _LIBRARIES[name]
