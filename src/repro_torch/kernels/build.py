"""Build and load the CUDA kernels of ``csrc/`` at first use.

``nvcc`` compiles ``csrc/gemm.cu`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with :mod:`ctypes` (no PyTorch headers,
so the build takes seconds).  The library goes to ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``), under a name that
carries a hash of the source, so an edited source is always rebuilt.
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

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "gemm.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit"
    )


def _declare(lib: ctypes.CDLL) -> None:
    lib.repro_error_string.argtypes = [_INT]
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.repro_tiled_gemm.argtypes = [_P, _P, _P, _I64, _I64, _I64, _I64, _P]
    lib.repro_tiled_gemm.restype = _INT
    lib.repro_fused_gemm.argtypes = [_P, _I64, _INT, _P, _P, _P, _P, _P, _P, _P]
    lib.repro_fused_gemm.restype = _INT
    lib.repro_chain_grid.argtypes = [_INT, _I64, ctypes.POINTER(_INT)]
    lib.repro_chain_grid.restype = _INT
    lib.repro_chain_gemm.argtypes = [
        _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _INT, _P,
    ]
    lib.repro_chain_gemm.restype = _INT


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256()
        for src in SOURCES:
            digest.update(src.read_bytes())
        for flag in NVCC_FLAGS:
            digest.update(flag.encode())
        out = BUILD_DIR / f"libreprogemm_{digest.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        BUILD_INFO.update(
            path=str(out), seconds=time.perf_counter() - t0, log=log
        )
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
