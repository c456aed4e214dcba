"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, loaded with
:mod:`ctypes` (no PyTorch headers, so a build takes seconds).
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them together.  The libraries go to ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), under names that carry a hash of
the source, every header it includes from ``csrc/`` and the flags, so
an edited source or header is always rebuilt.  Nothing here runs at
import time.

The wgmma kernels encode TMA tensor maps with ``cuTensorMapEncodeTiled``,
which lives in ``libcuda``, not in the CUDA runtime: ``csrc/hopper.cuh``
fetches it at run time with ``cudaGetDriverEntryPoint``, so the libraries
link the CUDA runtime only and the ``nvcc`` line carries no ``-lcuda``.
:func:`kernels_with` reads a built library's SASS with ``cuobjdump`` and
tells whether a kernel holds an instruction (``HGMMA`` for ``wgmma``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARIES = {
    "gemm": CSRC / "gemm.cu",
    "flash_attention": CSRC / "flash_attention.cu",
    "mamba2_ssd": CSRC / "mamba2_ssd.cu",
}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}  # library name -> path, seconds, log

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_F32 = ctypes.c_float


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise RuntimeError(
        f"{name} not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit"
    )


def _nvcc() -> str:
    return _tool("nvcc")


def _declare_gemm(lib: ctypes.CDLL) -> None:
    lib.repro_fused_gemm.argtypes = [_P, _P, _INT, _INT, _INT, _I64, _P, _P,
                                     _P, _INT, _INT, _P]
    lib.repro_fused_gemm.restype = _INT
    lib.repro_chain_smem.argtypes = [_INT]
    lib.repro_chain_smem.restype = _INT
    lib.repro_chain_gemm.argtypes = [_P, _INT, _INT, _INT, _P]
    lib.repro_chain_gemm.restype = _INT
    lib.repro_chain_cluster_max.argtypes = [_INT, ctypes.POINTER(_INT)]
    lib.repro_chain_cluster_max.restype = _INT
    lib.repro_empty_cluster.argtypes = [_INT, _INT, _P]
    lib.repro_empty_cluster.restype = _INT


def _declare_flash_attention(lib: ctypes.CDLL) -> None:
    lib.repro_flash_attention.argtypes = [
        _P, _P, _P, _P, _P, _INT, _I64, _INT, _INT, _INT, _INT, _INT, _F32,
        _INT, _INT, _P,
    ]
    lib.repro_flash_attention.restype = _INT
    lib.repro_flash_attention_bwd.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _INT, _I64, _INT, _INT,
        _INT, _INT, _INT, _F32, _INT, _INT, _P,
    ]
    lib.repro_flash_attention_bwd.restype = _INT
    lib.repro_flash_attention_bwd_mma.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT,
        _INT, _F32, _INT, _INT, _P,
    ]
    lib.repro_flash_attention_bwd_mma.restype = _INT


def _declare_mamba2_ssd(lib: ctypes.CDLL) -> None:
    lib.repro_ssd_chunk_smem.argtypes = [_INT, _INT, _INT]
    lib.repro_ssd_chunk_smem.restype = _I64
    lib.repro_ssd_chunk.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _INT, _P,
    ]
    lib.repro_ssd_chunk.restype = _INT
    lib.repro_ssd_chunk_wgmma.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _INT, _I64, _INT,
        _P,
    ]
    lib.repro_ssd_chunk_wgmma.restype = _INT
    lib.repro_ssd_chunk_bwd_smem.argtypes = [_INT, _INT, _INT]
    lib.repro_ssd_chunk_bwd_smem.restype = _I64
    lib.repro_ssd_chunk_bwd.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT,
        _INT, _INT, _INT, _INT, _P,
    ]
    lib.repro_ssd_chunk_bwd.restype = _INT
    lib.repro_ssd_chunk_bwd_wgmma_smem.argtypes = [_INT]
    lib.repro_ssd_chunk_bwd_wgmma_smem.restype = _I64
    lib.repro_ssd_chunk_bwd_wgmma.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT,
        _INT, _INT, _INT, _I64, _INT, _P,
    ]
    lib.repro_ssd_chunk_bwd_wgmma.restype = _INT


_DECLARE = {
    "gemm": _declare_gemm,
    "flash_attention": _declare_flash_attention,
    "mamba2_ssd": _declare_mamba2_ssd,
}


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """The source of library ``name`` and every header it includes from
    ``csrc/``, transitively, in first-include order."""
    seen: list[Path] = []
    todo = [LIBRARIES[name]]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            dep = path.parent / inc
            if dep.exists():
                todo.append(dep)
    return seen


def _out_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    return BUILD_DIR / f"librepro_{name}_{digest.hexdigest()[:16]}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.argtypes = [_INT]
    lib.repro_error_string.restype = ctypes.c_char_p
    _DECLARE[name](lib)
    _libs[name] = lib
    return lib


def build_all(names=None) -> dict[str, dict]:
    """Build (one ``nvcc`` per source, started together) and load the
    libraries ``names`` (default: all); returns :data:`BUILD_INFO`."""
    names = list(LIBRARIES) if names is None else list(names)
    with _lock:
        todo = [n for n in names if n not in _libs]
        t0 = time.perf_counter()
        missing = [n for n in todo if not _out_path(n).exists()]
        nvcc = _nvcc() if missing else ""
        procs = {}
        for name in missing:
            out = _out_path(name)
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(LIBRARIES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ), tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        seconds = time.perf_counter() - t0
        for name in todo:
            out = _out_path(name)
            _load(name, out)
            BUILD_INFO[name] = dict(
                path=str(out), seconds=seconds, log=logs.get(name, "")
            )
    return BUILD_INFO


def kernels_with(name: str, kernel: str, opcode: str) -> dict[str, bool]:
    """For each instantiation of CUDA kernel ``kernel`` in library
    ``name`` (built on first call), keyed by its mangled name, whether
    its SASS holds ``opcode``, as ``cuobjdump -sass`` prints it."""
    load_library(name)
    out = subprocess.run(
        [_tool("cuobjdump"), "-sass", str(_out_path(name))],
        capture_output=True, text=True, check=True,
    ).stdout
    mangled = f"{len(kernel)}{kernel}"  # Itanium ABI: length, then name
    found: dict[str, bool] = {}
    fn = None
    for line in out.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            fn = head.group(1) if mangled in head.group(1) else None
            if fn is not None:
                found.setdefault(fn, False)
        elif fn is not None and opcode in line:
            found[fn] = True
    return found


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of kernel source ``name``, built on first call."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def on_cpu(*tensors) -> bool:
    """True when every tensor is on the CPU (a wrapper then runs its
    plain version), False when every tensor is on one CUDA device (it
    launches its kernel); anything else is refused."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors on unsupported devices: {sorted(kinds)}")


def cuda_stream(device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
