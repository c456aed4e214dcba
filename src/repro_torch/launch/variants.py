"""Build edited copies of one kernel source and swap them into its
wrapper, for the scripts that time where a kernel's time goes
(``fused_variants``, ``ssd_variants``). Needs ``nvcc``."""

from __future__ import annotations

import hashlib
import subprocess
from pathlib import Path
from typing import Callable, Iterable

from repro_torch.kernels import build


def edit(src: str, old: str, new: str) -> str:
    """``src`` with ``old`` replaced by ``new``; raises if ``old`` is
    not in it (the source moved on and the variant no longer applies)."""
    if old not in src:
        raise RuntimeError(f"variant edit does not apply: {old!r}")
    return src.replace(old, new)


def build_variants(lib: str, names: Iterable[str],
                   variant_source: Callable[[str, str], str]) -> dict[str, Path]:
    """Compile ``variant_source(name, source)`` of ``csrc/<lib>.cu`` for
    each name, one ``nvcc`` each, all started together, into
    ``build/kernels/variants/``; returns each name's library."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = variant_source(name, src)
        tag = hashlib.sha256(text.encode()).hexdigest()[:12]
        cu = out_dir / f"{lib}_{name}_{tag}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = so
    return libs


def use(lib: str, path: Path | None) -> None:
    """Make ``lib``'s wrappers launch the library at ``path``; ``None``
    drops it, so the next call loads the library built from the source."""
    if path is None:
        build._libs.pop(lib, None)
    else:
        build._load(lib, path)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
