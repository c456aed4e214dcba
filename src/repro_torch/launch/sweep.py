"""Run the whole dry-run matrix, one process per cell, skipping cells
whose record already exists.

The port's twin of the reference's ``repro.launch.sweep``: single-pod
first, the smallest architectures first; llama3-405b trains with int8
moments (its fp32 variant is run on its own).  A cell's record is a JSON
file of ``repro_torch.launch.dryrun`` under ``--out``; a record without
an error is not run again.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out build/dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ..obs import log as obs_log
from .dryrun import cell_tag

ORDER = [
    "mamba2-130m",
    "seamless-m4t-medium",
    "llama3.2-3b",
    "qwen3-4b",
    "zamba2-7b",
    "deepseek-7b",
    "deepseek-moe-16b",
    "qwen2-vl-72b",
    "llama4-scout-17b-a16e",
    "llama3-405b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def sweep(out: str, meshes=("single", "multi"), archs=ORDER, shapes=SHAPES,
          timeout: float = 1800) -> dict:
    """Every (mesh, arch, shape) cell not yet recorded under ``out``,
    each through the dry run's command line in a process of its own.
    Returns the counts ``{"ok", "fail", "cached"}``."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=SRC)
    counts = {"ok": 0, "fail": 0, "cached": 0}
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                moments = ("int8" if arch == "llama3-405b"
                           and shape == "train_4k" else "float32")
                tag = cell_tag(arch, shape, mesh, moments)
                path = os.path.join(out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        if "error" not in json.load(f):
                            obs_log.info(f"CACHED {tag}", tag=tag)
                            counts["cached"] += 1
                            continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", out, "--moments", moments]
                try:
                    r = subprocess.run(cmd, env=env, timeout=timeout,
                                       capture_output=True, text=True)
                except subprocess.TimeoutExpired:
                    obs_log.warning(f"TIMEOUT {tag}", tag=tag)
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                                   "error": "timeout"}, f)
                    counts["fail"] += 1
                    continue
                lines = (r.stdout + r.stderr).strip().splitlines()
                obs_log.info(lines[-1] if lines else f"?? {tag}", tag=tag)
                counts["ok" if r.returncode == 0 else "fail"] += 1
    obs_log.info(f"done: ok={counts['ok']} fail={counts['fail']} "
                 f"cached={counts['cached']}", **counts)
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    counts = sweep(args.out, meshes, timeout=args.timeout)
    return 1 if counts["fail"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
