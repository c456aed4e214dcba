"""Fault-tolerant checkpointing.

  * atomic — write to a temporary name, ``fsync``, then ``os.replace`` and
    ``fsync`` the directory: a crash mid-save never corrupts the latest
    checkpoint;
  * async — :class:`CheckpointManager` saves on a background thread from
    host copies, so the caller blocks only for the device-to-host copy;
  * device-agnostic — tensors are saved by their path in the tree and
    restored onto whatever ``device`` the restarted job names;
  * bounded — the manager keeps the newest ``keep`` checkpoints.

Storage is a directory of ``.npz`` files plus ``meta.json`` per step (no
dependency beyond numpy).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..tree import flatten, unflatten


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so a rename survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic fs without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_slice_checkpoint(path: str, state) -> None:
    """Atomically persist a :class:`~repro_torch.core.distributed.
    SliceRangeCheckpoint` to ``path`` (.npz).

    Write to a temporary file, flush, ``os.fsync``, ``os.replace``, then
    fsync the directory: a host killed at any instant leaves either the
    previous complete checkpoint or the new one on disk — never a
    truncated file that would drop completed slice ids on resume (the
    resumed run would re-execute them and count them twice)."""
    iv = np.asarray(state._intervals(), dtype=np.int64).reshape(-1, 2)
    partial = _host(state.partial)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            n_slices=np.int64(state.n_slices),
            intervals=iv,
            partial=partial,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def load_slice_checkpoint(path: str):
    """Load a checkpoint written by :func:`save_slice_checkpoint`."""
    from ..core.distributed import SliceRangeCheckpoint  # lazy: no cycle

    with np.load(path) as z:
        n_slices = int(z["n_slices"])
        intervals = z["intervals"]
        partial = z["partial"]
    done = {(int(s), int(e)) for s, e in intervals}
    if partial.ndim == 0:
        partial = partial[()]
    return SliceRangeCheckpoint(n_slices, done, partial)


# numpy has no bfloat16: such tensors are stored as their raw 16-bit words
_VIEW_AS = {torch.bfloat16: torch.int16}


def _to_host(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Host copies of every leaf, with the torch dtypes numpy lacks
    stored as same-width integer views and named in ``exotic``."""
    flat: dict[str, np.ndarray] = {}
    exotic: dict[str, str] = {}
    for key, leaf in flatten(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.dtype in _VIEW_AS:
                exotic[key] = str(t.dtype).removeprefix("torch.")
                t = t.view(_VIEW_AS[t.dtype])
            flat[key] = t.cpu().numpy().copy()
        else:
            flat[key] = np.asarray(leaf)
    return flat, exotic


class CheckpointManager:
    """Numbered checkpoints of a nested dict/list/tuple/dataclass tree of
    tensors under ``directory``: ``step_<N>/arrays.npz`` and ``meta.json``.

    :meth:`save` copies the tree to the host synchronously, then writes
    on a background thread (``blocking=True`` writes in the caller); one
    save is in flight at a time, and a failed background save raises on
    the next :meth:`wait`.  The newest ``keep`` steps are kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()  # one in-flight save at a time
        host, exotic = _to_host(tree)  # device->host happens here

        def work():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                    np.savez(f, **host)
                    f.flush()
                    os.fsync(f.fileno())
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(
                        {"step": step, "keys": sorted(host),
                         "dtypes": exotic}, f
                    )
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                _fsync_dir(self.dir)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            self.check()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: int | None = None,
                device=None) -> Any:
        """Restore into the structure of ``template`` (the latest step by
        default).  Every leaf comes back as a tensor on ``device``
        (default: the CPU) — the elastic-restart path onto whatever card
        the restarted job has."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            data = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        exotic = meta.get("dtypes", {})
        leaves = {}
        for key, arr in data.items():
            t = torch.from_numpy(np.array(arr, order="C"))  # keeps 0-d
            if key in exotic:
                t = t.view(getattr(torch, exotic[key]))
            leaves[key] = t.to(device) if device is not None else t
        return unflatten(template, leaves)
