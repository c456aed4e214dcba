"""Elastic multi-host coordination: atomic slice-range claims + merged
checkpoints on a shared filesystem.

The fault-tolerance unit of the whole stack is the slice id
(:class:`~repro_torch.core.distributed.SliceRangeCheckpoint` tracks completed
*ids*, chunk-agnostically), which makes elasticity cheap: a host is just
a loop that claims id ranges, executes them, and persists its partial —
any host can die, join, or steal at range granularity.  This module is
the coordination substrate:

  * **claims** — ownership of a range is an ``O_CREAT | O_EXCL`` file
    create in ``claims/`` (atomic on POSIX and NFSv4+): exactly one host
    wins, which is precisely the :class:`~repro_torch.distributed.scheduler.
    Arbiter` contract, so work stealing across *processes* is the same
    code path as across threads;
  * **completion** — each host owns one checkpoint file
    (``hosts/host_<h>.npz``, single-writer) updated atomically via
    :func:`repro_torch.checkpoint.manager.save_slice_checkpoint` (temp +
    fsync + ``os.replace``) after every completed range: a kill at any
    instant leaves a consistent prefix of its work;
  * **merge** — :meth:`ClaimStore.merged` unions every host file into
    one :class:`SliceRangeCheckpoint` (interval union + partial sum);
    ``missing()`` of the merge is what a resumed run schedules, so a
    host joining or leaving mid-run steals exactly the ids nobody
    finished;
  * **stale-claim reclaim** — claims carry the run ``epoch``; a resumed
    run (higher epoch) deletes claims from dead epochs whose ranges were
    never completed, returning a crashed host's in-flight work to the
    pool.  Same-epoch claims are never reclaimed (their owner may be a
    live peer mid-execution).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..checkpoint.manager import (
    _fsync_dir,
    _host,
    load_slice_checkpoint,
    save_slice_checkpoint,
)
from ..obs import log as _log, metrics as _metrics
from .scheduler import Arbiter, SliceRange


class ClaimStore(Arbiter):
    """Filesystem-backed claim/checkpoint store for one sliced
    contraction (one ``(plan, arrays)`` run family).

    Layout under ``root``::

        claims/claim_<start>_<end>.json   # atomic ownership records
        hosts/host_<h>.npz                # per-host SliceRangeCheckpoint

    ``host`` is this process's stable identity (default: the
    ``torch.distributed`` rank, or 0 when no process group is up);
    ``epoch`` increments across restarts of the same logical run and
    gates stale-claim reclaim."""

    def __init__(
        self, root: str, n_slices: int, host: int | None = None, epoch: int = 0
    ):
        if host is None:
            from .transport import world  # lazy: transport imports torch

            host = world()[0]
        self.root = root
        self.n_slices = int(n_slices)
        self.host = int(host)
        self.epoch = int(epoch)
        self.claims_dir = os.path.join(root, "claims")
        self.hosts_dir = os.path.join(root, "hosts")
        os.makedirs(self.claims_dir, exist_ok=True)
        os.makedirs(self.hosts_dir, exist_ok=True)
        self._own_state = None  # lazily loaded own host checkpoint

    # ------------------------------------------------------------ claims
    def _claim_path(self, start: int, end: int) -> str:
        return os.path.join(self.claims_dir, f"claim_{start}_{end}.json")

    def try_claim(self, rng: SliceRange, host: int) -> bool:
        """Atomically claim ``[rng.start, rng.end)`` — True exactly once
        across every process sharing ``root`` (O_EXCL create)."""
        path = self._claim_path(rng.start, rng.end)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            os.write(
                fd,
                json.dumps(
                    {"host": int(host), "epoch": self.epoch,
                     "start": rng.start, "end": rng.end}
                ).encode(),
            )
            os.fsync(fd)
        finally:
            os.close(fd)
        return True

    def reclaim_stale(self) -> int:
        """Delete claims from *older epochs* whose ranges were never
        completed — the ids a dead host took to its grave go back to the
        pool for this run to steal.  Returns the number reclaimed."""
        merged = self.merged()
        done = merged._intervals()

        def covered(s: int, e: int) -> bool:
            return any(a <= s and e <= b for a, b in done)

        reclaimed = 0
        for name in sorted(os.listdir(self.claims_dir)):
            path = os.path.join(self.claims_dir, name)
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, json.JSONDecodeError):
                rec = None  # truncated claim (killed mid-write): reclaim
            if rec is not None and rec.get("epoch", -1) >= self.epoch:
                continue
            if rec is not None and covered(rec["start"], rec["end"]):
                continue  # completed work: claim is just a record now
            try:
                os.unlink(path)
                reclaimed += 1
            except FileNotFoundError:  # pragma: no cover - racing peer
                pass
        if reclaimed:
            _metrics.inc("elastic.claims_reclaimed", reclaimed)
            _log.info(
                f"reclaimed {reclaimed} stale claims (epoch < {self.epoch})",
                reclaimed=reclaimed,
            )
        return reclaimed

    # -------------------------------------------------------- completion
    def _host_path(self, host: int) -> str:
        return os.path.join(self.hosts_dir, f"host_{host}.npz")

    def _fresh_state(self):
        from ..core.distributed import SliceRangeCheckpoint  # lazy

        return SliceRangeCheckpoint(self.n_slices, set(), 0.0)

    def own_state(self):
        """This host's checkpoint (loaded once, then kept in memory — the
        host file is single-writer by construction)."""
        if self._own_state is None:
            path = self._host_path(self.host)
            if os.path.exists(path):
                self._own_state = load_slice_checkpoint(path)
            else:
                self._own_state = self._fresh_state()
        return self._own_state

    def complete(self, rng: SliceRange, partial_delta) -> None:
        """Record ``rng`` done with its partial-sum contribution and
        atomically persist this host's checkpoint.  The delta is added
        exactly once (the runner only executes ranges it claimed, and a
        claim is granted exactly once).  A device tensor delta comes to
        the host here."""
        state = self.own_state()
        state.partial = state.partial + _host(partial_delta)
        state.add_range(rng.start, rng.end)
        save_slice_checkpoint(self._host_path(self.host), state)
        _metrics.inc("elastic.ranges_completed")

    # ------------------------------------------------------------- merge
    def merged(self):
        """Union of every host's checkpoint: interval union + partial
        sum — the global run state any host (or a fresh resume) can
        derive alone.  Atomic per-file (``os.replace`` publishes whole
        checkpoints), so a concurrent reader sees a consistent, possibly
        slightly stale, snapshot."""
        state = self._fresh_state()
        if self._own_state is not None:
            state.done |= set(self._own_state._intervals())
            state.partial = state.partial + np.asarray(
                self._own_state.partial
            )
        for name in sorted(os.listdir(self.hosts_dir)):
            if not name.endswith(".npz"):
                continue
            h = int(name[len("host_"):-len(".npz")])
            if self._own_state is not None and h == self.host:
                continue  # in-memory copy is at least as fresh
            try:
                other = load_slice_checkpoint(
                    os.path.join(self.hosts_dir, name)
                )
            except (OSError, ValueError, KeyError):  # pragma: no cover
                continue  # mid-replace read on exotic fs: skip this pass
            state.done |= set(other._intervals())
            state.partial = state.partial + np.asarray(other.partial)
        state.done = set(state._intervals())
        return state

    def sync_dirs(self) -> None:
        """fsync both store directories (called once after setup so the
        directory entries themselves survive power loss)."""
        _fsync_dir(self.claims_dir)
        _fsync_dir(self.hosts_dir)
