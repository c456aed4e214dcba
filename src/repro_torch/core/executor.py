"""PyTorch execution of sliced contraction trees.

The planner (pathfinder/slicing/tuning/merging) emits a contraction tree
plus a slicing bitmask ``S``; a :class:`ContractionPlan` turns that into
a step program run eagerly on the plan's device:

  * each of the ``2^|S|`` subtasks fixes the sliced indices to one bit
    assignment on the leaf tensors,
  * subtasks run one after another and their results are summed — the
    paper's single all-reduce, here a running sum on the device.

**Two-phase (hoisted) execution.**  The paper's Eq. 4 localizes slicing
overhead to the contractions whose lifetime-closure touches a sliced
index; every other node computes the identical tensor in all ``2^|S|``
subtasks.  :mod:`repro_torch.lowering.partition` splits the tree
accordingly: the slice-invariant prologue runs **once per session** on
the full leaf tensors, and only the slice-dependent epilogue runs per
slice, consuming the hoisted buffers.  ``hoist=False`` is the off-switch
back to the full-tree-per-slice path; both modes are exact and agree to
numerical precision.

Open output indices are first-class: when the network declares
``open_inds``, every slice contributes a *tensor* of amplitudes — one
axis per open index, axes in ``tn.open_inds`` order — so one sliced
contraction produces ``2^k`` correlated amplitudes.

Two execution backends share the slice machinery: ``backend="gemm"``
(the default) compiles the tree through :mod:`repro_torch.lowering` into
an explicit kernel schedule — each node normalized to GEMM form and
refined onto the tiled / fused / chain kernels, ``torch.matmul`` or
``torch.einsum`` — while ``backend="einsum"`` is the oracle path that
lowers every node to ``torch.einsum``.
"""

from __future__ import annotations

import dataclasses
import string
import threading
from typing import Sequence

import numpy as np
import torch

from ..hardware import DEFAULT_HARDWARE, Hardware
from ..obs import metrics as _metrics, trace as _trace
from .contraction_tree import ContractionTree
from .tensor_network import TensorNetwork, bits

_LETTERS = string.ascii_letters

BACKENDS = ("einsum", "gemm")


def default_backend() -> str:
    """Execution backend when none is requested: the lowered kernel
    schedule.  (The reference reads ``REPRO_BACKEND`` and defaults to its
    einsum oracle; the port reads no environment variable.)"""
    return "gemm"


def default_hoist() -> bool:
    """Two-phase (slice-invariant hoisted) execution when no ``hoist=``
    is requested: on.  ``hoist=False`` is the off-switch."""
    return True


class ExecutionCounter:
    """How many step programs (:meth:`ContractionPlan._run_steps`) run at
    once on one device, and the most that ever did since :meth:`reset`.
    It watches the executor itself, independently of the execution gate
    (:func:`repro_torch.engine.session.execution_gate`) that should keep
    it at one."""

    def __init__(self):
        self._lock = threading.Lock()
        self.now = 0
        self.peak = 0

    def __enter__(self):
        with self._lock:
            self.now += 1
            self.peak = max(self.peak, self.now)
        return self

    def __exit__(self, *exc):
        with self._lock:
            self.now -= 1
        return False

    def reset(self) -> None:
        with self._lock:
            self.peak = self.now


def device_key(device) -> torch.device:
    """``device`` with its index made explicit (``cuda`` is ``cuda:0``),
    so per-device registries see one key per card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


_RUNNING: dict[torch.device, ExecutionCounter] = {}
_RUNNING_LOCK = threading.Lock()


def running(device) -> ExecutionCounter:
    """The :class:`ExecutionCounter` of ``device``."""
    dev = device_key(device)
    with _RUNNING_LOCK:
        return _RUNNING.setdefault(dev, ExecutionCounter())


def auto_slice_batch(requested: int, n_slices: int) -> int:
    """Clamp the requested slice batch to the slice count (any batch size
    works: a ragged final batch is padded and masked)."""
    return max(1, min(int(requested), n_slices))


def resolve_device(device) -> torch.device:
    """The execution device; a CUDA device with no GPU present raises
    rather than running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def exact_fp32_matmul() -> None:
    """Keep library float32 products in full fp32 on the card: no TF32
    in ``torch.matmul`` (the ``dot`` steps) nor in cuDNN.  The reference's
    fp32 path is exact fp32; the tiled and fused kernels (K1, K2) run
    3xTF32 on the tensor cores, which keeps about 22 of fp32's 24
    mantissa bits per product, and the chain kernel (K3) fp32 FFMA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pair_contract_inds(
    inds_a: Sequence, inds_b: Sequence, open_inds: frozenset
) -> tuple[tuple, tuple]:
    """(contracted, out) index tuples for a pairwise contraction, with the
    deterministic ordering convention shared by planner and executor."""
    sa, sb = set(inds_a), set(inds_b)
    contracted = tuple(
        ix for ix in inds_a if ix in sb and ix not in open_inds
    )
    out = tuple(ix for ix in inds_a if ix not in contracted) + tuple(
        ix for ix in inds_b if ix not in contracted and ix not in sa
    )
    return contracted, out


def einsum_expr(inds_a, inds_b, inds_out) -> str:
    local: dict = {}

    def lab(ix):
        if ix not in local:
            local[ix] = _LETTERS[len(local)]
        return local[ix]

    return (
        "".join(lab(i) for i in inds_a)
        + ","
        + "".join(lab(i) for i in inds_b)
        + "->"
        + "".join(lab(i) for i in inds_out)
    )


def simplify_network(
    tn: TensorNetwork, arrays: list[np.ndarray]
) -> tuple[TensorNetwork, list[np.ndarray]]:
    """Absorb rank-1/2 tensors into neighbours (gate fusion), keeping the
    arrays in sync — the Cotengra-style pre-processing the paper applies
    before planning."""
    open_set = frozenset(tn.open_inds)
    inputs = [list(t) for t in tn.inputs]
    arrs = [np.asarray(a) for a in arrays]
    alive = [True] * len(inputs)
    changed = True
    while changed:
        changed = False
        by_ind: dict = {}
        for i, t in enumerate(inputs):
            if alive[i]:
                for ix in t:
                    by_ind.setdefault(ix, []).append(i)
        for i, t in enumerate(inputs):
            if not alive[i] or len(t) > 2:
                continue
            closed = [ix for ix in t if ix not in open_set]
            if not closed:
                continue
            partners = [j for j in by_ind.get(closed[0], []) if j != i and alive[j]]
            if not partners:
                continue
            j = partners[0]
            _, out = pair_contract_inds(inputs[j], t, open_set)
            expr = einsum_expr(inputs[j], t, out)
            arrs[j] = np.einsum(expr, arrs[j], arrs[i])
            inputs[j] = list(out)
            alive[i] = False
            changed = True
            break
    new_inputs = [t for i, t in enumerate(inputs) if alive[i]]
    new_arrays = [a for i, a in enumerate(arrs) if alive[i]]
    return TensorNetwork(new_inputs, tn.open_inds, tn.ind_sizes), new_arrays


@dataclasses.dataclass
class _Step:
    lhs: int  # env key
    rhs: int
    out: int
    expr: str
    inds_lhs: tuple = ()
    inds_rhs: tuple = ()
    inds_out: tuple = ()


class ContractionPlan:
    """Compiled sliced-contraction program for one (tree, S) pair.

    ``backend="gemm"`` lowers every step through :mod:`repro_torch.
    lowering` into a refined kernel schedule (``self.schedule``) and
    plans fused chains over it; ``backend="einsum"`` is the oracle.
    ``dtype`` informs the refiner's cost model; ``hw`` is the card the
    refiner prices against; ``fused=False`` keeps the refiner off the
    fused kernel (every kernel-sized step then goes to the tiled
    kernel).  Tensors are executed on ``device`` (default ``"cuda"``).

    ``precision`` selects the mixed-precision mode of the schedule
    (:mod:`repro_torch.lowering.precision`): ``"auto"`` demotes kernel
    steps to bf16 inputs with fp32 accumulation while the predicted
    Linear-XEB fidelity loss stays within ``fidelity_tol`` (default
    0.05); ``"bf16"`` demotes every eligible step; ``"fp32"`` (the
    default) leaves the plan as refined.  ``precisions`` (one per step)
    carries another plan's assignment instead.  A node whose every
    consumer reads bf16 is stored as bf16 (re, im) pairs: a ``torch.bfloat16``
    tensor with a trailing axis of 2 (see :func:`repro_torch.kernels.
    ref.to_pairs16`).  Only ``backend="gemm"`` carries a precision.

    ``hoist_cache_size`` and ``hoist_cache_bytes`` bound the plan's
    :class:`~repro_torch.lowering.cache.HoistCache` of materialized
    prologues (entries, and summed bytes; ``None`` is unbounded).
    """

    def __init__(
        self,
        tree: ContractionTree,
        smask: int = 0,
        backend: str = "gemm",
        dtype=torch.complex64,
        precision: str = "fp32",
        device="cuda",
        hw: Hardware = DEFAULT_HARDWARE,
        fused: bool = True,
        fidelity_tol: float | None = None,
        precisions=None,
        hoist_cache_size: int = 8,
        hoist_cache_bytes: int | None = None,
    ):
        from ..lowering.cache import HoistCache  # lazy: avoid cycle
        from ..lowering.precision import DEFAULT_FIDELITY_TOL, check_mode

        self.precision_mode = check_mode(precision)
        self.fidelity_tol = (
            DEFAULT_FIDELITY_TOL if fidelity_tol is None else float(fidelity_tol)
        )
        self.device = resolve_device(device)
        self.tree = tree
        tn = tree.tn
        self.tn = tn
        space = tn.space
        self.smask = smask
        self.sliced_bits = list(bits(smask))
        self.num_sliced = len(self.sliced_bits)
        slicepos = {b: i for i, b in enumerate(self.sliced_bits)}
        sliced_labels = {space.labels[b] for b in self.sliced_bits}
        open_set = frozenset(tn.open_inds)

        # leaf slicing specs: (axis, slice position) — applied high-axis
        # first so earlier axes stay valid.
        self.leaf_specs: list[list[tuple[int, int]]] = []
        node_inds: dict[int, tuple] = {}
        for i, inds in enumerate(tn.inputs):
            spec = [
                (ax, slicepos[space.bit(ix)])
                for ax, ix in enumerate(inds)
                if ix in sliced_labels
            ]
            spec.sort(reverse=True)
            self.leaf_specs.append(spec)
            node_inds[i] = tuple(ix for ix in inds if ix not in sliced_labels)

        self.steps: list[_Step] = []
        for v in tree.contract_order():
            l, r = tree.children[v]
            _, out = pair_contract_inds(node_inds[l], node_inds[r], open_set)
            expr = einsum_expr(node_inds[l], node_inds[r], out)
            node_inds[v] = out
            self.steps.append(
                _Step(l, r, v, expr, node_inds[l], node_inds[r], out)
            )
        self.root = tree.root
        raw_out = node_inds[self.root]
        # canonicalize: output axes follow tn.open_inds declaration order
        want = tuple(ix for ix in tn.open_inds if ix in raw_out)
        self.out_perm = tuple(raw_out.index(ix) for ix in want)
        self.out_inds = want if want else raw_out

        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.backend = backend
        self.dtype = dtype
        self.hw = hw
        self.schedule = None
        if self.backend == "gemm":
            from ..lowering import refine_schedule  # lazy: avoid cycle

            self.schedule = refine_schedule(
                [(s.inds_lhs, s.inds_rhs, s.inds_out) for s in self.steps],
                tn.size_of,
                dtype=dtype,
                fused=fused,
                hw=hw,
            )

        # two-phase partition: slice-invariant prologue steps (run once
        # per session) vs slice-dependent epilogue steps (run per slice).
        self.partition = None
        self.prologue_idx: tuple[int, ...] = ()
        self.epilogue_idx: tuple[int, ...] = tuple(range(len(self.steps)))
        self.hoisted_nodes: tuple[int, ...] = ()
        self.prologue_leaves: tuple[int, ...] = ()
        self.epilogue_leaves: tuple[int, ...] = tuple(range(tn.num_tensors))
        if self.num_sliced and self.steps:
            from ..lowering.partition import partition_tree  # lazy: cycle

            part = partition_tree(tree, smask)
            pos = {st.out: k for k, st in enumerate(self.steps)}
            self.partition = part
            self.prologue_idx = tuple(pos[v] for v in part.invariant_nodes)
            self.epilogue_idx = tuple(pos[v] for v in part.epilogue_nodes)
            self.hoisted_nodes = part.hoisted_nodes
            self.prologue_leaves = part.prologue_leaves
            self.epilogue_leaves = part.epilogue_leaves
        # mixed-precision assignment: after the partition (epilogue steps
        # weigh 2^|S| in the greedy order) and before the memory and
        # chain plans (their bytes must see the storage precision)
        self._itemsize_of: dict[int, int] | None = None
        self.store16: frozenset[int] = frozenset()
        if self.schedule is not None and (
            self.precision_mode != "fp32" or precisions is not None
        ):
            from ..lowering.precision import (  # lazy: avoid cycle
                assign_precision,
                carry_precisions,
                storage_itemsizes,
            )

            if precisions is not None:
                self.schedule = carry_precisions(
                    self.schedule, tuple(precisions),
                    mode=self.precision_mode, fidelity_tol=self.fidelity_tol,
                    fused=fused, hw=hw,
                )
            else:
                self.schedule = assign_precision(
                    self.schedule,
                    mode=self.precision_mode,
                    fidelity_tol=self.fidelity_tol,
                    epilogue_positions=(
                        self.epilogue_idx if self.num_sliced else None
                    ),
                    n_slices=1 << self.num_sliced,
                    fused=fused,
                    hw=hw,
                )
            if self.schedule.precision_counts().get("bf16"):
                self._itemsize_of = storage_itemsizes(
                    [(s.lhs, s.rhs, s.out) for s in self.steps],
                    self.schedule.specs,
                    dtype,
                    tree.emask,
                )
                full = dtype.itemsize
                # the step outputs held at half width (leaves stay as
                # the caller gave them; the planner counts them at half
                # width, a rounding their consumers apply anyway)
                self.store16 = frozenset(
                    s.out for s in self.steps
                    if self._itemsize_of.get(s.out, full) < full
                )
        self._memory_plan = None
        # fusion-boundary pass: runs of adjacent schedule steps whose
        # certified live set fits the chain budget execute as single
        # chain-kernel calls, planned per execution segment so a chain
        # never crosses the prologue/epilogue boundary.
        self.chain_plan = None
        self._chain_dispatch: dict[str, dict] = {}
        if self.schedule is not None and self.steps:
            from ..lowering.refiner import plan_chains  # lazy: avoid cycle

            mem = self.memory_plan()
            segments = {"naive": tuple(range(len(self.steps)))}
            if self.partition is not None:
                if self.prologue_idx:
                    segments["prologue"] = self.prologue_idx
                segments["epilogue"] = self.epilogue_idx
            step_nodes = tuple((s.lhs, s.rhs, s.out) for s in self.steps)
            self.chain_plan = plan_chains(
                self.schedule, step_nodes, segments, mem.naive.nbytes, hw=hw,
                itemsize_of=self._itemsize_of,
            )
            self._chain_dispatch = {
                name: self.chain_plan.by_segment(name) for name in segments
            }
        # materialized prologue tensors, LRU-keyed by the leaf tensors
        # the prologue consumes (cross-call reuse: repeated requests on
        # one network family skip the prologue)
        self._hoist_cache = HoistCache(
            maxsize=hoist_cache_size, max_bytes=hoist_cache_bytes
        )
        if self.chain_plan is not None:
            _metrics.inc("plan.chains_fused", self.chain_plan.num_multi)
            _metrics.inc(
                "plan.chain_hbm_bytes_saved",
                self.chain_plan.hbm_bytes_saved("naive"),
            )

    # ------------------------------------------------------------------
    def out_shape(self) -> tuple[int, ...]:
        """Shape of the contraction output (one axis per open index)."""
        return tuple(self.tn.size_of(ix) for ix in self.out_inds)

    # ------------------------------------------------------------------
    # two-phase (hoisted) execution metrics
    # ------------------------------------------------------------------
    @property
    def can_hoist(self) -> bool:
        """True when the partition found slice-invariant contractions to
        hoist out of the slice loop."""
        return bool(self.prologue_idx)

    @property
    def invariant_fraction(self) -> float:
        """Fraction of the dense tree cost C(B) that is slice-invariant."""
        return self.partition.invariant_fraction if self.partition else 0.0

    def executed_overhead(self, hoist: bool = True) -> float:
        """Executed-FLOPs overhead over the dense C(B) for the chosen
        execution mode: Eq. 4 for the naive full-tree-per-slice path, the
        prologue + 2^|S|·epilogue cost under hoisting."""
        if self.num_sliced == 0:
            return 1.0
        if hoist and self.partition is not None and self.can_hoist:
            return self.partition.hoisted_overhead()
        return self.tree.slicing_overhead(self.smask)

    def executed_flops(
        self, n_slices: int | None = None, hoist: bool = True
    ) -> float:
        """FLOPs actually executed when contracting ``n_slices`` subtasks
        (default: all ``2^|S|``) under the chosen mode — the quantity the
        obs layer accumulates into ``exec.flops_executed``.  Hoisted:
        one prologue plus ``n`` epilogues; naive: ``n`` full subtasks."""
        total = 1 << self.num_sliced
        n = total if n_slices is None else n_slices
        if hoist and self.partition is not None and self.can_hoist:
            p = self.partition
            return p.invariant_cost + p.per_slice_cost * n
        return self.tree.sliced_cost(self.smask) / total * n

    def hoist_summary(self) -> str:
        """One-line two-phase summary for the examples."""
        return (
            f"hoist: inv_frac={self.invariant_fraction:.2f} "
            f"slices={1 << self.num_sliced} "
            f"hoisted_buffers={len(self.hoisted_nodes)} "
            f"overhead naive={self.executed_overhead(False):.3f} -> "
            f"hoisted={self.executed_overhead(True):.3f}"
        )

    # ------------------------------------------------------------------
    def memory_plan(self):
        """The lifetime-based :class:`~repro_torch.lowering.memory.
        MemoryPlan` for this plan's ``(tree, S)`` pair — exact live-set
        peaks per execution segment, linear-scan buffer slots, and the
        per-step free schedule :meth:`_run_steps` executes.  Built lazily
        once per plan."""
        if self._memory_plan is None:
            from ..lowering.memory import plan_memory  # lazy: avoid cycle

            self._memory_plan = plan_memory(
                self.tree, self.smask, itemsize=self.dtype.itemsize,
                part=self.partition, itemsize_of=self._itemsize_of,
            )
        return self._memory_plan

    # ------------------------------------------------------------------
    def slice_values(self, slice_id: int) -> list[int]:
        """Bit-decompose a slice id into per-index 0/1 values."""
        return [(int(slice_id) >> i) & 1 for i in range(self.num_sliced)]

    def _run_steps(
        self, env: dict, step_ids, segment: str = "naive", device=None
    ) -> None:
        """Execute the given step positions over ``env`` (shared by the
        prologue, the epilogue, and the naive full-tree path).

        Frees follow the lifetime-based memory plan's per-step free
        schedule for ``segment`` (in the epilogue this keeps the pinned
        hoisted buffers out of the free lists).  Positions planned into a
        fused chain (keyed by the chain's first position) dispatch as one
        ``gemm_form.apply_chain`` call.  ``device`` is where ``env``
        lives (default the plan's)."""
        with running(self.device if device is None else device):
            self._run_steps_on(env, step_ids, segment)

    def _run_steps_on(self, env: dict, step_ids, segment: str) -> None:
        from ..lowering import gemm_form  # lazy: avoid cycle

        seg = self.memory_plan().segment_for(segment)
        frees = seg.frees if seg is not None else None
        chains = self._chain_dispatch.get(segment, {})
        ids = list(step_ids)
        i = 0
        while i < len(ids):
            k = ids[i]
            ch = chains.get(k)
            if ch is not None:
                # one chain-kernel call covers the whole run; interior
                # intermediates never enter env (they live in the chain's
                # workspace slots)
                if tuple(ids[i:i + ch.n_steps]) != ch.positions:
                    raise RuntimeError(
                        f"chain {ch.positions} out of order in {segment}"
                    )
                env[ch.out_node] = gemm_form.apply_chain(
                    ch,
                    [self.schedule.specs[p] for p in ch.positions],
                    [env[n] for n in ch.external_nodes],
                    out16=ch.out_node in self.store16,
                )
                interior = {n[2] for n in ch.nodes[:-1]}
                for p in ch.positions:
                    out = self.steps[p].out
                    dead = (
                        frees[out]
                        if frees is not None
                        else (self.steps[p].lhs, self.steps[p].rhs)
                    )
                    for u in dead:
                        if u in env and u not in interior:
                            del env[u]
                i += ch.n_steps
                continue
            st = self.steps[k]
            if self.schedule is None:
                env[st.out] = torch.einsum(st.expr, env[st.lhs], env[st.rhs])
            else:
                env[st.out] = gemm_form.apply(
                    self.schedule.specs[k], env[st.lhs], env[st.rhs],
                    out16=st.out in self.store16,
                )
            dead = frees[st.out] if frees is not None else (st.lhs, st.rhs)
            for u in dead:
                del env[u]
            i += 1

    def contract_slice(
        self, arrays: Sequence[torch.Tensor], slice_id: int, hoisted=None
    ) -> torch.Tensor:
        """Contract one subtask (slice assignment = bits of slice_id).

        ``arrays`` are the leaf tensors, on the plan's device or on the
        device they were bound to (:meth:`ContractionSession.run_sharded`
        runs one plan on several).  ``hoisted`` (from
        :meth:`contract_prologue`, on the same device) seeds the
        environment with the materialized slice-invariant buffers, so
        only the epilogue steps run; ``None`` executes the full tree
        (naive)."""
        svals = self.slice_values(slice_id)
        env: dict[int, torch.Tensor] = {}
        if hoisted is None:
            leaf_ids: Sequence[int] = range(len(arrays))
            step_ids: Sequence[int] = range(len(self.steps))
            segment = "naive"
        else:
            env.update(zip(self.hoisted_nodes, hoisted))
            leaf_ids = self.epilogue_leaves
            step_ids = self.epilogue_idx
            segment = "epilogue"
        for i in leaf_ids:
            a = arrays[i]
            if self.leaf_specs[i]:
                # the slice id is a host integer here, so fixing a sliced
                # axis is a plain select (the reference's traced id needs
                # dynamic_index_in_dim)
                for axis, spos in self.leaf_specs[i]:
                    a = a.select(axis, svals[spos])
                a = a.contiguous()
            env[i] = a
        dev = arrays[0].device if len(arrays) else self.device
        self._run_steps(env, step_ids, segment, dev)
        out = env[self.root]
        if self.out_perm and self.out_perm != tuple(range(out.dim())):
            out = out.permute(self.out_perm)
        return out

    def contract_prologue(
        self, arrays, use_cache: bool = True, device=None
    ) -> list[torch.Tensor]:
        """Run the slice-invariant prologue once on the full (unsliced)
        leaf tensors and return the hoisted frontier buffers in
        ``hoisted_nodes`` order.  Invariant leaves carry no sliced index
        by construction, so no slice specs apply here.

        ``arrays`` are the caller's leaves (numpy or tensors); the ones
        the prologue reads go to ``device`` (default the plan's; another
        device keys its own cache entry).  The outputs are
        memoized in the plan's :class:`~repro_torch.lowering.cache.
        HoistCache`, keyed by :func:`repro_torch.lowering.cache.leaf_key`
        over the prologue's leaves: host (numpy) leaves by value, tensors
        by storage, layout and version counter, so a tensor written in
        place since misses.  The key's keep-alive references ride with
        the entry.  ``use_cache=False`` (or a cache of size 0) skips both
        the key and the cache."""
        if not self.can_hoist:
            return []
        dev = self.device if device is None else device_key(device)

        def compute():
            from ..engine.session import to_device  # lazy: cycle

            leaves = to_device([arrays[i] for i in self.prologue_leaves], dev)
            with _trace.span(
                "exec.prologue", cat="exec", buffers=len(self.hoisted_nodes)
            ):
                env = dict(zip(self.prologue_leaves, leaves))
                del leaves
                self._run_steps(env, self.prologue_idx, "prologue", dev)
                out = [env[v] for v in self.hoisted_nodes]
                _trace.sync(out)
            _metrics.inc("exec.flops_executed", self.partition.invariant_cost)
            return out

        if use_cache and self._hoist_cache.maxsize > 0:
            from ..lowering.cache import leaf_key  # lazy: cycle

            key, keepalive = leaf_key(arrays, self.prologue_leaves)
            if device_key(dev) != device_key(self.device):
                key = f"{key}@{dev}"
            # single flight: sessions over the same leaves materialize
            # the prologue once and count its FLOPs once
            return self._hoist_cache.single_flight(
                key, lambda: (compute(), keepalive)
            )[0]
        return compute()

    # ------------------------------------------------------------------
    def contract_all(self, arrays, hoist: bool = True) -> torch.Tensor:
        """Sum over all 2^|S| subtasks — a one-shot
        :class:`~repro_torch.engine.session.ContractionSession`."""
        from ..engine.session import ContractionSession  # lazy: cycle

        return ContractionSession(self, arrays, hoist=hoist).run_all()
