"""Mixed-precision planning under an XEB error budget: the paper's
single-precision leg, on the card's bf16 tensor cores.

The paper's headline runs reduced precision with wide accumulation;
such "frugal" precision is admissible for supremacy-circuit simulation
whenever the induced amplitude error stays within the XEB fidelity the
experiment already gives up (Huang et al., arXiv 2005.06787).  Here
individual contraction steps are demoted to bf16 inputs with fp32
accumulation (``"bf16"`` on :class:`~repro_torch.lowering.refiner.
GemmSpec`) under a forward error model, certified against a user-set
Linear-XEB fidelity tolerance.

**Error model.**  Rounding a GEMM's operands to bf16 perturbs every
product by at most ``2u`` relative (``u = 2^-9``).  For random-circuit
tensors the K-term accumulation grows like ``sqrt(K)`` against
perturbations that also add in quadrature, so the relative per-node
error stays ~``2u``, with a slowly growing guard for the correlated
tail (``log2 K``) and for the contractions the error still passes
through on the way to the root (``depth``).  Node errors are
independent roundings: the plan's relative amplitude error is their
quadrature sum, and the Linear-XEB fidelity loss is ``≈ 2×`` that.

**Assignment.**  Candidates (steps on the tiled or fused kernel) are
ranked by modeled time saved, epilogue steps weighted by the ``2^|S|``
slice count, per unit of error, then admitted as a strict prefix while
the accumulated fidelity loss stays within ``fidelity_tol``.  The prefix
rule makes the assignment monotone in the tolerance, and
``fidelity_tol=0`` selects nothing: the fp32 plan, unchanged.

**Storage.**  A node is stored as bf16 (re, im) pairs exactly when every
step that consumes it reads bf16 operands; the kernels round each real
component at their operand loads, so rounding at the store is rounding
at every consumer and the numbers do not change.
"""

from __future__ import annotations

import math

import torch

from ..hardware import DEFAULT_HARDWARE, Hardware
from .gemm_form import GemmForm
from .refiner import (
    KERNEL_BACKENDS,
    LoweredSchedule,
    as_dtype,
    refine_step,
)

PRECISION_MODES = ("fp32", "bf16", "auto")
# bf16 unit roundoff: 8 mantissa bits, round to nearest
BF16_UNIT_ROUNDOFF = 2.0 ** -9
# supremacy experiments run at XEB fidelity ~2e-3, so a few percent of
# relative fidelity loss disappears into the noise floor
DEFAULT_FIDELITY_TOL = 0.05


def check_mode(mode: str) -> str:
    if mode not in PRECISION_MODES:
        raise ValueError(f"precision={mode!r} not in {PRECISION_MODES}")
    return mode


def node_amp_error(form: GemmForm, depth: int = 0) -> float:
    """Relative amplitude error contributed by running one GEMM with bf16
    inputs (fp32 accumulation): ``2u`` input quantization with a guard
    for the correlated tail of the K-term sum and for the ``depth``
    contractions the rounded values still pass through."""
    K = max(int(form.K), 1)
    guard = math.sqrt(1.0 + math.log2(K) / 8.0 + depth / 64.0)
    return 2.0 * BF16_UNIT_ROUNDOFF * guard


def predicted_fidelity_loss(amp_error: float) -> float:
    """Linear-XEB fidelity loss induced by a relative amplitude error:
    XEB averages ``|a|^2``, so first order in the perturbation is 2×."""
    return 2.0 * amp_error


def assign_precision(
    schedule: LoweredSchedule,
    *,
    mode: str = "fp32",
    fidelity_tol: float | None = None,
    epilogue_positions=None,
    n_slices: int = 1,
    min_kernel_dim: int | None = None,
    fused: bool = True,
    hw: Hardware = DEFAULT_HARDWARE,
) -> LoweredSchedule:
    """Demote schedule steps to bf16 under the XEB error budget.

    Returns a new :class:`LoweredSchedule` whose selected specs were
    re-refined at ``precision="bf16"`` and whose ``precision_mode``/
    ``fidelity_tol``/``predicted_amp_error`` record the certification.
    ``mode="fp32"``, or ``"auto"`` with a zero tolerance, returns the
    input specs untouched.  ``mode="bf16"`` demotes every eligible step.

    ``epilogue_positions``/``n_slices`` weight each step's modeled saving
    by how often it executes (the epilogue runs once per slice), which
    orders the greedy admission; membership is then the longest prefix
    whose accumulated fidelity loss stays within tolerance.
    ``min_kernel_dim`` defaults to ``hw.tile``, as in
    :func:`~repro_torch.lowering.refiner.refine_step`."""
    check_mode(mode)
    tol = DEFAULT_FIDELITY_TOL if fidelity_tol is None else float(fidelity_tol)
    specs = list(schedule.specs)

    def out(sel, err):
        return LoweredSchedule(
            sel, schedule.dtype, precision_mode=mode, fidelity_tol=tol,
            predicted_amp_error=err,
        )

    if mode == "fp32" or (mode == "auto" and tol <= 0.0):
        return out(specs, 0.0)
    epi = set(epilogue_positions) if epilogue_positions is not None else None
    n_steps = len(specs)
    candidates = []
    for p, spec in enumerate(specs):
        if spec.backend not in KERNEL_BACKENDS or spec.precision == "bf16":
            continue
        spec16 = refine_step(
            spec.form, schedule.dtype, min_kernel_dim=min_kernel_dim,
            fused=fused, hw=hw, precision="bf16",
        )
        if spec16.backend not in KERNEL_BACKENDS:
            continue
        weight = n_slices if (epi is None or p in epi) else 1
        benefit = (spec.modeled_time_s - spec16.modeled_time_s) * weight
        err = node_amp_error(spec.form, depth=n_steps - 1 - p)
        if mode == "auto" and benefit <= 0.0:
            continue
        candidates.append((benefit / err, p, spec16, err))
    err_sq = 0.0
    if mode == "bf16":
        for _, p, spec16, err in candidates:
            specs[p] = spec16
            err_sq += err * err
        return out(specs, math.sqrt(err_sq))
    # auto: benefit-per-error order, strict-prefix admission: stop at the
    # first candidate the budget rejects (monotone in the tolerance)
    candidates.sort(key=lambda c: (-c[0], c[1]))
    for _, p, spec16, err in candidates:
        trial = err_sq + err * err
        if predicted_fidelity_loss(math.sqrt(trial)) > tol:
            break
        specs[p] = spec16
        err_sq = trial
    return out(specs, math.sqrt(err_sq))


def carry_precisions(
    schedule: LoweredSchedule,
    precisions,
    *,
    mode: str = "auto",
    fidelity_tol: float | None = None,
    min_kernel_dim: int | None = None,
    fused: bool = True,
    hw: Hardware = DEFAULT_HARDWARE,
) -> LoweredSchedule:
    """``schedule`` with the per-step ``precisions`` of another plan (the
    reference's, say) instead of an assignment of its own: each bf16 step
    re-refined at bf16, its error summed as :func:`assign_precision`
    sums it."""
    specs = list(schedule.specs)
    if len(precisions) != len(specs):
        raise ValueError(f"{len(precisions)} precisions for {len(specs)} steps")
    err_sq = 0.0
    for p, (spec, prec) in enumerate(zip(specs, precisions)):
        if prec == "fp32":
            continue
        if prec != "bf16":
            raise ValueError(f"step precision {prec!r} not in ('fp32', 'bf16')")
        spec16 = refine_step(spec.form, schedule.dtype, min_kernel_dim=min_kernel_dim,
                             fused=fused, hw=hw, precision="bf16")
        if spec16.backend not in KERNEL_BACKENDS:
            raise ValueError(f"step {p} has no kernel backend to run bf16 on")
        specs[p] = spec16
        err = node_amp_error(spec.form, depth=len(specs) - 1 - p)
        err_sq += err * err
    tol = DEFAULT_FIDELITY_TOL if fidelity_tol is None else float(fidelity_tol)
    return LoweredSchedule(specs, schedule.dtype, precision_mode=check_mode(mode),
                           fidelity_tol=tol, predicted_amp_error=math.sqrt(err_sq))


def storage_itemsizes(step_nodes, specs, dtype, node_ids) -> dict[int, int]:
    """Per-node *storage* itemsize under a mixed-precision schedule: a
    node is held as bf16 component pairs (half the native width) exactly
    when every step that consumes it reads bf16 operands.  Unconsumed
    nodes (the root, the hoisted frontier's outputs) stay full width."""
    full = as_dtype(dtype).itemsize
    half = max(1, full // 2)
    consumers: dict[int, list[str]] = {}
    for (lhs, rhs, _out), spec in zip(step_nodes, specs):
        consumers.setdefault(lhs, []).append(spec.precision)
        consumers.setdefault(rhs, []).append(spec.precision)
    return {
        v: half
        if consumers.get(v) and all(p == "bf16" for p in consumers[v])
        else full
        for v in node_ids
    }


def tree_storage_itemsizes(
    tree,
    smask: int = 0,
    *,
    itemsize: int = 8,
    mode: str = "fp32",
    fidelity_tol: float | None = None,
    fused: bool = True,
    hw: Hardware = DEFAULT_HARDWARE,
) -> dict[int, int] | None:
    """Planner-side storage-itemsize map for ``(tree, S)``: what
    :func:`~repro_torch.core.slicing.refine_slices_for_peak` needs to
    certify dtype-true peaks before any executor plan exists.  ``None``
    when the assignment selects no bf16 step (fp32 mode included) or the
    itemsize has no bf16 form."""
    from ..core.tensor_network import popcount  # lazy: avoid cycle
    from .refiner import refine_tree_schedule

    dtype = {8: torch.complex64, 4: torch.float32}.get(int(itemsize))
    if dtype is None or check_mode(mode) == "fp32":
        return None
    sched = refine_tree_schedule(tree, smask, dtype=dtype, fused=fused, hw=hw)
    order = tree.contract_order()
    epilogue = None
    n_slices = 1
    if smask:
        from .partition import partition_tree  # lazy: avoid cycle

        invariant = set(partition_tree(tree, smask).invariant_nodes)
        epilogue = tuple(i for i, v in enumerate(order) if v not in invariant)
        n_slices = 1 << popcount(smask)
    sched = assign_precision(
        sched, mode=mode, fidelity_tol=fidelity_tol,
        epilogue_positions=epilogue, n_slices=n_slices, fused=fused, hw=hw,
    )
    if not sched.precision_counts().get("bf16"):
        return None
    step_nodes = tuple((*tree.children[v], v) for v in order)
    return storage_itemsizes(step_nodes, sched.specs, dtype, tree.emask)
