"""Model-vs-measured calibration: per-step time against the refiner model.

The refiner chooses backends by ``modeled_time_s`` (an F(M,N,K)
efficiency model over GEMM shapes priced with the plan's
:class:`~repro_torch.hardware.Hardware`), the slicer trusts
``modeled_node_time``, and the lifetime planner certifies live-set peaks.
:func:`calibrate_plan` checks those models against the card: it executes
one slice of a plan step by step, times each step (and each fused chain,
as the one call it executes as) and joins the measured times with the
modeled per-slice times into a per-backend-class table (``tiled`` /
``fused`` / ``chain`` / ``dot`` / ``einsum``; under mixed precision,
non-fp32 steps split into their own rows, e.g. ``tiled[bf16]`` /
``chain[mixed]`` — bf16 runs against another rate, so its
measured/modeled ratio is a separate signal).

Timing is :func:`repro_torch.launch.calibrate.time_ms`: CUDA events
around back-to-back calls on the card, ``time.perf_counter`` on the CPU
(a CPU number is never a device metric).  The ratio per class is the
feedback signal for the refiner's constants: a class with ratio ≫ 1
means the model flatters that backend on this card.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CalibrationRow:
    """One executed step (or fused chain) of the plan."""

    node: int  # tree node id of the step output (chain: its out node)
    backend: str  # tiled | fused | dot | einsum | chain
    measured_s: float  # mean time of back-to-back calls (see module doc)
    modeled_s: float  # refiner / cost-model per-slice seconds
    flops: float  # modeled real-multiply FLOPs of the step (per slice)
    precision: str = "fp32"  # operand precision (chain: "mixed" if split)

    @property
    def cls(self) -> str:
        """Calibration class: the backend, qualified by precision when
        the step does not run at full fp32 (``tiled[bf16]``,
        ``chain[mixed]``, …)."""
        if self.precision == "fp32":
            return self.backend
        return f"{self.backend}[{self.precision}]"

    @property
    def ratio(self) -> float:
        return self.measured_s / self.modeled_s if self.modeled_s else float("inf")


@dataclasses.dataclass
class CalibrationReport:
    rows: list[CalibrationRow]
    backend: str  # the plan's execution backend ("einsum" | "gemm")
    num_steps: int
    peak_bytes: int  # certified naive live-set peak (lowering/memory.py)
    peak_bytes_hoisted: int  # certified prologue/epilogue peak
    device: str = "cpu"  # where the times were taken
    hardware: str = ""  # the Hardware the modeled times price

    def ratio_by_class(self) -> dict[str, dict]:
        """Per backend class: total measured, total modeled, their ratio,
        and the step count — the headline calibration table."""
        agg: dict[str, dict] = {}
        for r in self.rows:
            a = agg.setdefault(
                r.cls, {"count": 0, "measured_s": 0.0, "modeled_s": 0.0}
            )
            a["count"] += 1
            a["measured_s"] += r.measured_s
            a["modeled_s"] += r.modeled_s
        for a in agg.values():
            a["ratio"] = (
                a["measured_s"] / a["modeled_s"] if a["modeled_s"] else float("inf")
            )
        return agg

    def table(self) -> str:
        """Markdown model-vs-measured table per backend class."""
        lines = [
            "| class | steps | measured (s) | modeled (s) | meas/model |",
            "|---|---|---|---|---|",
        ]
        for cls, a in sorted(self.ratio_by_class().items()):
            lines.append(
                f"| {cls} | {a['count']} | {a['measured_s']:.3e} "
                f"| {a['modeled_s']:.3e} | {a['ratio']:.2f} |"
            )
        return "\n".join(lines)

    def summary(self) -> dict:
        """JSON-serializable form."""
        return {
            "backend": self.backend,
            "device": self.device,
            "hardware": self.hardware,
            "num_steps": self.num_steps,
            "peak_bytes": self.peak_bytes,
            "peak_bytes_hoisted": self.peak_bytes_hoisted,
            "by_class": self.ratio_by_class(),
        }


def calibrate_plan(plan, arrays, slice_id: int = 0, repeat: int = 2):
    """Execute one slice of ``plan`` step by step (the naive full-tree
    path) and join each step's measured time with its modeled per-slice
    time.

    Honors the plan's fused-chain dispatch for the naive segment, so
    chain steps are measured as the single ``apply_chain`` call they
    execute as, classed ``"chain"`` with the chain's modeled time (sum of
    member specs less the modeled device-memory traffic it saves, at the
    plan's ``hw.mem_bw``).  Returns a :class:`CalibrationReport`."""
    import torch

    from ..core.merging import modeled_node_time
    from ..engine.session import execution_gate, to_device
    from ..launch.calibrate import time_ms
    from ..lowering import gemm_form
    from . import trace

    dev = plan.device
    arrays = to_device(arrays, dev)
    svals = plan.slice_values(slice_id)
    env: dict[int, torch.Tensor] = {}
    for i, a in enumerate(arrays):
        for axis, spos in plan.leaf_specs[i]:
            a = a.select(axis, svals[spos])
        env[i] = a.contiguous()

    def timed(fn, node):
        with trace.span("calib.node", cat="calib", node=node):
            out = fn()
            return time_ms(fn, repeat, dev) / 1e3, out

    chains = plan._chain_dispatch.get("naive", {})
    frees = plan.memory_plan().naive.frees
    n_sub = 1 << plan.num_sliced
    rows: list[CalibrationRow] = []

    def drop(positions, keep=()):
        # the naive segment's planned frees, as the executor applies them
        for p in positions:
            for u in frees[plan.steps[p].out]:
                if u in env and u not in keep:
                    del env[u]

    k = 0
    with execution_gate(dev).hold():
        while k < len(plan.steps):
            ch = chains.get(k)
            if ch is not None:
                specs = [plan.schedule.specs[p] for p in ch.positions]
                operands = [env[n] for n in ch.external_nodes]
                out16 = ch.out_node in plan.store16
                measured, env[ch.out_node] = timed(
                    lambda: gemm_form.apply_chain(ch, specs, operands, out16=out16),
                    ch.out_node,
                )
                del operands
                drop(ch.positions, keep={n[2] for n in ch.nodes[:-1]})
                modeled = (
                    sum(s.modeled_time_s for s in specs)
                    - ch.hbm_bytes_saved / plan.hw.mem_bw
                )
                precs = {s.precision for s in specs}
                rows.append(CalibrationRow(
                    node=ch.out_node,
                    backend="chain",
                    measured_s=measured,
                    modeled_s=max(modeled, 0.0),
                    flops=sum(s.form.flops for s in specs),
                    precision=precs.pop() if len(precs) == 1 else "mixed",
                ))
                k += ch.n_steps
                continue
            st = plan.steps[k]
            a, b = env[st.lhs], env[st.rhs]
            if plan.schedule is None:
                expr = st.expr
                measured, out = timed(lambda: torch.einsum(expr, a, b), st.out)
                modeled = modeled_node_time(plan.tree, st.out, plan.smask, plan.hw) / n_sub
                cls, flops, prec = "einsum", 0.0, "fp32"
            else:
                spec = plan.schedule.specs[k]
                out16 = st.out in plan.store16
                measured, out = timed(
                    lambda: gemm_form.apply(spec, a, b, out16=out16), st.out
                )
                modeled = spec.modeled_time_s
                cls, flops, prec = spec.backend, spec.form.flops, spec.precision
            env[st.out] = out
            del a, b, out
            drop([k])
            rows.append(CalibrationRow(
                node=st.out, backend=cls, measured_s=measured,
                modeled_s=modeled, flops=flops, precision=prec,
            ))
            k += 1
    del env
    mem = plan.memory_plan()
    return CalibrationReport(
        rows=rows,
        backend=plan.backend,
        num_steps=len(plan.steps),
        peak_bytes=mem.peak_bytes,
        peak_bytes_hoisted=mem.peak_bytes_hoisted,
        device=str(dev),
        hardware=plan.hw.name,
    )
