"""Three-term roofline on the H100.

    compute_s    = FLOPs_per_device / peak FLOP/s
    memory_s     = HBM_bytes_per_device / HBM bandwidth
    collective_s = collective_bytes_per_device / link bandwidth

Counterpart of the reference's ``roofline/analysis.py``.  The reference
fills the three terms from a compiled XLA module (its cost analysis and
the collectives in its HLO text).  The port compiles no module: the dry
run (``repro_torch.launch.dryrun``) fills the compute and memory terms
from the analytic model (:mod:`.analytic`), and the collective term
from the sharded step's own collectives, counted from the resolved specs
(:mod:`.collectives`) at the H100 SXM's NVLink rate (``hardware.py``).
A :class:`Roofline` built with ``coll_bytes=None`` reads ``None`` there,
never 0, and its bound is the larger of the other two.
:func:`shape_bytes` and :func:`collective_bytes` are the reference's
HLO-text parsers, kept for HLO text from any source.
"""

from __future__ import annotations

import dataclasses
import re

from ..hardware import H100_NVLINK_BW

# H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # 80 GB HBM3 at 3.35 TB/s (hardware.py's _H100_HBM_BW)
LINK_BW = H100_NVLINK_BW  # NVLink 4: 900 GB/s total, 450 GB/s each way

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = (
    "all-gather-start", "all-gather",
    "all-reduce-start", "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute-start", "collective-permute",
)

_SHAPE_RE = re.compile(r"(pred|[a-z]+\d+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:(?:pred|[a-z]+\d+)\[[^\]]*\](?:\{[^}]*\})?))\s+"
    r"(" + "|".join(_COLLECTIVES) + r")\("
)


def shape_bytes(text: str) -> int:
    """Bytes of every HLO shape (``bf16[128,256]``) in ``text``."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Result-shape bytes per collective kind (a ``-start``/``-done``
    pair counted once, by its ``-start``; bare ops counted directly)."""
    out: dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        shape_txt, kind = m.groups()
        base = kind.replace("-start", "")
        if not kind.endswith("-start") and f"{base}-start" in line:
            continue
        out[base] = out.get(base, 0) + shape_bytes(shape_txt)
    return out


@dataclasses.dataclass
class Roofline:
    flops: float  # per device
    bytes_accessed: float  # per device
    coll_bytes: dict[str, int] | None  # per device; None: not measured
    n_devices: int

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float | None:
        if self.coll_bytes is None:
            return None
        return sum(self.coll_bytes.values()) / LINK_BW

    def _terms(self) -> dict:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    def summary(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": (
                None if self.coll_bytes is None else dict(self.coll_bytes)),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
        }


def analytic_roofline(cfg, shape, n_params: int, n_devices: int,
                      coll_bytes: dict[str, int] | None = None) -> Roofline:
    """The cell's analytic FLOPs and HBM bytes (:mod:`.analytic`) split
    evenly over ``n_devices``, and ``coll_bytes`` (per device, by kind;
    ``None``: the collective term unmeasured).  An even split is the
    least each device could do: replicated weights (the ``dp_only``
    recipe) or gathered ones (FSDP) make each device read more."""
    from .analytic import cell_flops, cell_hbm_bytes

    return Roofline(cell_flops(cfg, shape) / n_devices,
                    cell_hbm_bytes(cfg, shape, n_params) / n_devices,
                    coll_bytes, n_devices)


def model_flops(cfg, shape, active_params: int) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for an inference forward."""
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * active_params * tokens


def active_param_count(cfg, defs_count: int) -> int:
    """Active parameters per token: an MoE model's routed experts count
    k/E of their weights; a dense model all of them."""
    if not cfg.num_experts:
        return defs_count
    Fm = cfg.moe_d_ff or cfg.d_ff
    n_moe = cfg.num_layers - cfg.first_k_dense
    routed = n_moe * cfg.num_experts * 3 * cfg.d_model * Fm
    active_routed = routed * cfg.experts_per_token / cfg.num_experts
    return int(defs_count - routed + active_routed)
