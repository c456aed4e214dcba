"""GEMM normalization: pairwise contraction → transpose/reshape/GEMM form.

The paper's Sec. V-A observation is that every stem contraction *is* a
GEMM once its indices are classified; the runtime rewrites each pairwise
contraction into a fused transpose→GEMM so the hot loop never executes a
generic einsum.  Given the (ordered) index tuples of one contraction step
this module classifies every index into one of four GEMM roles,

  batch  — shared by both operands AND kept in the output (open sampling
           indices that ride through both children; lowered as the
           leading batch axis of a batched GEMM),
  M      — kept indices exclusive to the left operand,
  N      — kept indices exclusive to the right operand,
  K      — contracted indices (shared, absent from the output),

and emits a static :class:`GemmForm`: two input permutations, the
(B, M, K) / (B, K, N) collapse shapes, and the output permutation that
restores the executor's index-order convention.  Sliced indices never
reach this layer — the executor fixes them on the leaf arrays before any
step runs — so a slicing mask ``S`` only shrinks the shapes seen here.

:func:`apply` executes a refined step (:class:`~repro_torch.lowering.
refiner.GemmSpec`) and :func:`apply_chain` a fused chain.  The ``tiled``,
``fused`` and chain backends reach the hand-written CUDA kernels through
:mod:`repro_torch.kernels.ops`; ``dot`` stays ``torch.matmul`` and
``einsum`` stays ``torch.einsum`` (library calls, as the reference left
them to XLA).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Hashable, Sequence

import torch

from ..kernels.ref import permute_reshape


def real_component_bytes(dtype) -> int:
    """Byte width of one real component (complex64 → 4, complex128 → 8).

    The single source of the kernel-safety policy: components wider than
    4 bytes must not run through the fp32-accumulating kernels — the
    refiner routes them off the kernels at plan time and :func:`apply`
    re-checks the concrete tensors at run time.
    """
    return dtype.itemsize // 2 if dtype.is_complex else dtype.itemsize


@dataclasses.dataclass(frozen=True)
class GemmForm:
    """Static lowering of one pairwise contraction to batched-GEMM form."""

    inds_a: tuple
    inds_b: tuple
    inds_out: tuple
    batch_inds: tuple
    m_inds: tuple
    n_inds: tuple
    k_inds: tuple
    perm_a: tuple[int, ...]  # a axes → (batch..., m..., k...)
    perm_b: tuple[int, ...]  # b axes → (batch..., k..., n...)
    out_perm: tuple[int, ...]  # (batch..., m..., n...) → inds_out order
    batch_shape: tuple[int, ...]
    m_shape: tuple[int, ...]
    n_shape: tuple[int, ...]
    k_shape: tuple[int, ...]
    expr: str  # einsum fallback for the same step

    @property
    def B(self) -> int:
        return math.prod(self.batch_shape)

    @property
    def M(self) -> int:
        return math.prod(self.m_shape)

    @property
    def N(self) -> int:
        return math.prod(self.n_shape)

    @property
    def K(self) -> int:
        return math.prod(self.k_shape)

    @property
    def flops(self) -> float:
        """Real-valued multiply-add count of the un-padded GEMM."""
        return 2.0 * self.B * self.M * self.N * self.K

    @property
    def a_shape(self) -> tuple[int, ...]:
        """Native shape of the left operand (``inds_a`` order)."""
        return _native_shape(
            self.perm_a, self.batch_shape + self.m_shape + self.k_shape
        )

    @property
    def b_shape(self) -> tuple[int, ...]:
        """Native shape of the right operand (``inds_b`` order)."""
        return _native_shape(
            self.perm_b, self.batch_shape + self.k_shape + self.n_shape
        )

    @property
    def out_shape(self) -> tuple[int, ...]:
        """Shape of the output in ``inds_out`` order."""
        natural = self.batch_shape + self.m_shape + self.n_shape
        return tuple(natural[p] for p in self.out_perm)


def _native_shape(perm, role_shape) -> tuple[int, ...]:
    shape = [0] * len(perm)
    for i, p in enumerate(perm):
        shape[p] = role_shape[i]
    return tuple(shape)


def lower_step(
    inds_a: Sequence[Hashable],
    inds_b: Sequence[Hashable],
    inds_out: Sequence[Hashable],
    size_of: Callable[[Hashable], int],
) -> GemmForm:
    """Classify one pairwise contraction into GEMM roles.

    ``inds_out`` must follow the executor's convention (kept indices of
    ``a`` in order, then kept indices of ``b`` not already present), i.e.
    the output of :func:`repro_torch.core.executor.pair_contract_inds`.
    """
    set_a, set_b = set(inds_a), set(inds_b)
    out_set = set(inds_out)
    batch = tuple(ix for ix in inds_a if ix in set_b and ix in out_set)
    k_inds = tuple(ix for ix in inds_a if ix in set_b and ix not in out_set)
    m_inds = tuple(ix for ix in inds_a if ix not in set_b)
    n_inds = tuple(ix for ix in inds_b if ix not in set_a)

    pos_a = {ix: i for i, ix in enumerate(inds_a)}
    pos_b = {ix: i for i, ix in enumerate(inds_b)}
    perm_a = tuple(pos_a[ix] for ix in batch + m_inds + k_inds)
    perm_b = tuple(pos_b[ix] for ix in batch + k_inds + n_inds)

    natural = batch + m_inds + n_inds
    if set(natural) != out_set or len(natural) != len(inds_out):
        raise ValueError(
            f"output {inds_out!r} is not a permutation of batch+M+N "
            f"{natural!r}"
        )
    nat_pos = {ix: i for i, ix in enumerate(natural)}
    out_perm = tuple(nat_pos[ix] for ix in inds_out)

    from ..core.executor import einsum_expr  # shared labeling convention

    try:
        expr = einsum_expr(inds_a, inds_b, inds_out)
    except IndexError:
        # more distinct indices than einsum subscript letters — only
        # possible on paper-scale planning-only nodes, which the refiner
        # always routes to GEMM backends; the einsum fallback string is
        # never consulted for them.
        expr = ""
    return GemmForm(
        inds_a=tuple(inds_a),
        inds_b=tuple(inds_b),
        inds_out=tuple(inds_out),
        batch_inds=batch,
        m_inds=m_inds,
        n_inds=n_inds,
        k_inds=k_inds,
        perm_a=perm_a,
        perm_b=perm_b,
        out_perm=out_perm,
        batch_shape=tuple(size_of(ix) for ix in batch),
        m_shape=tuple(size_of(ix) for ix in m_inds),
        n_shape=tuple(size_of(ix) for ix in n_inds),
        k_shape=tuple(size_of(ix) for ix in k_inds),
        expr=expr,
    )


def _full(x: torch.Tensor, shape) -> torch.Tensor:
    from ..kernels.ref import widen

    return widen(x, shape)


_CHUNK_BYTES = 1 << 26  # the most the dot backend's blocks add to the plan


def _dot(a: torch.Tensor, b: torch.Tensor, form: GemmForm, out16: bool) -> torch.Tensor:
    """The ``dot`` backend: ``torch.matmul`` on the step in GEMM order.

    An operand copied whole into GEMM order lives beside itself for the
    length of the copy, which the planner does not count.  So the larger
    operand is copied a block at a time: its leading M (or N) axes fixed,
    each block a run of rows of the GEMM, and each block's product is
    written straight into the output, allocated in ``inds_out`` order at
    its storage width.  The blocks of the operand and of the product stay
    under ``_CHUNK_BYTES``; a step whose operand and output are that size
    or smaller is computed whole."""
    import itertools

    from ..kernels.ref import to_pairs16

    a, b = _full(a, form.a_shape), _full(b, form.b_shape)
    nb, nm, nk = len(form.batch_shape), len(form.m_shape), len(form.k_shape)
    on_a = a.numel() >= b.numel()
    x, perm = (a, form.perm_a) if on_a else (b, form.perm_b)
    free0, nfree = (nb, nm) if on_a else (nb + nk, len(form.n_shape))
    dims = [x.shape[perm[free0 + i]] for i in range(nfree)]
    # the operand and the output shrink together as its free axes are fixed
    out_bytes = math.prod(form.out_shape) * (
        (4 if a.is_complex() or b.is_complex() else 2) if out16
        else torch.result_type(a, b).itemsize)
    c, size = 0, max(x.numel() * x.element_size(), out_bytes)
    while c < nfree and size > _CHUNK_BYTES:
        size //= dims[c]
        c += 1
    if c == 0:
        x2 = permute_reshape(a, form.perm_a, (form.B, form.M, form.K))
        y2 = permute_reshape(b, form.perm_b, (form.B, form.K, form.N))
        out = torch.matmul(x2, y2)
        return _inds_out(to_pairs16(out) if out16 else out, form)
    cplx = a.is_complex() or b.is_complex()
    pair = (2,) if out16 and cplx else ()
    out = torch.empty(form.out_shape + pair, device=a.device,
                      dtype=torch.bfloat16 if out16 else torch.result_type(a, b))
    order = [form.out_perm.index(q) for q in range(len(form.out_perm))]
    nat = out.permute(order + ([len(order)] if pair else []))  # natural order
    fixed = [perm[free0 + i] for i in range(c)]  # the operand's axes to fix
    rest = [p - sum(f < p for f in fixed) for p in perm if p not in fixed]
    nat_fixed = [(nb if on_a else nb + nm) + i for i in range(c)]
    blocks = math.prod(dims[:c])
    if on_a:
        other = permute_reshape(b, form.perm_b, (form.B, form.K, form.N))
        block_shape = (form.B, form.M // blocks, form.K)
        prod_shape = form.batch_shape + form.m_shape[c:] + form.n_shape
    else:
        other = permute_reshape(a, form.perm_a, (form.B, form.M, form.K))
        block_shape = (form.B, form.K, form.N // blocks)
        prod_shape = form.batch_shape + form.m_shape + form.n_shape[c:]
    for idx in itertools.product(*(range(d) for d in dims[:c])):
        xc, tgt = x, nat
        for ax, i in sorted(zip(fixed, idx), reverse=True):
            xc = xc.select(ax, i)
        for ax, i in sorted(zip(nat_fixed, idx), reverse=True):
            tgt = tgt.select(ax, i)
        xb = permute_reshape(xc, rest, block_shape)
        prod = torch.matmul(xb, other) if on_a else torch.matmul(other, xb)
        del xb
        tgt.copy_((to_pairs16(prod) if out16 else prod).reshape(prod_shape + pair))
        del prod  # before the next block's product is allocated
    return out


def apply(spec, a: torch.Tensor, b: torch.Tensor, *, out16: bool = False) -> torch.Tensor:
    """Execute one refined step (``spec`` is a refiner ``GemmSpec``) and
    return its output in ``inds_out`` order.  ``spec.precision`` picks
    the kernels' route; ``out16`` returns the output at half width (bf16
    (re, im) pairs), written so by the kernels' epilogues and converted
    after the library backends."""
    form: GemmForm = spec.form
    from ..kernels import ops
    from ..kernels.ref import to_pairs16

    if spec.backend == "einsum":
        out = torch.einsum(form.expr, _full(a, form.a_shape), _full(b, form.b_shape))
        return to_pairs16(out) if out16 else out
    real_bytes = real_component_bytes(torch.result_type(a, b))
    if spec.backend == "fused" and real_bytes <= 4:
        # operands stay in their tree-native layouts: the kernel gathers
        # through per-role offset tables and writes the inds_out layout,
        # so no permuted copy of a, b or the output is ever made.
        return ops.fused_matmul(a, b, form, precision=spec.precision, out16=out16)
    if spec.backend == "dot" or real_bytes > 4:
        # 64-bit components handed to a schedule refined for a narrower
        # dtype would be silently truncated by the fp32 kernels — keep
        # them on the library's full-precision matmul (this also catches
        # a fused spec handed 64-bit tensors at run time).
        return _dot(a, b, form, out16)
    if spec.backend != "tiled":
        raise ValueError(f"unknown lowering backend {spec.backend!r}")
    # the refiner already gated tiny shapes; the kernel reads the operands
    # in their native layouts, as the fused one does
    return ops.tiled_step(a, b, form, precision=spec.precision, out16=out16)


def _inds_out(out: torch.Tensor, form: GemmForm) -> torch.Tensor:
    """A (B, M, N) product (bf16 pairs: a trailing 2 more) as a view in
    ``inds_out`` order."""
    pair = (2,) if out.dim() == 4 else ()
    out = out.reshape(form.batch_shape + form.m_shape + form.n_shape + pair)
    if form.out_perm != tuple(range(len(form.out_perm))):
        out = out.permute(tuple(form.out_perm) + ((len(form.out_perm),) if pair else ()))
    return out


def apply_chain(chain, specs, operands, *, out16: bool = False):
    """Execute one fused chain (``chain`` is a refiner
    :class:`~repro_torch.lowering.refiner.FusedChainSpec`, ``specs`` the
    GemmSpecs of its steps, ``operands`` the external buffers in
    ``chain.external_nodes`` order) as one chain-kernel call, each step
    at its spec's precision and each interior carry in a slot of
    ``chain.slot_prec``'s width; ``out16`` returns the chain's output at
    half width.

    64-bit components handed to a schedule refined for a narrower dtype
    fall back to the sequential per-step :func:`apply` (the fp32 chain
    kernel would silently truncate them)."""
    dt = operands[0].dtype
    for o in operands[1:]:
        dt = torch.promote_types(dt, o.dtype)
    if real_component_bytes(dt) > 4:
        carry = apply(specs[0], operands[0], operands[1])
        for t in range(1, len(specs)):
            ext = operands[t + 1]
            a, b = (
                (carry, ext) if chain.carry_side[t] == "l" else (ext, carry)
            )
            carry = apply(specs[t], a, b)
        return carry
    from ..kernels import ops

    return ops.fused_chain(
        operands,
        forms=tuple(s.form for s in specs),
        carry_side=chain.carry_side,
        slot_ids=chain.slot_ids,
        slot_elems=chain.slot_elems,
        precisions=tuple(s.precision for s in specs),
        slot_prec=chain.slot_prec,
        out16=out16,
    )
