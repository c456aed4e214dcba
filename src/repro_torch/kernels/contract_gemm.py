"""The stem-contraction GEMM kernels on Hopper, with their plain versions.

Three hand-written CUDA kernels (``csrc/gemm.cu``) replace the three
Pallas kernels of the reference's ``src/repro/kernels/contract_gemm.py``:

  * :func:`tiled_gemm` (K1) replaces ``tiled_matmul`` (``_matmul_kernel``):
    ``C[b] = A[b] @ B[b]`` with fp32 accumulation, as 3xTF32 or bf16 on
    the tensor cores (``wgmma``): K2's kernel body on the step in GEMM
    order (:func:`gemm_form`), real or complex64 operands read in place,
    its producer warps splitting each element to TF32 hi/lo, or rounding
    it to bf16, themselves;
  * :func:`fused_gemm_c64` (K2) replaces ``fused_transpose_matmul``
    (``_fused_kernel``): one contraction step on operands in their native
    tree layouts, read and written in place, as 3xTF32 or bf16 on
    ``wgmma``; producer warps gather each tile through a map of its
    elements in ascending native offset (:func:`gather_map`, built once
    per step form), and the output is written straight into ``inds_out``
    order.  :func:`fused_gemm` is the same kernel on planes;
  * :func:`chain_gemm_c64` (K3) replaces ``fused_chain_matmul``
    (``_chain_kernel``/``_run_chain``): a run of adjacent steps in one
    thread-block cluster, interior carries in a device workspace laid out
    by the planner's ``slot_ids``/``slot_elems`` (bf16 slots at half
    width), each step fp32 or bf16 inputs; its launch state is built once
    per chain (:class:`ChainLaunch`).  :func:`chain_gemm` is the same
    kernel on planes.

The bf16 routes (``precision="bf16"``) round every real component of
their operands to bf16 at the kernel's load and accumulate in fp32.
Any operand may be held at half width (bf16, or bf16 (re, im) pairs: a
``torch.bfloat16`` tensor with a trailing axis of 2; see
:func:`operand_kind`), and ``out16`` writes the output so: the format in
which the executor stores a node that only bf16 steps read.

Each kernel has a plain PyTorch version of the same function in this
module (round to bf16 where the route does, then permute + reshape +
``torch.matmul``; for K3 the port of ``chain_reference``).  A wrapper
uses the plain version only when its tensors lie on the CPU; for CUDA
tensors it launches its kernel or raises.  :data:`LAUNCHES` counts
kernel launches, one per launch, and :data:`BF16_LAUNCHES` those that
ran a bf16 route; :data:`FUSED_ROUTES` splits K2's launches by gather
(``uniform``: one map for every tile; ``general``: per-tile offset
tables).

What bounds each kernel on the H100, and why, is noted at the top of
``csrc/gemm.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..lowering.refiner import suffix_tile_split
from .build import check, load_library
from .build import cuda_stream as _stream
from .build import on_cpu as _on_cpu
from .ref import permute_reshape, round16, to_pairs16, widen

MAX_CHAIN = 32  # steps per chain launch (MAX_CHAIN in csrc/gemm.cu)
# a role's flat index splits into (hi, lo) table lookups; the lo table
# covers the longest axis suffix with at most this many entries
_LO_TARGET = 4096

LAUNCHES = {"tiled_gemm": 0, "fused_gemm": 0, "chain_gemm": 0}
FUSED_ROUTES = {"uniform": 0, "general": 0}
# the launches of LAUNCHES that ran a bf16 route (K3: a launch with a
# bf16 step)
BF16_LAUNCHES = {"tiled_gemm": 0, "fused_gemm": 0, "chain_gemm": 0}


def reset_launches() -> None:
    for d in (LAUNCHES, FUSED_ROUTES, BF16_LAUNCHES):
        for k in d:
            d[k] = 0


PRECISIONS = ("fp32", "bf16")  # the routes: 3xTF32, or bf16 in / fp32 out


def _check_planes(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"kernel takes float32 or bfloat16 planes, got {t.dtype}")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")


def operand_kind(x: torch.Tensor, shape) -> tuple[bool, bool]:
    """``(complex, half)`` of a kernel operand of logical ``shape``:
    float32 or complex64 at full width, bfloat16 (real) or bf16 (re, im)
    pairs (``shape + (2,)``) at half width.  Raises on anything else."""
    shape = tuple(shape)
    if x.dtype == torch.bfloat16 and tuple(x.shape) == shape + (2,):
        return True, True
    if tuple(x.shape) != shape:
        raise ValueError(f"operand {tuple(x.shape)} != {shape}")
    if x.dtype == torch.complex64:
        return True, False
    if x.dtype in (torch.float32, torch.bfloat16):
        return False, x.dtype == torch.bfloat16
    raise TypeError(f"kernel takes float32, complex64 or bfloat16, got {x.dtype}")


def _plain_result(out: torch.Tensor, out16: bool) -> torch.Tensor:
    return to_pairs16(out) if out16 else out


def _empty_out(shape, cplx: bool, out16: bool, device) -> torch.Tensor:
    if out16:
        return torch.empty(tuple(shape) + ((2,) if cplx else ()),
                           dtype=torch.bfloat16, device=device)
    return torch.empty(tuple(shape), dtype=torch.complex64 if cplx else torch.float32,
                       device=device)


# ----------------------------------------------------------------------
# K1: tiled GEMM: 3xTF32 or bf16 on wgmma
# ----------------------------------------------------------------------
def tiled_gemm_plain(a: torch.Tensor, b: torch.Tensor,
                     precision: str = "fp32") -> torch.Tensor:
    """Plain version of K1: ``torch.matmul`` per batch cell, on the
    operands rounded to bf16 first when ``precision`` is bf16 (bf16
    products are exact in fp32, so only the summation order differs
    from the kernel's)."""
    if precision == "bf16":
        a, b = round16(a), round16(b)
    return torch.matmul(a, b)


def gemm_form(B: int, M: int, N: int, K: int):
    """K1's step ``(B, M, K) @ (B, K, N)`` in GEMM order as a form of the
    in-place kernels' gather: each of M, N and K split at the tile extent
    the kernel takes it in (where that divides it), so every tile has the
    first tile's offsets and the maps are uniform."""
    from ..lowering.gemm_form import lower_step

    swap = N > M
    R, C = fused_tile(M if swap else N)
    m_ext, n_ext = (C, R) if swap else (R, C)

    def split(name, d, e):
        return ((f"{name}1", d // e), (f"{name}0", e)) if d > e and d % e == 0 \
            else ((name, d),)

    ms, ns, ks = split("m", M, m_ext), split("n", N, n_ext), split("k", K, FUSED_BK)
    size = dict((("b", B),) + ms + ns + ks)
    m, n, k = [x for x, _ in ms], [x for x, _ in ns], [x for x, _ in ks]
    return lower_step(["b"] + m + k, ["b"] + k + n, ["b"] + m + n, size.__getitem__)


def tiled_gemm(a: torch.Tensor, b: torch.Tensor, *, precision: str = "fp32",
               out16: bool = False) -> torch.Tensor:
    """K1: ``C[i] = A[i] @ B[i]`` for ``a`` (B, M, K) and ``b`` (B, K, N),
    both real or both complex, each at full width (float32, complex64) or
    half (bf16, bf16 (re, im) pairs with a trailing 2).  One ordered sum
    over K per output element, accumulated in fp32.

    ``precision="fp32"`` runs each real product as three TF32 products
    (3xTF32, about 22 of fp32's 24 mantissa bits): the operands are read
    in place by the producer warps, which split each element into TF32
    hi/lo themselves.  ``precision="bf16"`` rounds every component to
    bf16 at that load and runs bf16 ``wgmma``.  A complex product takes
    the direct form (four real products).  ``out16`` writes C at half
    width."""
    _check_precision(precision)
    if a.dim() not in (3, 4) or b.dim() not in (3, 4) or a.shape[0] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    Bt, M, K = a.shape[:3]
    N = b.shape[2]
    ca, ha = operand_kind(a, (Bt, M, K))
    cb, hb = operand_kind(b, (Bt, K, N))
    if ca != cb:
        raise TypeError("operands must both be real or both complex")
    if _on_cpu(a, b):
        out = tiled_gemm_plain(widen(a, (Bt, M, K)), widen(b, (Bt, K, N)), precision)
        return _plain_result(out, out16)
    form = gemm_form(Bt, M, N, K)
    pair = (2,) if ca else ()
    out = tiled_gemm_step(
        a.reshape(form.a_shape + pair * ha), b.reshape(form.b_shape + pair * hb),
        form, precision=precision, out16=out16)
    return out.reshape((Bt, M, N) + pair * out16)


def tiled_gemm_step(a: torch.Tensor, b: torch.Tensor, form, *,
                    precision: str = "fp32", out16: bool = False) -> torch.Tensor:
    """K1's in-place kernel on one step ``form``: the operands read where
    they lie, in their native layouts (the kernel's maps describe them
    as K2's do), the output written in ``inds_out`` order, so the tiled
    backend makes no copy of its operands in GEMM order.  Operand kinds,
    ``precision`` and ``out16`` as in :func:`fused_gemm_c64`; on the CPU
    the plain version is K2's (permute + reshape + ``torch.matmul``).
    One kernel launch."""
    return _step(1, a, b, form, precision, out16)


def _launch_inplace(lib, tiled: int, form, a, b, c, precision, cplx, a16, b16,
                    c16) -> int:
    """Launch K1's in-place kernel (``tiled``) or K2's on ``form``:
    operands read in place at their widths, the step oriented by its
    plan (the operands and their width flags trade places when it
    swaps)."""
    plan, desc, maps = _device_plan(form, a.device)
    x, y, fx, fy = (b, a, b16, a16) if plan.swap else (a, b, a16, b16)
    flags = (int(precision == "bf16") | (int(fx) << 1) | (int(fy) << 2)
             | (int(c16) << 3))
    rc = lib.repro_fused_gemm(
        desc.data_ptr(), maps.data_ptr(), int(plan.uniform), int(plan.wide),
        int(cplx), plan.tiles, x.data_ptr(), y.data_ptr(), c.data_ptr(),
        flags, tiled, _stream(a.device),
    )
    if rc == 0 and not tiled:
        FUSED_ROUTES["uniform" if plan.uniform else "general"] += 1
    return rc


# ----------------------------------------------------------------------
# K2: fused transpose-GEMM over native layouts
# ----------------------------------------------------------------------
FUSED_BK = 32  # k per stage (F_BK in csrc/gemm.cu)
_INT32_MAX = 2**31 - 1


def _strides(shape) -> list[int]:
    st, acc = [0] * len(shape), 1
    for i in range(len(shape) - 1, -1, -1):
        st[i] = acc
        acc *= shape[i]
    return st


def _offsets(dims, strides) -> np.ndarray:
    """Element offsets of every row-major coordinate over ``dims``."""
    off = np.zeros(1, dtype=np.int64)
    for d, s in zip(dims, strides):
        step = np.arange(d, dtype=np.int64) * s
        off = (off[:, None] + step[None, :]).reshape(-1)
    return off


def role_tables(dims, strides) -> tuple[np.ndarray, np.ndarray, int]:
    """``(hi, lo, lo_n)`` with offset(i) = hi[i // lo_n] + lo[i % lo_n]
    for the flat index ``i`` of one GEMM role (``dims``/``strides`` are
    the role's axes in role order)."""
    j, _, lo_n = suffix_tile_split(tuple(dims), _LO_TARGET)
    return _offsets(dims[:j], strides[:j]), _offsets(dims[j:], strides[j:]), lo_n


@dataclasses.dataclass(frozen=True)
class Role:
    """One GEMM role of an operand: its axes' sizes and element strides,
    in role order."""

    dims: tuple[int, ...]
    strides: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def step_roles(form) -> list[Role]:
    """The nine roles of ``form`` in descriptor order: A's (batch, m, k),
    B's (batch, k, n) and the output's (batch, m, n).  The operands are
    contiguous in their native layouts; the output is contiguous in
    ``inds_out`` order."""
    nb, nm = len(form.batch_shape), len(form.m_shape)
    nk = len(form.k_shape)
    a_st, b_st = _strides(form.a_shape), _strides(form.b_shape)
    natural = form.batch_shape + form.m_shape + form.n_shape
    o_st_perm = _strides(form.out_shape)
    o_st = [0] * len(natural)
    for j, q in enumerate(form.out_perm):
        o_st[q] = o_st_perm[j]

    def role(shape, st, axes):
        return Role(tuple(shape[p] for p in axes), tuple(st[p] for p in axes))

    pa, pb = form.perm_a, form.perm_b
    nat = range(len(natural))
    return [
        role(form.a_shape, a_st, pa[:nb]),
        role(form.a_shape, a_st, pa[nb:nb + nm]),
        role(form.a_shape, a_st, pa[nb + nm:]),
        role(form.b_shape, b_st, pb[:nb]),
        role(form.b_shape, b_st, pb[nb:nb + nk]),
        role(form.b_shape, b_st, pb[nb + nk:]),
        role(natural, o_st, nat[:nb]),
        role(natural, o_st, nat[nb:nb + nm]),
        role(natural, o_st, nat[nb + nm:]),
    ]


def _role_offsets_at(role: Role, idx) -> np.ndarray:
    """Offsets of the flat role indices ``idx``."""
    idx = np.asarray(idx, dtype=np.int64)
    off = np.zeros(idx.shape, dtype=np.int64)
    for d, s in zip(reversed(role.dims), reversed(role.strides)):
        off += (idx % d) * s
        idx = idx // d
    return off


def _descriptor(B: int, M: int, N: int, K: int, roles) -> np.ndarray:
    words = [B, M, N, K]
    tables = []
    pos = 33
    for r in roles:
        hi, lo, lo_n = role_tables(list(r.dims), list(r.strides))
        words += [pos, pos + hi.size, lo_n]
        tables += [hi, lo]
        pos += hi.size + lo.size
    # the k-tile starts of A's and B's k roles (D_KA, D_KB)
    starts = np.arange(0, K, FUSED_BK)
    ka, kb = _role_offsets_at(roles[2], starts), _role_offsets_at(roles[4], starts)
    words += [pos, pos + ka.size]
    return np.concatenate([np.asarray(words, dtype=np.int64), *tables, ka, kb])


def step_descriptor(form) -> np.ndarray:
    """The step descriptor for one GEMM form (layout in
    ``csrc/gemm.cu``): B, M, N, K, then (hi, lo, lo_n) for the nine
    operand roles of :func:`step_roles`, the positions of A's and B's
    k-tile offsets, then the tables and those offsets."""
    return _descriptor(form.B, form.M, form.N, form.K, step_roles(form))


def oriented_roles(form):
    """``(swap, B, M, N, K, roles)`` as K2 runs ``form``: when N > M the
    operands trade places (C^T = B^T A^T), so the larger side is the
    wgmma M side; B's n role then gives the rows and the output's m and n
    roles swap with it."""
    r = step_roles(form)
    if form.N <= form.M:
        return False, form.B, form.M, form.N, form.K, r
    ab, am, ak, bb, bk, bn, ob, om, on = r
    return True, form.B, form.N, form.M, form.K, [bb, bn, bk, ab, ak, am, ob, on, om]


def fused_tile(n: int) -> tuple[int, int]:
    """K2's tile (rows, columns) for an oriented step with ``n`` columns:
    128 x 64 up to 64 columns, else 64 x 128 (two consumer warpgroups
    of 64 x 64 either way)."""
    return (128, 64) if n <= 64 else (64, 128)


def tile_uniform(dims, extent: int) -> bool:
    """Whether every tile of ``extent`` consecutive role indices has the
    offsets of the first tile, shifted: the role has at most ``extent``
    indices, or ``extent`` is the product of a run of its trailing axes."""
    if math.prod(dims) <= extent:
        return True
    p = 1
    for d in reversed(dims):
        if p == extent:
            return True
        p *= d
    return p == extent


def tile_offsets(rows: Role, ks: Role, R: int) -> np.ndarray:
    """The native offsets of the first ``R x FUSED_BK`` tile of an
    operand relative to its base, by (row, k); -1 outside the operand."""
    nr, nk = min(rows.size, R), min(ks.size, FUSED_BK)
    rel = np.full((R, FUSED_BK), -1, dtype=np.int64)
    rel[:nr, :nk] = (_role_offsets_at(rows, np.arange(nr))[:, None]
                     + _role_offsets_at(ks, np.arange(nk))[None, :])
    return rel


def gather_map(rows: Role, ks: Role, R: int):
    """K2's gather map for one operand's ``R x FUSED_BK`` tile:
    ``(rel, slot, uniform)``.  ``slot`` lists the tile's slots
    (row * FUSED_BK + k) in ascending native offset relative to the
    tile's base, the slots outside the operand last; ``rel`` is each
    slot's offset (-1 outside).  ``uniform`` says every tile has these
    offsets (:func:`tile_uniform` on both roles); otherwise the kernel
    addresses each slot through per-tile tables and the map gives only
    the order."""
    rel = tile_offsets(rows, ks, R).reshape(-1)
    slot = np.lexsort((rel, rel < 0))  # inside first, by offset
    uniform = (tile_uniform(rows.dims, R) and tile_uniform(ks.dims, FUSED_BK)
               and int(rel.max()) <= _INT32_MAX)
    return rel[slot], slot, uniform


def _tile_local(role: Role, R: int) -> np.ndarray:
    """The first ``R`` offsets of a role, zero past its end."""
    out = np.zeros(R, dtype=np.int64)
    n = min(role.size, R)
    out[:n] = _role_offsets_at(role, np.arange(n))
    return out


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """K2's host state for one step form: orientation, tile shape,
    descriptor and maps.  ``maps`` holds, for A then B, ``R * FUSED_BK``
    offsets and as many slots (uniform: the :func:`chunk_map` lists,
    zero-padded; general: the :func:`gather_map` slots, offsets unused),
    then the output's tile-local row and column offsets, then A's and
    B's chunk k offsets (4 each)."""

    swap: bool
    wide: bool  # the 64 x 128 tile
    uniform: bool
    tiles: int
    desc: np.ndarray
    maps: np.ndarray


_GATHER_THREADS = 256  # K2's producer threads (F_PT): thread t takes t + 256 c


def swizzle_offset(slot):
    """Byte offset of slot ``row * 32 + k`` in a K-major TF32 plane with
    the 128-byte swizzle: 16-byte chunk ``k // 4`` XOR ``row % 8``
    (``swz`` in ``csrc/gemm.cu``)."""
    slot = np.asarray(slot, dtype=np.int64)
    row, k = slot >> 5, slot & 31
    return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + ((k & 3) << 2)


def chunk_map(grid: np.ndarray):
    """K2's uniform map of one operand's whole tile (``grid``: offsets by
    (row, k), from :func:`tile_offsets`), in 16-byte chunks of four
    consecutive k: ``(crel, csw, kj)`` with the chunks in ascending native
    offset, ``crel`` each chunk's offset, ``csw`` its swizzled byte offset
    and ``kj`` the offsets of its four k from its first; None unless every
    chunk shares ``kj`` and both lists split as the producer reads them:
    chunk ``t + 256 c`` at ``crel[t] + crel[256 c]`` and
    ``csw[t] ^ csw[256 c]``."""
    R = grid.shape[0]
    if (grid < 0).any() or (R * FUSED_BK // 4) % _GATHER_THREADS:
        return None
    chunks = grid.reshape(R, FUSED_BK // 4, 4)
    kj = chunks[0, 0] - chunks[0, 0, 0]
    if not (chunks - chunks[:, :, :1] == kj).all():
        return None
    order = np.argsort(chunks[:, :, 0].reshape(-1), kind="stable")
    crel = chunks[:, :, 0].reshape(-1)[order]
    csw = swizzle_offset((order // (FUSED_BK // 4)) * FUSED_BK
                         + (order % (FUSED_BK // 4)) * 4)
    r = crel.reshape(-1, _GATHER_THREADS)
    w = csw.reshape(-1, _GATHER_THREADS)
    if not ((r == r[:1] + r[:, :1]).all() and (w == w[:1] ^ w[:, :1]).all()):
        return None
    return crel, csw, kj


def fused_plan(form) -> FusedPlan:
    """K2's plan for ``form``: uniform (every tile read through the same
    chunk maps, output included) or general (per-tile tables)."""
    swap, B, M, N, K, roles = oriented_roles(form)
    BM, BN = fused_tile(N)
    grids = (tile_offsets(roles[1], roles[2], BM), tile_offsets(roles[5], roles[4], BN))
    maps_ab = [gather_map(roles[1], roles[2], BM), gather_map(roles[5], roles[4], BN)]
    chunked = [chunk_map(g) for g in grids]
    o_row, o_col = _tile_local(roles[7], BM), _tile_local(roles[8], BN)
    uniform = (all(m[2] for m in maps_ab) and all(c is not None for c in chunked)
               and tile_uniform(roles[7].dims, BM)
               and tile_uniform(roles[8].dims, BN)
               and int(o_row.max()) + int(o_col.max()) <= _INT32_MAX)
    parts, kjs = [], []
    for (_, slot, _), c in zip(maps_ab, chunked):
        if uniform:
            crel, csw, kj = c
            pad = np.zeros(slot.size - crel.size, dtype=np.int64)
            parts += [np.concatenate([crel, pad]), np.concatenate([csw, pad])]
            kjs.append(kj)
        else:
            parts += [np.zeros_like(slot), slot]
            kjs.append(np.zeros(4, dtype=np.int64))
    maps = np.concatenate(parts + [o_row, o_col] + kjs).astype(np.int32)
    tiles = B * -(-M // BM) * -(-N // BN)
    return FusedPlan(swap, BN == 128, uniform, tiles,
                     _descriptor(B, M, N, K, roles), maps)


_FUSED: dict = {}


def _device_plan(form, device: torch.device):
    """``(plan, desc, maps)`` of K2 with the tables on ``device``, built
    once per (form, device)."""
    key = (form, device)
    hit = _FUSED.get(key)
    if hit is None:
        plan = fused_plan(form)
        hit = (plan, torch.from_numpy(plan.desc).to(device),
               torch.from_numpy(plan.maps).to(device))
        _FUSED[key] = hit
    return hit


def fused_gemm_plain(a, b, form, precision: str = "fp32") -> tuple[torch.Tensor, ...]:
    """Plain version of K2 (and of one chain step, the reference's
    ``_chain_step_math``): permute + reshape + ``torch.matmul`` on each
    plane, Karatsuba when ``a``/``b`` are ``(re, im)`` pairs, output in
    ``inds_out`` order.  ``precision="bf16"`` rounds every plane to bf16
    first (the kernel's rounding at its loads); the Karatsuba sums of
    rounded planes and the products are then exact in fp32, so only the
    summation order differs from the kernel's direct form."""
    if precision == "bf16":
        a, b = tuple(map(round16, a)), tuple(map(round16, b))

    def gemm(x, y):
        x2 = permute_reshape(x, form.perm_a, (form.B, form.M, form.K))
        y2 = permute_reshape(y, form.perm_b, (form.B, form.K, form.N))
        out = torch.matmul(x2, y2).reshape(
            form.batch_shape + form.m_shape + form.n_shape
        )
        return out.permute(form.out_perm).contiguous()

    if len(a) == 2:
        ar, ai = a
        br, bi = b
        p1 = gemm(ar, br)
        p2 = gemm(ai, bi)
        p3 = gemm(ar + ai, br + bi)
        return (p1 - p2, p3 - p1 - p2)
    return (gemm(a[0], b[0]),)


def _check_shape(x: torch.Tensor, want, what: str) -> None:
    if tuple(x.shape) != want:
        raise ValueError(f"{what} {tuple(x.shape)} != {want}")


def _planes_of(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return (x.real, x.imag) if x.is_complex() else (x,)


def fused_gemm_c64(a: torch.Tensor, b: torch.Tensor, form, *,
                   precision: str = "fp32", out16: bool = False) -> torch.Tensor:
    """K2: one contraction step ``form`` on ``a`` and ``b`` in their
    native layouts, output in ``inds_out`` order.  Both complex (read and
    written in place as (re, im) pairs) or both real, each at full width
    (complex64, float32) or half (bf16 pairs, bf16).  ``precision``
    picks the route (3xTF32, or bf16 inputs with fp32 accumulation);
    ``out16`` writes the output at half width.  One kernel launch."""
    return _step(0, a, b, form, precision, out16)


def _step(tiled: int, a, b, form, precision: str, out16: bool) -> torch.Tensor:
    """One step on K2's kernel body: K1's kernel (``tiled``) or K2's."""
    _check_precision(precision)
    ca, ha = operand_kind(a, form.a_shape)
    cb, hb = operand_kind(b, form.b_shape)
    if ca != cb:
        raise TypeError("operands must both be real or both complex")
    if _on_cpu(a, b):
        out = fused_gemm_plain(_planes_of(widen(a, form.a_shape)),
                               _planes_of(widen(b, form.b_shape)), form, precision)
        return _plain_result(torch.complex(*out) if ca else out[0], out16)
    a, b = a.contiguous(), b.contiguous()
    out = _empty_out(form.out_shape, ca, out16, a.device)
    if out.numel() == 0:
        return out
    if form.K == 0:
        return out.zero_()
    lib = load_library("gemm")
    name = "tiled_gemm" if tiled else "fused_gemm"
    rc = _launch_inplace(lib, tiled, form, a, b, out, precision, ca, ha, hb, out16)
    check(lib, rc, name)
    LAUNCHES[name] += 1
    BF16_LAUNCHES[name] += precision == "bf16"
    return out


def _join(planes) -> torch.Tensor:
    """One operand from its planes: ``(re,)`` as it is; ``(re, im)`` as
    complex64, or as bf16 pairs when the planes are bf16."""
    if len(planes) == 1:
        return planes[0]
    if planes[0].dtype == torch.bfloat16:
        return torch.stack(planes, dim=-1)
    return torch.complex(*planes)


def _split(x: torch.Tensor, cplx: bool) -> tuple[torch.Tensor, ...]:
    return (x.real, x.imag) if cplx else (x,)


def fused_gemm(a, b, form) -> tuple[torch.Tensor, ...]:
    """K2 on planes: ``a`` and ``b`` are ``(re,)`` or ``(re, im)`` tuples
    of fp32 (or, held at half width, bf16) planes in their native
    layouts; returns the fp32 output planes in ``inds_out`` order.  On
    the card a pair is joined for :func:`fused_gemm_c64` (the planes are
    views of its output)."""
    if len(a) != len(b) or len(a) not in (1, 2):
        raise ValueError("operands must both be (re,) or (re, im)")
    _check_planes(*a, *b)
    for x in a:
        _check_shape(x, form.a_shape, "a plane")
    for y in b:
        _check_shape(y, form.b_shape, "b plane")
    if _on_cpu(*a, *b):
        return fused_gemm_plain(tuple(x.float() for x in a),
                                tuple(y.float() for y in b), form)
    return _split(fused_gemm_c64(_join(a), _join(b), form), len(a) == 2)


# ----------------------------------------------------------------------
# K3: chain of adjacent steps in one thread-block cluster
# ----------------------------------------------------------------------
TILE_M = TILE_N = 64  # K3's output tile (C_BM, C_BN); K2's warpgroup block
CHAIN_KC = 16  # K3's k chunk (C_KC in csrc/gemm.cu)
CHAIN_CLUSTERS = (1, 2, 4, 8, 16)  # the cluster sizes K3 launches
_C_HDR, _C_SWORDS = 4, 40  # words before the steps, words per step
_C_FLAGS = 37  # the step word holding its precision and width flags
_C_SMEM_MAX = 227 * 1024  # shared memory one block can hold
_C_TILE_SMEM = 4 * (4 * CHAIN_KC * TILE_M + 4 * TILE_M + 2 * CHAIN_KC)  # ChainSmem
# each role's tile extent, in step_roles order
_C_EXTENTS = (1, TILE_M, CHAIN_KC, 1, CHAIN_KC, TILE_N, 1, TILE_M, TILE_N)


def _chain_tiles(form) -> int:
    return form.B * -(-form.M // TILE_M) * -(-form.N // TILE_N)


def chain_gemm_plain(components, forms, carry_side, complex_mode=False,
                     precisions=None):
    """Plain version of K3, the port of the reference's
    ``chain_reference``: the same externals, the same per-step Karatsuba
    on split fp32 planes, the same step order.  ``precisions[t]`` is step
    ``t``'s input precision; a bf16 step rounds its operands, the carry
    included, so rounding an interior carry at its store (as the kernel
    does into a bf16 slot) changes nothing."""
    ncomp = 2 if complex_mode else 1
    ext = [
        tuple(components[i * ncomp:(i + 1) * ncomp])
        for i in range(len(forms) + 1)
    ]
    carry = None
    for t, form in enumerate(forms):
        if t == 0:
            a, b = ext[0], ext[1]
        else:
            a, b = (
                (carry, ext[t + 1]) if carry_side[t] == "l"
                else (ext[t + 1], carry)
            )
        carry = fused_gemm_plain(a, b, form,
                                 precisions[t] if precisions else "fp32")
    return carry


def _external_shape(forms, carry_side, i: int) -> tuple[int, ...]:
    if i == 0:
        return forms[0].a_shape
    if i == 1:
        return forms[0].b_shape
    t = i - 1
    return forms[t].b_shape if carry_side[t] == "l" else forms[t].a_shape


def _check_chain(components, forms, carry_side, slot_ids, slot_elems,
                 ncomp: int) -> None:
    n = len(forms)
    if len(components) != (n + 1) * ncomp:
        raise ValueError(f"{len(components)} planes for {n} steps")
    if len(slot_ids) != n - 1:
        raise ValueError(f"{len(slot_ids)} slots for {n} steps")
    for i in range(n + 1):
        want = _external_shape(forms, carry_side, i)
        for c in components[i * ncomp:(i + 1) * ncomp]:
            if tuple(c.shape) != want:
                raise ValueError(f"external {i}: {tuple(c.shape)} != {want}")
    for t in range(n - 1):
        if math.prod(forms[t].out_shape) > slot_elems[slot_ids[t]]:
            raise ValueError(f"step {t} output overflows its slot")


def chain_role_tables(role: Role, extent: int) -> tuple[list[np.ndarray], int]:
    """K3's tables of one role: ``([hi, lo], 0)`` with offset(t, i) =
    hi[t] + lo[i] for local index ``i`` of tile ``t`` of ``extent``
    indices, when :func:`tile_uniform`; else ``([full], extent)`` with
    offset(t, i) = full[t * extent + i]."""
    off = _offsets(role.dims, role.strides)
    if not tile_uniform(role.dims, extent):
        return [off], extent
    if off.size <= extent:
        return [np.zeros(1, dtype=np.int64), off], 0
    return [off[::extent], off[:extent]], 0


def slot_widths(slot_elems, slot_prec=()) -> list[int]:
    """Each slot's extent in the workspace, in full-width elements: a bf16
    slot holds its elements as bf16 (re, im) pairs, half the bytes."""
    return [-(-e // 2) if i < len(slot_prec) and slot_prec[i] == "bf16" else e
            for i, e in enumerate(slot_elems)]


def chain_sources(forms, carry_side, slot_ids, slot_elems, slot_prec=()):
    """Per step, where its A, B and output live: ``("x", i)`` external
    ``i``, ``("w", e)`` the workspace at full-width element ``e`` (slot
    ``slot_ids[t]``, laid out by :func:`slot_widths`), ``("o",)`` the
    chain's output."""
    base = np.cumsum([0, *slot_widths(slot_elems, slot_prec)])
    n = len(forms)
    out = []
    for t in range(n):
        if t == 0:
            a, b = ("x", 0), ("x", 1)
        else:
            carry, other = ("w", int(base[slot_ids[t - 1]])), ("x", t + 1)
            a, b = (carry, other) if carry_side[t] == "l" else (other, carry)
        c = ("w", int(base[slot_ids[t]])) if t < n - 1 else ("o",)
        out.append((a, b, c))
    return out


def _step_tables(form):
    return [chain_role_tables(r, e) for r, e in zip(step_roles(form), _C_EXTENTS)]


def pack_chain(forms, sources, ext_index, flags=None) -> np.ndarray:
    """K3's words for one launch (layout in ``csrc/gemm.cu``): a header,
    ``_C_SWORDS`` words per step (B, M, N, K, tiles_m, tiles_n, tiles,
    a_src, b_src, c_dst, then (hi, lo, full) per role, then the step's
    flags: 1 bf16 inputs, 2 / 4 / 8 A / B / output held as bf16), then
    the tables, padded to a multiple of 4 words.  ``ext_index`` maps an
    external's chain index to its slot in the launch's pointer list."""
    n = len(forms)
    head = np.zeros(_C_HDR + n * _C_SWORDS, dtype=np.int64)
    head[0] = n
    tables, pos = [], head.size

    def src(s):
        return ext_index[s[1]] if s[0] == "x" else -1 - s[1]

    for t, (form, (a, b, c)) in enumerate(zip(forms, sources)):
        h = _C_HDR + t * _C_SWORDS
        tm, tn = -(-form.M // TILE_M), -(-form.N // TILE_N)
        head[h:h + 10] = [form.B, form.M, form.N, form.K, tm, tn,
                          form.B * tm * tn, src(a), src(b),
                          -1 if c[0] == "o" else c[1]]
        head[h + _C_FLAGS] = flags[t] if flags else 0
        for r, (tabs, full) in enumerate(_step_tables(form)):
            hi = pos
            lo = pos + tabs[0].size if len(tabs) == 2 else pos
            head[h + 10 + 3 * r:h + 13 + 3 * r] = [hi, lo, full]
            tables += tabs
            pos += sum(x.size for x in tabs)
    words = np.concatenate([head, *tables, np.zeros(-pos % 4, dtype=np.int64)])
    if words.size and (np.abs(words).max() > _INT32_MAX):
        raise ValueError("chain offsets exceed 32 bits")
    return words.astype(np.int32)


def chain_segments(forms) -> list[range]:
    """The launches of one chain: runs of at most ``MAX_CHAIN`` steps
    whose tables fit one block's shared memory beside its tiles."""
    budget = (_C_SMEM_MAX - _C_TILE_SMEM) // 4 - _C_HDR - 3
    segs, start, used = [], 0, 0
    for t, form in enumerate(forms):
        words = _C_SWORDS + sum(
            sum(x.size for x in tabs) for tabs, _ in _step_tables(form))
        if words > budget:
            raise ValueError(f"chain step {t}: its tables exceed shared memory")
        if t - start == MAX_CHAIN or used + words > budget:
            segs.append(range(start, t))
            start, used = t, 0
        used += words
    segs.append(range(start, len(forms)))
    return segs


_CLUSTER_MAX: dict = {}


def chain_cluster_max(device) -> int:
    """K3's default cluster: 16 blocks where the card schedules a
    non-portable cluster of 16 (asked once per device), else 8; on the
    CPU (the plain version runs there), 8."""
    device = torch.device(device)
    if device.type != "cuda":
        return 8
    n = _CLUSTER_MAX.get(device)
    if n is None:
        lib = load_library("gemm")
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            check(lib, lib.repro_chain_cluster_max(lib.repro_chain_smem(0),
                                                   ctypes.byref(out)),
                  "chain cluster query")
        n = _CLUSTER_MAX[device] = out.value
    return n


class _ChainParams(ctypes.Structure):
    """``ChainParams`` of ``csrc/gemm.cu``."""

    _fields_ = [
        ("tab", ctypes.c_void_p),
        ("ext", ctypes.c_void_p * (MAX_CHAIN + 1)),
        ("out", ctypes.c_void_p),
        ("work", ctypes.c_void_p),
        ("tab_words", ctypes.c_int),
        ("nsteps", ctypes.c_int),
    ]


def chain_flags(forms, carry_side, slot_ids, precisions=None, slot_prec=(),
                ext16=(), out16=False) -> list[int]:
    """Each step's flags word: 1 when it reads bf16 (``precisions``), 2
    and 4 when its A and B are held as bf16 (an external in ``ext16``, or
    a carry in a bf16 slot), 8 when it writes bf16 (its slot, or the
    chain's output with ``out16``)."""
    n = len(forms)

    def half_slot(t):
        return bool(slot_prec) and slot_prec[slot_ids[t]] == "bf16"

    def half_ext(i):
        return bool(ext16) and bool(ext16[i])

    out = []
    for t in range(n):
        if t == 0:
            a16, b16 = half_ext(0), half_ext(1)
        else:
            carry, other = half_slot(t - 1), half_ext(t + 1)
            a16, b16 = (carry, other) if carry_side[t] == "l" else (other, carry)
        c16 = half_slot(t) if t < n - 1 else bool(out16)
        bf = bool(precisions) and precisions[t] == "bf16"
        out.append(int(bf) | int(a16) << 1 | int(b16) << 2 | int(c16) << 3)
    return out


class ChainLaunch:
    """K3's launch state for one chain on one device, built once: per
    launch (segment) the packed words on the device, the kernel's
    argument block and the cluster size; the workspace of the carries.
    :meth:`launch` fills in the externals' and the output's pointers and
    launches, nothing else.  The workspace is shared by every call of
    the chain, so its calls must be ordered on one stream, as the
    executor's are.  ``precisions``, ``slot_prec``, ``ext16`` and
    ``out16`` fix the steps' routes and the widths the chain reads and
    writes (all fp32 and full width by default)."""

    def __init__(self, forms, carry_side, slot_ids, slot_elems, complex_mode,
                 device, cluster=None, precisions=None, slot_prec=(), ext16=(),
                 out16=False):
        n = len(forms)
        if len(slot_ids) != n - 1:
            raise ValueError(f"{len(slot_ids)} slots for {n} steps")
        for t in range(n - 1):
            if math.prod(forms[t].out_shape) > slot_elems[slot_ids[t]]:
                raise ValueError(f"step {t} output overflows its slot")
        if cluster is not None and cluster not in CHAIN_CLUSTERS:
            raise ValueError(f"cluster of {cluster} blocks")
        if precisions is not None and len(precisions) != n:
            raise ValueError(f"{len(precisions)} precisions for {n} steps")
        self.dtype = torch.complex64 if complex_mode else torch.float32
        self.complex_mode = bool(complex_mode)
        self.ext16 = tuple(bool(x) for x in ext16) or (False,) * (n + 1)
        self.out16 = bool(out16)
        self.shapes = [_external_shape(forms, carry_side, i) for i in range(n + 1)]
        self.out_shape = forms[-1].out_shape
        self.work = torch.empty(max(1, sum(slot_widths(slot_elems, slot_prec))),
                                dtype=self.dtype, device=device)
        sources = chain_sources(forms, carry_side, slot_ids, slot_elems, slot_prec)
        flags = chain_flags(forms, carry_side, slot_ids, precisions, slot_prec,
                            self.ext16, out16)
        self.segments = []
        self.bf16 = []  # per segment: whether it runs a bf16 step
        self.mixed = []  # per segment: whether a step has flags
        for steps in chain_segments(forms):
            ext = sorted({s[1] for t in steps for s in sources[t][:2] if s[0] == "x"})
            words = pack_chain([forms[t] for t in steps],
                               [sources[t] for t in steps],
                               {g: j for j, g in enumerate(ext)},
                               [flags[t] for t in steps])
            tab = torch.from_numpy(words).to(device)
            p = _ChainParams()
            p.tab, p.work = tab.data_ptr(), self.work.data_ptr()
            p.tab_words, p.nsteps = words.size, len(steps)
            most = max(_chain_tiles(forms[t]) for t in steps)
            size = max(1, min(cluster or chain_cluster_max(device), most))
            self.segments.append((p, tab, ext, size))
            self.bf16.append(any(flags[t] & 1 for t in steps))
            self.mixed.append(any(flags[t] for t in steps))

    def _want(self, i: int) -> tuple[torch.dtype, tuple[int, ...]]:
        shape = tuple(self.shapes[i])
        if not self.ext16[i]:
            return self.dtype, shape
        return torch.bfloat16, shape + ((2,) if self.complex_mode else ())

    def check(self, externals) -> None:
        if len(externals) != len(self.shapes):
            raise ValueError(f"{len(externals)} externals for {len(self.shapes) - 1} steps")
        for i, x in enumerate(externals):
            dtype, shape = self._want(i)
            if x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(f"external {i}: {x.dtype} {tuple(x.shape)}, "
                                 f"want {dtype} {shape}")

    def empty_out(self) -> torch.Tensor:
        return _empty_out(self.out_shape, self.complex_mode, self.out16,
                          self.work.device)

    def launch(self, externals, out: torch.Tensor) -> None:
        """Run the chain on contiguous ``externals`` into ``out``."""
        lib = load_library("gemm")
        stream = _stream(out.device)
        cplx = int(self.complex_mode)
        for (p, _, ext, size), bf16, mixed in zip(self.segments, self.bf16,
                                                   self.mixed):
            for j, g in enumerate(ext):
                p.ext[j] = externals[g].data_ptr()
            p.out = out.data_ptr()
            check(lib, lib.repro_chain_gemm(ctypes.byref(p), cplx, int(mixed),
                                            size, stream), "chain_gemm")
            LAUNCHES["chain_gemm"] += 1
            BF16_LAUNCHES["chain_gemm"] += bf16


_CHAINS: dict = {}
_CHAINS_MAX = 4096  # launch states kept; the cache starts over beyond


def chain_state(forms, carry_side, slot_ids, slot_elems, complex_mode,
                device, cluster=None, *, precisions=None, slot_prec=(),
                ext16=(), out16=False) -> ChainLaunch:
    """The cached :class:`ChainLaunch` of one chain on ``device``."""
    key = (tuple(forms), tuple(carry_side), tuple(slot_ids),
           tuple(slot_elems), bool(complex_mode), torch.device(device), cluster,
           tuple(precisions) if precisions else None, tuple(slot_prec),
           tuple(bool(x) for x in ext16), bool(out16))
    state = _CHAINS.get(key)
    if state is None:
        if len(_CHAINS) >= _CHAINS_MAX:
            _CHAINS.clear()
        state = ChainLaunch(*key)
        _CHAINS[key] = state
    return state


def chain_gemm_c64(operands, forms, carry_side, slot_ids, slot_elems,
                   cluster=None, *, precisions=None, slot_prec=(),
                   out16=False) -> torch.Tensor:
    """K3: run the chain ``forms`` (step ``t``'s carry is step ``t-1``'s
    output, on side ``carry_side[t]``) over its externals ``operands``,
    all complex (complex64 or bf16 pairs, read in place) or all real
    (float32 or bf16).  Interior carries live in one workspace, slot
    ``slot_ids[t]`` of ``slot_elems`` elements, held as bf16 where
    ``slot_prec`` says so.  ``precisions[t]`` is step ``t``'s route (fp32
    FFMA, or bf16 inputs with fp32 accumulation); ``out16`` writes the
    last step's output, in its ``inds_out`` order, at half width.  One
    kernel launch per ``MAX_CHAIN`` steps.  ``cluster`` overrides the
    cluster's block count (the result does not depend on it)."""
    n = len(forms)
    kinds = [operand_kind(o, _external_shape(forms, carry_side, i))
             for i, o in enumerate(operands)]
    cplx = kinds[0][0]
    if any(k[0] != cplx for k in kinds):
        raise TypeError("chain externals must all be real or all complex")
    if len(operands) != n + 1:
        raise ValueError(f"{len(operands)} externals for {n} steps")
    if _on_cpu(*operands):
        wide = [widen(o, _external_shape(forms, carry_side, i))
                for i, o in enumerate(operands)]
        comps = [c for o in wide for c in _planes_of(o)]
        _check_chain(comps, forms, carry_side, slot_ids, slot_elems, 2 if cplx else 1)
        out = chain_gemm_plain(comps, forms, carry_side, cplx, precisions)
        return _plain_result(torch.complex(*out) if cplx else out[0], out16)
    device = operands[0].device
    state = chain_state(forms, carry_side, slot_ids, slot_elems, cplx, device,
                        cluster, precisions=precisions, slot_prec=slot_prec,
                        ext16=[k[1] for k in kinds], out16=out16)
    ext = [o if o.is_contiguous() else o.contiguous() for o in operands]
    state.check(ext)
    out = state.empty_out()
    state.launch(ext, out)
    return out


def _joined(components, n: int, complex_mode: bool):
    """The chain's externals from its planes (fp32 or bf16)."""
    if complex_mode:
        return [_join((components[2 * i], components[2 * i + 1]))
                for i in range(n + 1)]
    return [c.contiguous() for c in components]


def chain_gemm(
    components,
    forms,
    carry_side,
    slot_ids,
    slot_elems,
    complex_mode: bool = False,
    cluster=None,
):
    """K3 on planes ``components`` (``(re, im)`` per external when
    ``complex_mode``; fp32, or bf16 for externals held at half width).
    Returns the last step's fp32 output planes in its ``inds_out`` order;
    on the card a complex chain's planes are joined for
    :func:`chain_gemm_c64` and the returned planes are views of its
    output."""
    ncomp = 2 if complex_mode else 1
    _check_chain(components, forms, carry_side, slot_ids, slot_elems, ncomp)
    _check_planes(*components)
    if _on_cpu(*components):
        return chain_gemm_plain([c.float() for c in components], forms,
                                carry_side, complex_mode)
    out = chain_gemm_c64(_joined(components, len(forms), complex_mode), forms,
                         carry_side, slot_ids, slot_elems, cluster)
    return _split(out, complex_mode)


def chain_gemm_launcher(
    components,
    forms,
    carry_side,
    slot_ids,
    slot_elems,
    complex_mode: bool = False,
    cluster=None,
    precisions=None,
    slot_prec=(),
):
    """The host half of :func:`chain_gemm` on CUDA planes: joins the
    planes and takes the chain's cached launch state once, and returns
    ``(launch, outs)``.  Each ``launch()`` runs the chain's kernel
    launches into ``outs`` and nothing else, so a timing loop over it
    measures the kernel without the host work."""
    ncomp = 2 if complex_mode else 1
    _check_chain(components, forms, carry_side, slot_ids, slot_elems, ncomp)
    _check_planes(*components)
    if _on_cpu(*components):
        raise ValueError("chain_gemm_launcher takes CUDA planes")
    device = components[0].device
    ext = _joined(components, len(forms), complex_mode)
    state = chain_state(forms, carry_side, slot_ids, slot_elems, complex_mode,
                        device, cluster, precisions=precisions,
                        slot_prec=tuple(slot_prec),
                        ext16=[x.dtype == torch.bfloat16 for x in ext])
    state.check(ext)
    out = state.empty_out()

    def launch() -> None:
        state.launch(ext, out)

    launch.buffers = (ext, state)
    return launch, _split(out, complex_mode)


def empty_cluster_launch(cluster: int, device, barriers: int = 0) -> None:
    """One launch of an empty kernel as a cluster of ``cluster`` blocks of
    K3's size that meets at ``barriers`` cluster barriers: the floor of a
    K3 launch and of its barriers between steps, for timing."""
    lib = load_library("gemm")
    check(lib, lib.repro_empty_cluster(cluster, barriers, _stream(device)),
          "empty cluster")
