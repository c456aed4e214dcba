"""The stem-contraction GEMM kernels on Hopper, with their plain versions.

Three hand-written CUDA kernels (``csrc/gemm.cu``) replace the three
Pallas kernels of the reference's ``src/repro/kernels/contract_gemm.py``:

  * :func:`tiled_gemm` (K1) replaces ``tiled_matmul`` (``_matmul_kernel``):
    ``C[b] = A[b] @ B[b]`` in fp32 as 3xTF32 on the tensor cores
    (``wgmma``): the wrapper writes each operand as TF32 hi and lo planes
    in K-major order (:func:`tf32_planes`, plain tensor code), the kernel
    sums ``a_hi.b_hi + a_hi.b_lo + a_lo.b_hi`` in fp32;
  * :func:`fused_gemm` (K2) replaces ``fused_transpose_matmul``
    (``_fused_kernel``): one contraction step on operands in their native
    tree layouts, gathered through per-role offset tables built once per
    step form, with the output written straight into ``inds_out`` order;
  * :func:`chain_gemm` (K3) replaces ``fused_chain_matmul``
    (``_chain_kernel``/``_run_chain``): a run of adjacent steps in one
    cooperative persistent launch, interior carries in a device
    workspace laid out by the planner's ``slot_ids``/``slot_elems``.

Each kernel has a plain PyTorch version of the same function in this
module (permute + reshape + ``torch.matmul``; for K3 the port of
``chain_reference``).  A wrapper uses the plain version only when its
tensors lie on the CPU; for CUDA tensors it launches its kernel or
raises.  :data:`LAUNCHES` counts kernel launches, one per launch.

What bounds each kernel on the H100, and why, is noted at the top of
``csrc/gemm.cu``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..lowering.refiner import suffix_tile_split
from .build import check, load_library
from .build import cuda_stream as _stream
from .build import on_cpu as _on_cpu
from .ref import permute_reshape

TILE_M = TILE_N = 64  # K2/K3's output tile (BM, BN in csrc/gemm.cu)
MAX_CHAIN = 32  # steps per chain launch (MAX_CHAIN in csrc/gemm.cu)
# a role's flat index splits into (hi, lo) table lookups; the lo table
# covers the longest axis suffix with at most this many entries
_LO_TARGET = 4096

LAUNCHES = {"tiled_gemm": 0, "fused_gemm": 0, "chain_gemm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_fp32(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"kernel takes float32 planes, got {t.dtype}")


def _tiles(B: int, M: int, N: int) -> int:
    return B * -(-M // TILE_M) * -(-N // TILE_N)


# ----------------------------------------------------------------------
# K1: tiled GEMM, 3xTF32 on wgmma
# ----------------------------------------------------------------------
def tiled_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``torch.matmul`` per batch cell."""
    return torch.matmul(a, b)


_TF32_HALF = 1 << 12
_TF32_MASK = -(1 << 13)  # 0xFFFFE000 as int32
TF32_K_ALIGN = 4  # TMA's 16-byte row stride, in fp32


def tf32_split(x: torch.Tensor) -> torch.Tensor:
    """K1's operand planes: ``(2, *x.shape[:-1], Kp)`` holding
    ``x_hi = tf32(x)`` and ``x_lo = tf32(x - x_hi)`` along the last axis
    (K), zero-padded to ``Kp``, the next multiple of :data:`TF32_K_ALIGN`.
    ``tf32`` rounds to 10 explicit mantissa bits, to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: an integer add of half
    the dropped field, then a mask of the 13 dropped bits.  ``x`` may be
    a strided view; the planes are contiguous."""
    *lead, k = x.shape
    kp = -(-k // TF32_K_ALIGN) * TF32_K_ALIGN
    out = torch.empty((2, *lead, kp), dtype=torch.float32, device=x.device)
    if kp > k:
        out[..., k:] = 0
    hi, lo = out[0, ..., :k], out[1, ..., :k]
    hi_bits, lo_bits = hi.view(torch.int32), lo.view(torch.int32)
    torch.add(x.view(torch.int32), _TF32_HALF, out=hi_bits)
    hi_bits.bitwise_and_(_TF32_MASK)
    torch.sub(x, hi, out=lo)  # exact: hi holds x's leading 11 bits
    lo_bits.add_(_TF32_HALF).bitwise_and_(_TF32_MASK)
    return out


def tf32_planes(a: torch.Tensor, b: torch.Tensor):
    """The four K-major planes K1 reads: ``A_hi, A_lo`` of (B, M, Kp) as
    ``tf32_split(a)`` and ``Bt_hi, Bt_lo`` of (B, N, Kp) as
    ``tf32_split(b^T)`` (TF32 wgmma takes K-major operands only)."""
    return tf32_split(a), tf32_split(b.transpose(1, 2))


def tiled_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K1: ``C[i] = A[i] @ B[i]`` for fp32 ``a`` (B, M, K) and ``b``
    (B, K, N), each product as three TF32 products (3xTF32, about 22 of
    fp32's 24 mantissa bits), accumulated in fp32 with one ordered sum
    over K per output element."""
    _check_fp32(a, b)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or (
        a.shape[2] != b.shape[1]
    ):
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if _on_cpu(a, b):
        return tiled_gemm_plain(a, b)
    B, M, K = a.shape
    N = b.shape[2]
    c = torch.empty((B, M, N), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    ap, bp = tf32_planes(a, b)
    lib = load_library("gemm")
    rc = lib.repro_tiled_gemm(
        ap[0].data_ptr(), ap[1].data_ptr(), bp[0].data_ptr(), bp[1].data_ptr(),
        c.data_ptr(), B, M, N, ap.shape[-1], _stream(a.device),
    )
    check(lib, rc, "tiled_gemm")
    LAUNCHES["tiled_gemm"] += 1
    return c


# ----------------------------------------------------------------------
# K2: fused transpose-GEMM over native layouts
# ----------------------------------------------------------------------
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


def step_descriptor(form) -> np.ndarray:
    """The kernel's step descriptor for one GEMM form (layout in
    ``csrc/gemm.cu``): B, M, N, K, then (hi, lo, lo_n) for the nine
    operand roles, then the tables.  The operands are contiguous in
    their native layouts; the output is contiguous in ``inds_out``
    order."""
    nb, nm = len(form.batch_shape), len(form.m_shape)
    nk = len(form.k_shape)
    a_shape, b_shape = form.a_shape, form.b_shape
    a_st, b_st = _strides(a_shape), _strides(b_shape)
    natural = form.batch_shape + form.m_shape + form.n_shape
    o_st_perm = _strides(form.out_shape)
    o_st = [0] * len(natural)
    for j, q in enumerate(form.out_perm):
        o_st[q] = o_st_perm[j]

    def role(shape, st, axes):
        return role_tables([shape[p] for p in axes], [st[p] for p in axes])

    pa, pb = form.perm_a, form.perm_b
    nat = range(len(natural))
    roles = [
        role(a_shape, a_st, pa[:nb]),
        role(a_shape, a_st, pa[nb:nb + nm]),
        role(a_shape, a_st, pa[nb + nm:]),
        role(b_shape, b_st, pb[:nb]),
        role(b_shape, b_st, pb[nb:nb + nk]),
        role(b_shape, b_st, pb[nb + nk:]),
        role(natural, o_st, nat[:nb]),
        role(natural, o_st, nat[nb:nb + nm]),
        role(natural, o_st, nat[nb + nm:]),
    ]
    words = [form.B, form.M, form.N, form.K]
    tables = []
    pos = 31
    for hi, lo, lo_n in roles:
        words += [pos, pos + hi.size, lo_n]
        tables += [hi, lo]
        pos += hi.size + lo.size
    return np.concatenate([np.asarray(words, dtype=np.int64)] + tables)


_DESCS: dict = {}


def _device_descriptor(form, device: torch.device) -> torch.Tensor:
    """Step descriptor on the device, built once per (form, device)."""
    key = (form, device)
    d = _DESCS.get(key)
    if d is None:
        d = torch.from_numpy(step_descriptor(form)).to(device)
        _DESCS[key] = d
    return d


def fused_gemm_plain(a, b, form) -> tuple[torch.Tensor, ...]:
    """Plain version of K2 (and of one chain step, the reference's
    ``_chain_step_math``): permute + reshape + ``torch.matmul`` on each
    plane, Karatsuba when ``a``/``b`` are ``(re, im)`` pairs, output in
    ``inds_out`` order."""

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


def fused_gemm(a, b, form) -> tuple[torch.Tensor, ...]:
    """K2: one contraction step ``form`` on fp32 planes in their native
    layouts.  ``a`` and ``b`` are ``(re,)`` or ``(re, im)`` tuples; a
    pair runs the 3-real-GEMM Karatsuba inside the kernel.  Returns the
    output planes in ``inds_out`` order."""
    if len(a) != len(b) or len(a) not in (1, 2):
        raise ValueError("operands must both be (re,) or (re, im)")
    _check_fp32(*a, *b)
    for x in a:
        if tuple(x.shape) != form.a_shape:
            raise ValueError(f"a plane {tuple(x.shape)} != {form.a_shape}")
    for y in b:
        if tuple(y.shape) != form.b_shape:
            raise ValueError(f"b plane {tuple(y.shape)} != {form.b_shape}")
    if _on_cpu(*a, *b):
        return fused_gemm_plain(a, b, form)
    device = a[0].device
    a = tuple(x.contiguous() for x in a)
    b = tuple(y.contiguous() for y in b)
    outs = tuple(
        torch.empty(form.out_shape, dtype=torch.float32, device=device)
        for _ in a
    )
    tiles = _tiles(form.B, form.M, form.N)
    if tiles == 0:
        return outs
    desc = _device_descriptor(form, device)
    lib = load_library("gemm")
    kara = len(a) == 2
    rc = lib.repro_fused_gemm(
        desc.data_ptr(), tiles, int(kara),
        a[0].data_ptr(), a[-1].data_ptr(), b[0].data_ptr(), b[-1].data_ptr(),
        outs[0].data_ptr(), outs[-1].data_ptr(), _stream(device),
    )
    check(lib, rc, "fused_gemm")
    LAUNCHES["fused_gemm"] += 1
    return outs


# ----------------------------------------------------------------------
# K3: chain of adjacent steps in one persistent launch
# ----------------------------------------------------------------------
def chain_gemm_plain(components, forms, carry_side, complex_mode=False):
    """Plain version of K3, the port of the reference's
    ``chain_reference``: the same externals, the same per-step Karatsuba
    on split fp32 planes, the same step order."""
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
        carry = fused_gemm_plain(a, b, form)
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
    _check_fp32(*components)
    for i in range(n + 1):
        want = _external_shape(forms, carry_side, i)
        for c in components[i * ncomp:(i + 1) * ncomp]:
            if tuple(c.shape) != want:
                raise ValueError(f"external {i}: {tuple(c.shape)} != {want}")
    for t in range(n - 1):
        if math.prod(forms[t].out_shape) > slot_elems[slot_ids[t]]:
            raise ValueError(f"step {t} output overflows its slot")


def chain_gemm(
    components,
    forms,
    carry_side,
    slot_ids,
    slot_elems,
    complex_mode: bool = False,
):
    """K3: run the chain ``forms`` (step ``t``'s carry is step ``t-1``'s
    output, on side ``carry_side[t]``) over its external fp32 planes
    ``components`` (``(re, im)`` per external when ``complex_mode``).
    Interior carries live in one workspace, slot ``slot_ids[t]`` of
    ``slot_elems`` elements per plane.  Returns the last step's output
    planes in its ``inds_out`` order."""
    if _on_cpu(*components):
        _check_chain(components, forms, carry_side, slot_ids, slot_elems,
                     2 if complex_mode else 1)
        return chain_gemm_plain(components, forms, carry_side, complex_mode)
    launch, outs = chain_gemm_launcher(
        components, forms, carry_side, slot_ids, slot_elems, complex_mode
    )
    launch()
    return outs


def chain_gemm_launcher(
    components,
    forms,
    carry_side,
    slot_ids,
    slot_elems,
    complex_mode: bool = False,
):
    """The host half of :func:`chain_gemm` on CUDA planes: builds the
    launch arguments (device tables, workspace, grid barrier, pointer
    arrays) once and returns ``(launch, outs)``.  Each ``launch()`` runs
    the chain's kernel launches into ``outs`` and nothing else, so a
    timing loop over it measures the kernel without the host work."""
    ncomp = 2 if complex_mode else 1
    n = len(forms)
    _check_chain(components, forms, carry_side, slot_ids, slot_elems, ncomp)
    if _on_cpu(*components):
        raise ValueError("chain_gemm_launcher takes CUDA planes")
    device = components[0].device
    comps = [c.contiguous() for c in components]
    ext = [comps[i * ncomp:(i + 1) * ncomp] for i in range(n + 1)]
    work = torch.empty(
        max(1, sum(slot_elems) * ncomp), dtype=torch.float32, device=device
    )
    base, acc = [], 0
    for e in slot_elems:
        base.append(acc)
        acc += e * ncomp
    wp = work.data_ptr()

    def slot(s: int) -> list[int]:
        return [wp + 4 * (base[s] + c * slot_elems[s]) for c in range(ncomp)]

    outs = tuple(
        torch.empty(forms[-1].out_shape, dtype=torch.float32, device=device)
        for _ in range(ncomp)
    )
    descs = [_device_descriptor(f, device) for f in forms]
    tiles = [_tiles(f.B, f.M, f.N) for f in forms]
    ptr_a, ptr_b, ptr_c = [], [], []
    for t in range(n):
        if t == 0:
            a = [x.data_ptr() for x in ext[0]]
            b = [x.data_ptr() for x in ext[1]]
        else:
            carry = slot(slot_ids[t - 1])
            other = [x.data_ptr() for x in ext[t + 1]]
            a, b = (carry, other) if carry_side[t] == "l" else (other, carry)
        c = slot(slot_ids[t]) if t < n - 1 else [o.data_ptr() for o in outs]
        ptr_a.append(a)
        ptr_b.append(b)
        ptr_c.append(c)
    lib = load_library("gemm")
    grid = ctypes.c_int(0)
    check(lib, lib.repro_chain_grid(ncomp - 1, max(tiles), ctypes.byref(grid)),
          "chain_gemm occupancy")
    bar = torch.zeros(2, dtype=torch.int32, device=device)
    stream = _stream(device)

    def arr(ctype, vals):
        return (ctype * len(vals))(*vals)

    P = ctypes.c_void_p
    segments = []
    for s0 in range(0, n, MAX_CHAIN):
        sl = range(s0, min(n, s0 + MAX_CHAIN))
        segments.append((
            len(sl), ncomp - 1,
            arr(P, [descs[t].data_ptr() for t in sl]),
            arr(ctypes.c_longlong, [tiles[t] for t in sl]),
            arr(P, [ptr_a[t][0] for t in sl]),
            arr(P, [ptr_a[t][-1] for t in sl]),
            arr(P, [ptr_b[t][0] for t in sl]),
            arr(P, [ptr_b[t][-1] for t in sl]),
            arr(P, [ptr_c[t][0] for t in sl]),
            arr(P, [ptr_c[t][-1] for t in sl]),
            bar.data_ptr(), grid.value, stream,
        ))

    def launch() -> None:
        for args in segments:
            check(lib, lib.repro_chain_gemm(*args), "chain_gemm")
            LAUNCHES["chain_gemm"] += 1

    # the device buffers the pointer arrays point into live with the launcher
    launch.buffers = (comps, work, bar, descs)
    return launch, outs
