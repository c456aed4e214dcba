"""The products the sharded step splits over "model", in one process.

``parallel.tp_local.check_block`` runs every rank's share of a layer's
blocks alone (no group: each conjugate op the identity) and sums them,
against the whole blocks on the same fp32 input and upstream gradient:
outputs, input gradients and every weight's gradient within 1e-6 of
max|whole| (they differ in the order of the sums only).  ``DecoderLM``'s
attention and SwiGLU: qwen3-4b's shrink has one kv head, so on P ranks
``wk``/``wv`` stay replicated and each rank's q heads read kv head 0;
deepseek-7b's has four, split with the q heads.  The encoder-decoder's
encoder, decoder and cross-attention blocks (seamless-m4t-medium), the
hybrid's Mamba-2 mixer and shared block (zamba2-7b) and the SSM's mixer
(mamba2-130m), whose gated norm's statistic the ranks replay from each
other's sums.

The MoE layer (deepseek-moe-16b's shrink, on inputs that lean to the
same experts, so that the capacity drops slots): each rank's routed experts are its E/P, its
shared experts' columns F/P, the routing whole on each rank.

The vocabulary-parallel loss (``losses.chunked_cross_entropy`` with
``tp``) runs its P ranks as threads whose all-reduces meet at a barrier:
the loss and the gradients of the hidden states and of the head against
the whole loss's, at 1e-6.  So does the MoE layer with its aux loss in
the objective: the router's gradient on every rank is the whole's (the
aux loss's share counted once).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.models import build_model, param_defs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.losses import chunked_cross_entropy  # noqa: E402
from repro_torch.parallel import sharding, tp_local  # noqa: E402

TOL = 1e-6
B, S = 2, 128


def _model(arch):
    cfg = smoke_shrink(get_config(arch))
    model = build_model(cfg, seed=0, device="cpu")
    return model.to(torch.float32)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-7b", "qwen2-vl-72b"])
def test_local_blocks_sum_to_the_whole_block(arch, size, monkeypatch):
    """``DecoderLM``'s attention and SwiGLU; the VLM backbone's attention
    on M-RoPE positions (3, B, S), each axis its own (random) positions,
    which reach every rank's rotary phase as the whole block's."""
    model = _model(arch)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))).float()
    positions = (torch.from_numpy(rng.integers(0, S, (3, B, S)))
                 if cfg.mrope else None)
    heads, rotated = [], []
    plain, plain_mrope = L.blockwise_attention, L.apply_mrope

    def recorded(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return plain(q, k, v, **kw)

    def mrope(x, pos, *a, **kw):
        rotated.append(pos)
        return plain_mrope(x, pos, *a, **kw)

    monkeypatch.setattr(L, "blockwise_attention", recorded)
    monkeypatch.setattr(L, "apply_mrope", mrope)
    for block in ("attention", "mlp"):
        dy = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))).float()
        got = tp_local.check_block(
            model, 0, block, h, dy, size,
            positions=positions if block == "attention" else None)
        assert got["out"] <= TOL and got["dx"] <= TOL, (block, got)
        assert max(got["grads"].values()) <= TOL, (block, got)
    # the whole block, then each rank on H/P q heads, over the kv heads
    # its q heads read: KV/P of them where KV divides P, else one
    kv = (cfg.num_kv_heads // size if cfg.num_kv_heads % size == 0 else 1)
    assert heads == [(cfg.num_heads, cfg.num_kv_heads)] + [
        (cfg.num_heads // size, kv)] * size
    # q and k rotated by the given positions: the whole block's, then
    # each rank's
    assert len(rotated) == (2 * (1 + size) if cfg.mrope else 0)
    assert all(torch.equal(p, positions) for p in rotated)


# each family's blocks: the encoder-decoder's encoder and decoder
# attention (the cross-attention on a memory of other length than the
# queries') and SwiGLUs, the hybrid's mixer and shared block, the SSM's
# mixer
FAMILY_BLOCKS = {
    "seamless-m4t-medium": ("enc_attention", "enc_mlp", "self_attention",
                            "cross_attention", "mlp"),
    "zamba2-7b": ("mamba", "shared_attention", "shared_mlp"),
    "mamba2-130m": ("mamba",),
}
FRAMES = 96  # the cross-attention's memory length (sq = S = 128)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("arch", list(FAMILY_BLOCKS))
def test_family_blocks_sum_to_the_whole_block(arch, size, monkeypatch):
    """The encoder-decoder's, the hybrid's and the SSM's blocks on P
    ranks: each summed over the ranks within 1e-6 of the whole (the
    memory's gradient too); each rank's attention on H/P q heads over
    KV/P kv heads, its SSD on nheads/P heads; the mixer's ranks in three
    passes (the norm's statistic replayed, forward then backward), the
    other blocks in one.  The mixer runs in fp64 (the port's CPU oracle
    type): in fp32 the gradients of ``dt_bias`` and ``a_log``, sums over
    every token of the scan's decay derivatives, part from the whole
    block's by 1.2e-6 to 3.7e-6 of max|whole| on this CPU (two fp32
    evaluations in other orders, such as a rank's head subset), and by
    5.4e-15 in fp64."""
    model = _model(arch)
    cfg = model.cfg
    if "mamba" in FAMILY_BLOCKS[arch]:
        wide = build_model(cfg, seed=0, device="cpu").to(torch.float64)
    rng = np.random.default_rng(2)
    h = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)))
    mem = torch.from_numpy(rng.standard_normal((B, FRAMES, cfg.d_model)))
    heads, ssd_heads = [], []
    plain_attn, plain_ssd = L.blockwise_attention, L.ops.ssd_scan

    def attention(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return plain_attn(q, k, v, **kw)

    def ssd_scan(x, dt, a, b, c, **kw):
        ssd_heads.append(x.shape[0] // b.shape[0])
        return plain_ssd(x, dt, a, b, c, **kw)

    monkeypatch.setattr(L, "blockwise_attention", attention)
    monkeypatch.setattr(L.ops, "ssd_scan", ssd_scan)
    nheads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    for block in FAMILY_BLOCKS[arch]:
        heads.clear()
        ssd_heads.clear()
        dy = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)))
        mixer = block == "mamba"
        t = torch.float64 if mixer else torch.float32
        got = tp_local.check_block(
            wide if mixer else model, 1, block, h.to(t), dy.to(t), size,
            memory=mem.float() if block == "cross_attention" else None)
        errs = [got["out"], got["dx"], *got["grads"].values()]
        if block == "cross_attention":
            errs.append(got["dmem"])
        assert max(errs) <= TOL, (block, got)
        assert got["passes"] == (3 if mixer else 1), (block, got)
        if mixer:
            assert ssd_heads == [nheads] + [nheads // size] * size * 3
            assert set(got["grads"]) >= {"w_bc", "conv_bc", "norm", "ln"}
        elif "attention" in block:
            assert heads == [(cfg.num_heads, cfg.num_kv_heads)] + [
                (cfg.num_heads // size, cfg.num_kv_heads // size)] * size


MOE = "deepseek-moe-16b"
MOE_EXPERTS = smoke_shrink(get_config(MOE)).num_experts
MOE_SIZES = [s for s in (2, 4) if MOE_EXPERTS % s == 0]
SKEW = 1.0  # added to every input: the routing leans and drops slots


def _moe_input(cfg, seed):
    """An MoE layer's input (B, S, D) and upstream gradient, the input
    offset by ``SKEW`` so that its tokens lean to the same experts."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, cfg.d_model)) + SKEW
    dy = rng.standard_normal((B, S, cfg.d_model))
    return torch.from_numpy(h).float(), torch.from_numpy(dy).float()


@pytest.mark.parametrize("size", MOE_SIZES)
def test_moe_block_sums_to_the_whole_block(size, monkeypatch):
    """The MoE layer's MLP on P ranks, each on its E/P routed experts and
    F/P shared columns (no group): the summed outputs, input gradients
    and every weight's gradient within 1e-6 of max|whole|, in one pass;
    each rank's expert products on E/P experts; slots dropped for
    capacity (the same ones on every rank: the routing is whole)."""
    model = _model(MOE)
    cfg = model.cfg
    layer = cfg.first_k_dense
    p = model.layers[layer].tensors()
    assert tp_local.holds("moe", p) and not tp_local.holds("mlp", p)
    h, dy = _moe_input(cfg, 3)
    experts, drops = [], []
    plain_ffn, plain_route = L.expert_ffn, L.moe_route

    def expert_ffn(x, w_gate, w_up, w_down):
        experts.append(x.shape[0])
        return plain_ffn(x, w_gate, w_up, w_down)

    def moe_route(*a, **k):
        out = plain_route(*a, **k)
        drops.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(L, "expert_ffn", expert_ffn)
    monkeypatch.setattr(L, "moe_route", moe_route)
    got = tp_local.check_block(model, layer, "moe", h, dy, size)
    assert max(got["out"], got["dx"], *got["grads"].values()) <= TOL, got
    assert set(got["grads"]) == set(tp_local.BLOCKS["moe"][1]), got
    assert got["passes"] == 1
    assert experts == [cfg.num_experts] + [cfg.num_experts // size] * size
    assert drops[0] > 0 and drops == [drops[0]] * (1 + size), drops


class _Barrier(sharding.TensorParallel):
    """A rank of ``size`` threads whose all-reduces meet at a barrier."""

    def __init__(self, rank, size, shared):
        super().__init__(rank, size, group=shared)

    def all_reduce(self, x, op="sum"):
        slots, barrier = self.group
        slots[self.rank] = x.clone()
        barrier.wait()
        parts = torch.stack(slots)
        x.copy_(parts.amax(0) if op == "max" else parts.sum(0))
        barrier.wait()


@pytest.mark.parametrize("size", [2, 4])
def test_vocab_parallel_loss_matches_whole(size):
    rng = np.random.default_rng(1)
    D, V, chunk = 32, 64, 32
    h = torch.from_numpy(rng.standard_normal((B, 96, D))).float()
    w = torch.from_numpy(rng.standard_normal((D, V)) * 0.3).float()
    labels = torch.from_numpy(rng.integers(0, V, (B, 96)))
    hw, ww = h.clone().requires_grad_(), w.clone().requires_grad_()
    want = chunked_cross_entropy(hw, ww, labels, chunk)
    want.backward()

    shared = ([None] * size, threading.Barrier(size))
    got, dh, dw, errors = [None] * size, [None] * size, [None] * size, []

    def rank(r):
        try:
            hr = h.clone().requires_grad_()
            n = V // size
            wr = w[:, r * n:(r + 1) * n].clone().requires_grad_()
            loss = chunked_cross_entropy(hr, wr, labels, chunk,
                                         tp=_Barrier(r, size, shared))
            loss.backward()
            got[r], dh[r], dw[r] = float(loss.detach()), hr.grad, wr.grad
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            shared[1].abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    # every rank has the whole loss; the hidden states' gradient is whole
    # on each rank (the head's entry all-reduces it); each rank holds its
    # rows' head gradient
    for r in range(size):
        assert got[r] == pytest.approx(float(want.detach()), rel=TOL)
        np.testing.assert_allclose(dh[r], hw.grad, rtol=0,
                                   atol=TOL * float(hw.grad.abs().max()))
    np.testing.assert_allclose(torch.cat(dw, 1), ww.grad, rtol=0,
                               atol=TOL * float(ww.grad.abs().max()))


@pytest.mark.parametrize("size", MOE_SIZES)
def test_moe_aux_loss_reaches_the_router_once(size):
    """The MoE layer's MLP on P threads whose all-reduces meet at a
    barrier, the objective its output against an upstream gradient plus
    the aux loss: on every rank the output, the aux loss and the
    gradients of the input, the router and the pre-norm are the whole
    layer's (the aux loss's share of them counted once: the routing runs
    outside the split region), and the ranks' expert and shared-column
    gradients side by side are the whole's, within 1e-6 of max|whole|."""
    model = _model(MOE)
    cfg = model.cfg
    layer = cfg.first_k_dense
    p = {k: v for k, v in model.layers[layer].tensors().items()
         if k in tp_local.BLOCKS["moe"][1]}
    defs = param_defs(cfg)["layers"][layer]
    h, dy = _moe_input(cfg, 4)

    def run(weights, tp=None):
        w = {k: v.detach().clone().requires_grad_() for k, v in
             weights.items()}
        x = h.clone().requires_grad_()
        y, aux = model._mlp_out(w, x, True, tp=tp)
        ((y * dy).sum() + aux).backward()
        return (y.detach(), float(aux.detach()), x.grad,
                {k: v.grad for k, v in w.items()})

    want = run(p)
    shared = ([None] * size, threading.Barrier(size))
    got, errors = [None] * size, []

    def rank(r):
        try:
            got[r] = run(tp_local.local_params(defs, p, r, size),
                         _Barrier(r, size, shared))
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            shared[1].abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=TOL * float(b.abs().max()))

    y, aux, dx, grads = want
    for r in range(size):
        assert got[r][1] == pytest.approx(aux, rel=TOL)
        close(got[r][0], y)
        close(got[r][2], dx)
        for name in ("router", "ln_mlp"):
            close(got[r][3][name], grads[name])
    for name, dims in (("e_gate", 0), ("e_up", 0), ("e_down", 0),
                       ("s_gate", 1), ("s_up", 1), ("s_down", 0)):
        assert got[0][3][name].shape[dims] * size == grads[name].shape[dims]
        close(torch.cat([g[3][name] for g in got], dims), grads[name])


def test_smoke_tp_local_replays_the_kv_head_a_rank_reads(monkeypatch):
    """``chip_smoke.phase_tp_local`` on qwen2-vl-72b at its GQA group of 8
    (16 q heads on 2 kv heads, narrowed; 64 tokens), its M-RoPE
    positions given, on the CPU: at every P of ``TP_SIZES`` the ranks'
    sums within ``TP_TOL`` of the whole blocks, each rank on H/P q heads
    and one kv head (its own at P = 2, else the one its q heads read),
    and the checks that replay the whole block's q, k and v into each
    rank (fp32 and, for this model, bf16) giving rank r of P = 16 kv
    head r // 8, the one its q head reads (its own inputs read 0 from
    them here, where the plain attention takes the same sums)."""
    import dataclasses
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd

    cfg = dataclasses.replace(get_config("qwen2-vl-72b"), d_model=64,
                              num_heads=16, num_kv_heads=2, head_dim=16,
                              d_ff=128, vocab_size=512)
    monkeypatch.setattr(cs, "TP_LOCAL", {cfg.name: {
        **cs.TP_LOCAL[cfg.name], "seq": 64}})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    attention = []  # K4's launches are the card's: the blocks checked
    monkeypatch.setattr(cs, "_check_tp_attention",
                        lambda *a, **k: attention.append(a[1:4]))

    def counts():
        return {**fa.LAUNCHES, **ssd.LAUNCHES,
                **{k: {"wgmma": 0, "mma": 0, "simt": 0} for k in (
                    "flash_fwd_routes", "flash_bwd_routes", "flash_noncausal",
                    "flash_bwd_noncausal", "flash_window_routes",
                    "flash_bwd_window_routes", "ssd_routes",
                    "ssd_bwd_routes")}}

    out = cs.phase_tp_local(
        torch, lambda c, seed, device: build_model(c, seed=seed,
                                                   device=device),
        lambda arch: cfg, counts, lambda: None, L, device="cpu")
    for size in cs.TP_SIZES:
        for name in ("fp32", "bf16"):
            rec = out["checks"][f"{cfg.name}:{name}:P{size}"]
            assert max(rec["errors"].values()) <= cs.TP_TOL[name], rec
            assert rec["heads_per_rank"] == [16 // size, 1], rec
            assert rec["errors"]["attention_inputs"] == 0.0, rec
    # each P and type: the attention checked twice, on the ranks' own
    # inputs, then with the whole's replayed
    assert sorted(attention) == sorted(
        [(t, s, "attention") for s in cs.TP_SIZES for t in
         ("fp32", "fp32", "bf16", "bf16")])
