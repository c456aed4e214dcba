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

The vocabulary-parallel loss (``losses.chunked_cross_entropy`` with
``tp``) runs its P ranks as threads whose all-reduces meet at a barrier:
the loss and the gradients of the hidden states and of the head against
the whole loss's, at 1e-6.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
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
@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-7b"])
def test_local_blocks_sum_to_the_whole_block(arch, size, monkeypatch):
    model = _model(arch)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))).float()
    heads = []
    plain = L.blockwise_attention

    def recorded(q, k, v, **kw):
        heads.append((q.shape[2], k.shape[2]))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(L, "blockwise_attention", recorded)
    for block in ("attention", "mlp"):
        dy = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))).float()
        got = tp_local.check_block(model, 0, block, h, dy, size)
        assert got["out"] <= TOL and got["dx"] <= TOL, (block, got)
        assert max(got["grads"].values()) <= TOL, (block, got)
    # the whole block, then each rank on H/P q heads, over the kv heads
    # its q heads read: KV/P of them where KV divides P, else one
    kv = (cfg.num_kv_heads // size if cfg.num_kv_heads % size == 0 else 1)
    assert heads == [(cfg.num_heads, cfg.num_kv_heads)] + [
        (cfg.num_heads // size, kv)] * size


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
