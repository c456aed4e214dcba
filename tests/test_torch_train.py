"""The port's training path (data, optimizer, gradient compression,
losses and gradients, the train step, the launcher and its checkpoints)
held against the JAX package on the same inputs.

Inputs and weights come from numpy or from the reference's ``init_params``
(carried across with ``lm_params_from_numpy``), cast to fp32 where the
point is the algorithm, as ``tests/test_torch_lm.py`` does.  Tolerances:
optimizer state and schedule 1e-6; the loss rtol 1e-5 and each gradient
1e-4 of the tensor's max|grad| (the SSM's chunked path also allows the
distance between the reference and the port's exact sequential scan, the
fp32 noise of two evaluations of the same function, capped at 5e-4 of
max|grad|, and holds the chunked path to that sequential scan at 1e-4
alone; the hybrid's fp32 gradients are held to the reference's fp64
ones, no further than the reference's own fp32 gradients are, and its
fp64 gradients to the reference's at 1e-9, see HYBRID_FLOOR_CAP); three
train steps'
losses rtol 1e-4 (parameters are not compared after an Adam step: at step
1 the update is about lr·sign(g), so a near-zero gradient whose sign
differs moves a weight by 2·lr).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_shrink as ref_smoke_shrink  # noqa: E402
from repro.data.pipeline import SyntheticTextDataset as RefDataset  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.parallel.sharding import init_params as ref_init_params  # noqa: E402
from repro.train import grad_compress as ref_gc  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.data.pipeline import SyntheticTextDataset  # noqa: E402
from repro_torch.interop import _unstack, lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.launch.train import StragglerWatchdog, train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.losses import chunked_cross_entropy  # noqa: E402
from repro_torch.train import grad_compress as gc  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
)

from test_torch_encdec import looped_encode, x64_reference  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_TOL = 1e-4
# the most that the port's sequential scan may differ from the reference's
# chunked SSD gradients, per tensor, in units of max|grad| (3.9e-4 measured)
FLOOR_CAP = 5e-4
# the hybrid's shrink: the reference's own fp32 gradients against its
# fp64 ones (its fp32 casts widened), the largest over tensors in units of
# each tensor's max|grad|, is the floor that the port's fp32 gradients are
# held to against the reference's fp64 ones.  1.3e-3 measured (the port's
# fp32: 5.7e-4; the port against the reference in fp32: 8.1e-4); capped
# here.  In fp64 the port and the reference read 1.0e-12 apart: FP64_TOL
HYBRID_FLOOR_CAP = 2e-3
FP64_TOL = 1e-9
# the encoder-decoder's shrink in fp32 is bf16 where its input is (the
# first encoder layer normalises the bf16 embeds into bf16 and casts its
# attention output to bf16) and its attention is hard, so two fp32
# evaluations part by whole bf16 steps: the reference's own fp32
# gradients sit up to 7.4e-2 of a tensor's max|grad| from its fp64 ones
# (the port's fp32 3.5e-2 from the reference's fp32).  Each port fp32
# gradient is held to the reference's fp32 no further than that floor,
# capped here; the fp64 gradients within FP64_TOL
ENCDEC_FLOOR_CAP = 1e-1


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,step,host", [
    (0, 0, None), (3, 7, None), (5, 11, slice(2, 6)), (1, 0, slice(0, 3)),
])
def test_batches_bitwise_reference(seed, step, host):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=seed)
    ours = SyntheticTextDataset(**kw).batch(step, host_slice=host)
    theirs = RefDataset(**kw).batch(step, host_slice=host)
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_data_resumable():
    ds = SyntheticTextDataset(vocab_size=100, seq_len=8, global_batch=4, seed=3)
    ds2, step = SyntheticTextDataset.from_state(
        ds.state_dict(7), vocab_size=100, seq_len=8, global_batch=4)
    np.testing.assert_array_equal(ds.batch(7)["tokens"], ds2.batch(step)["tokens"])
    assert not np.array_equal(ds.batch(8)["tokens"], ds.batch(7)["tokens"])


# ------------------------------------------------------------- optimizer
def test_schedule_matches_reference():
    cfg = opt.OptimizerConfig(learning_rate=3e-3, warmup_steps=17,
                              total_steps=80, min_lr_ratio=0.1)
    rcfg = ref_opt.OptimizerConfig(learning_rate=3e-3, warmup_steps=17,
                                   total_steps=80, min_lr_ratio=0.1)
    for step in (0, 1, 5, 17, 18, 40, 79, 80, 120):
        got = float(opt.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(ref_opt.schedule(rcfg, jnp.int32(step)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-3), step
    assert float(opt.schedule(cfg, 0)) == 0.0


def _flat_tree(rng):
    return {"w": rng.normal(size=(4, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32),
            "s": {"k": rng.normal(size=(3, 5, 2)).astype(np.float32)}}


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_update_matches_reference(moments):
    """Two updates from the same params and grads: params, moments and
    metrics within 1e-6 of the reference's."""
    rng = np.random.default_rng(0)
    p_np = _flat_tree(rng)
    grads_np = [jax.tree.map(lambda a: 3.0 * a, _flat_tree(rng)) for _ in range(2)]
    kw = dict(learning_rate=0.05, warmup_steps=1, total_steps=10,
              moment_dtype=moments)
    cfg, rcfg = opt.OptimizerConfig(**kw), ref_opt.OptimizerConfig(**kw)
    params = jax.tree.map(_t, p_np)
    state = opt.init(cfg, params)
    rparams = jax.tree.map(jnp.asarray, p_np)
    rstate = ref_opt.init(rcfg, rparams)
    for g in grads_np:
        params, state, met = opt.update(cfg, jax.tree.map(_t, g), state, params)
        rparams, rstate, rmet = ref_opt.update(
            rcfg, jax.tree.map(jnp.asarray, g), rstate, rparams)
        for k in ("grad_norm", "lr"):
            assert abs(float(met[k]) - float(rmet[k])) <= 1e-6 * float(rmet[k])
        for got, want in zip(tree.leaves(params), jax.tree.leaves(rparams)):
            np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                       atol=1e-6)
        assert int(state["count"]) == int(rstate["count"])
        for key in ("m", "v"):
            ours = tree.leaves(state[key], opt.is_moment)
            theirs = jax.tree.leaves(
                rstate[key], is_leaf=lambda x: isinstance(x, tuple))
            for got, want in zip(ours, theirs):
                if moments == "int8":
                    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
                    assert abs(float(got[1]) - float(want[1])) <= 1e-6 * float(want[1])
                else:
                    np.testing.assert_allclose(_np(got), np.asarray(want),
                                               rtol=1e-6, atol=1e-6)


def test_update_keeps_dtype_and_decays_matrices_only():
    cfg = opt.OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                              weight_decay=0.5)
    params = {"w": torch.ones(2, 3, dtype=torch.bfloat16),
              "n": torch.ones(3, dtype=torch.bfloat16)}
    state = opt.init(cfg, params)
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    params, state, _ = opt.update(cfg, zero, state, params)
    assert params["w"].dtype == torch.bfloat16
    assert float(params["w"][0, 0]) < 1.0  # decayed
    assert float(params["n"][0]) == 1.0    # 1-D: not decayed


@pytest.mark.parametrize("moments,bar", [("float32", 0.05), ("int8", 0.2)])
def test_adamw_converges_quadratic(moments, bar):
    """The reference's two quadratic tests, at its bars."""
    cfg = opt.OptimizerConfig(learning_rate=0.1, warmup_steps=0,
                              total_steps=200, weight_decay=0.0,
                              moment_dtype=moments)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(cfg, params)
    for _ in range(150):
        params, state, _ = opt.update(cfg, {"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < bar


# ------------------------------------------------------ grad compression
def test_quantize_and_feedback_match_reference():
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(64,)).astype(np.float32) * 1e-3,
         "b": [rng.normal(size=(3, 4)).astype(np.float32)]}
    r = jax.tree.map(lambda x: (0.1 * x).astype(np.float32), g)
    q, s = gc.quantize(_t(g["a"]))
    rq, rs = ref_gc.quantize(jnp.asarray(g["a"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert abs(float(s) - float(rs)) <= 1e-7 * float(rs)
    assert float((gc.dequantize(q, s) - _t(g["a"])).abs().max()) <= float(s) * 0.5 + 1e-6
    qs, ss, rs2 = gc.compress_with_feedback(jax.tree.map(_t, g), jax.tree.map(_t, r))
    rqs, rss, rrs = ref_gc.compress_with_feedback(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    for got, want in zip(tree.leaves(qs), jax.tree.leaves(rqs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tree.leaves(rs2), jax.tree.leaves(rrs)):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(1)
    g_true = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)) * 1e-3
    grads = {"w": g_true}
    res = gc.init_residuals(grads)
    acc = torch.zeros_like(g_true)
    for _ in range(50):
        q, s, res = gc.compress_with_feedback(grads, res)
        acc = acc + gc.dequantize(q["w"], s["w"])
    total = 50 * g_true
    assert float(torch.linalg.norm(acc - total) / torch.linalg.norm(total)) < 0.05


WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
from repro_torch.train import grad_compress as gc
rng = np.random.default_rng(10 + rank)
g = {"a": torch.from_numpy(rng.normal(size=(33,)).astype(np.float32)),
     "b": [torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32) * 1e-2)]}
res = {"a": torch.full((33,), 1e-3), "b": [torch.zeros(4, 5)]}
summed, res2 = gc.compressed_all_reduce(g, res)
print("OUT" + json.dumps({"rank": rank,
      "summed": [summed["a"].tolist(), summed["b"][0].flatten().tolist()],
      "res": [res2["a"].tolist(), res2["b"][0].flatten().tolist()]}))
dist.destroy_process_group()
"""


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def test_compressed_all_reduce_two_gloo_processes():
    """2 plain subprocesses on ``gloo``: both ranks return the same sum,
    the numpy sum of each rank's dequantized bf16 contribution (within
    one bf16 rounding of the sum), and their own residuals."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = {}
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        rec = json.loads(next(l for l in out.splitlines()
                              if l.startswith("OUT"))[3:])
        recs[rec["rank"]] = rec
    assert recs[0]["summed"] == recs[1]["summed"]
    want = [np.zeros(33), np.zeros(20)]
    for rank in (0, 1):
        rng = np.random.default_rng(10 + rank)
        a = rng.normal(size=(33,)).astype(np.float32) + np.float32(1e-3)
        b = (rng.normal(size=(4, 5)).astype(np.float32) * 1e-2).reshape(-1)
        for i, x in enumerate((a, b)):
            scale = max(np.abs(x).max(), 1e-12) / np.float32(127.0)
            q = np.clip(np.round(x / scale), -127, 127)
            deq = (q * scale).astype(np.float32)
            want[i] = want[i] + _bf16(deq)
            np.testing.assert_allclose(recs[rank]["res"][i], x - deq,
                                       rtol=1e-5, atol=1e-7)
    for got, w in zip(recs[0]["summed"], want):
        np.testing.assert_allclose(got, _bf16(w), rtol=2 ** -8, atol=1e-9)


# --------------------------------------------------- losses and gradients
def _ref_setup(arch, dtype=jnp.float32, key=0):
    ref_cfg = ref_smoke_shrink(ref_get_config(arch))
    ref_model = ref_build_model(ref_cfg)
    params = ref_init_params(ref_model.param_defs(), jax.random.PRNGKey(key))
    params = jax.tree.map(lambda a: a.astype(dtype), params)
    if ref_cfg.is_encdec and dtype != jnp.bfloat16:
        # its encoder's scan refuses wider weights than the bf16 embeds
        ref_model.encode = looped_encode(ref_model)
    cfg = smoke_shrink(get_config(arch))
    return ref_model, params, cfg


def _batch(cfg, B, S, seed):
    """Tokens and labels (B, S) drawn from ``seed``; for an
    encoder-decoder also frame embeddings (B, S, d_model)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return out


def _port_grads(cfg, params_np, batch):
    model = build_model(cfg, lm_params_from_numpy(cfg, params_np),
                        device="cpu").train_mode(True)
    loss, metrics = model.loss(batch)
    loss.backward()
    return loss.detach(), metrics, model.param_tree()


def _pairs(cfg, params_t, ref_grads):
    """(path, port grad, reference grad) for every parameter: the
    reference's gradients carried into the port's layout as its weights
    are (``interop._unstack``: stacked layers cut per layer, the
    hybrid's shared block nested)."""
    want = dict(tree.flatten(_unstack(
        cfg, ref_grads, lambda x, i: np.asarray(x if i is None else x[i]))))
    for path, p in tree.flatten(params_t):
        yield path, p.grad, want[path]


@pytest.mark.parametrize("arch,S", [
    ("qwen3-4b", 128),     # the flash kernel's path (FlashAttentionFn)
    ("llama3.2-3b", 32),   # ragged: the naive reference under autograd
    ("mamba2-130m", 128),  # the chunked SSD (SSDIntraChunkFn)
    ("mamba2-130m", 40),   # ragged: the sequential scan
    # the hybrid's shrink (4 layers, the shared block after every 2,
    # window 64): both kernels' paths, the window binding at S 128
    ("zamba2-7b", 128),
    # the encoder-decoder's shrink: tests/test_torch_train_encdec.py
])
def test_loss_and_grads_match_reference(arch, S):
    check_loss_and_grads(arch, S)


def check_loss_and_grads(arch, S):
    """The loss and every gradient of ``arch``'s smoke shrink on a batch
    of 2 x ``S`` against ``jax.value_and_grad`` of the reference, no
    kernel launched (the CPU's plain versions)."""
    ref_model, params, cfg = _ref_setup(arch)
    batch = _batch(cfg, 2, S, seed=S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_met), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, jb), has_aux=True))(params)
    params_np = jax.tree.map(np.asarray, params)
    fa.reset_launches()
    ssd.reset_launches()
    loss, metrics, params_t = _port_grads(cfg, params_np, batch)
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
    assert ssd.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    assert float(metrics["xent"].detach()) == pytest.approx(
        float(ref_met["xent"]), rel=1e-5)
    assert float(metrics["aux"]) == float(ref_met["aux"]) == 0.0
    floor = {}
    if cfg.family == "ssm" and S % L.SSD_CHUNK == 0:
        # the fp32 noise of two evaluations of the same function: the
        # port's exact sequential scan (plain PyTorch, no chunks, no
        # kernel) against the reference, per tensor
        chunk = L.SSD_CHUNK
        try:
            L.SSD_CHUNK = S + 1  # every length ragged: the sequential scan
            _, _, seq_tree = _port_grads(cfg, params_np, batch)
        finally:
            L.SSD_CHUNK = chunk
        floor = {name: float(np.abs(_np(g) - r).max())
                 for name, g, r in _pairs(cfg, seq_tree, ref_grads)}
        # the floor is capped, and the chunked path is held to the
        # sequential scan at 1e-4 on its own, so the floor
        # cannot hide a fault of the chunked path
        seq = {name: _np(g) for name, g, _ in _pairs(cfg, seq_tree, ref_grads)}
        for name, got, want in _pairs(cfg, params_t, ref_grads):
            scale = float(np.abs(want).max())
            assert floor[name] <= FLOOR_CAP * scale, (name, floor[name], scale)
            err = float(np.abs(_np(got) - seq[name]).max())
            assert err <= GRAD_TOL * float(np.abs(seq[name]).max()), (name, err)
    if cfg.family == "hybrid":
        _hybrid_grads_match_reference(ref_model, params, cfg, batch,
                                      params_t, ref_grads)
        return
    if cfg.is_encdec:
        _encdec_grads_match_reference(ref_model, params, cfg, batch,
                                      params_t, ref_grads)
        return
    n = 0
    for name, got, want in _pairs(cfg, params_t, ref_grads):
        assert got is not None and got.shape == want.shape, name
        err = float(np.abs(_np(got) - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()) + floor.get(name, 0.0), (
            name, err, float(np.abs(want).max()), floor.get(name))
        n += 1
    assert n == len(tree.leaves(params_t))


def _grads64(ref_model, params, cfg, batch):
    """The reference's gradients in fp64 (its models' fp32 casts widened
    to fp64, ``jax.enable_x64``) and the port's from fp64 weights (it
    runs fp64 on the CPU), each as numpy fp64."""
    from repro.models import hybrid as ref_hybrid
    from repro.models import lm as ref_lm

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with x64_reference(ref_hybrid, ref_lm):
        ref64 = jax.jit(jax.grad(lambda p: ref_model.loss(p, jb)[0]))(
            jax.tree.map(lambda a: a.astype(jnp.float64), params))
        assert {a.dtype for a in jax.tree.leaves(ref64)} == {np.dtype(np.float64)}
        ref64 = jax.tree.map(lambda a: np.asarray(a, np.float64), ref64)
    _, _, port64 = _port_grads(
        cfg, jax.tree.map(lambda a: np.asarray(a, np.float64), params), batch)
    return ref64, port64


def _unit(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _hybrid_grads_match_reference(ref_model, params, cfg, batch, params_t,
                                  ref32):
    """The hybrid shrink's gradients against the reference's in fp64
    (:func:`_grads64`): the port's fp64 gradients within FP64_TOL, and
    its fp32 ones (``params_t``) no further than the reference's own fp32
    gradients (``ref32``) are, on their worst tensor."""
    ref64, port64 = _grads64(ref_model, params, cfg, batch)
    want = {name: w for name, _, w in _pairs(cfg, params_t, ref64)}
    floor = max(_unit(r, want[name])
                for name, _, r in _pairs(cfg, params_t, ref32))
    assert floor <= HYBRID_FLOOR_CAP, floor
    n, worst64, worst32 = 0, 0.0, 0.0
    for (name, got, w), (_, got64, _) in zip(_pairs(cfg, params_t, ref64),
                                             _pairs(cfg, port64, ref64)):
        assert got is not None and got.shape == w.shape, name
        assert got64.dtype == torch.float64, name
        worst64 = max(worst64, _unit(got64.numpy(), w))
        worst32 = max(worst32, _unit(_np(got), w))
        assert _unit(got64.numpy(), w) <= FP64_TOL, (name, _unit(got64.numpy(), w))
        assert _unit(_np(got), w) <= floor, (name, _unit(_np(got), w), floor)
        n += 1
    assert n == len(tree.leaves(params_t))
    print(f"hybrid grads against the reference's fp64: port fp64 {worst64:.2e}, "
          f"port fp32 {worst32:.2e}, reference fp32 {floor:.2e}")


def _encdec_grads_match_reference(ref_model, params, cfg, batch, params_t,
                                  ref32):
    """The encoder-decoder shrink's gradients: the port's fp64 ones
    within FP64_TOL of the reference's fp64 ones (:func:`_grads64`), and
    its fp32 ones (``params_t``) no further from the reference's fp32
    ones (``ref32``) than those are from fp64, on their worst tensor
    (ENCDEC_FLOOR_CAP)."""
    ref64, port64 = _grads64(ref_model, params, cfg, batch)
    want = {name: w for name, _, w in _pairs(cfg, params_t, ref64)}
    floor = max(_unit(r, want[name])
                for name, _, r in _pairs(cfg, params_t, ref32))
    assert floor <= ENCDEC_FLOOR_CAP, floor
    n, worst64, worst32 = 0, 0.0, 0.0
    for (name, got, r), (_, got64, w) in zip(_pairs(cfg, params_t, ref32),
                                             _pairs(cfg, port64, ref64)):
        assert got is not None and got.shape == r.shape, name
        assert got64.dtype == torch.float64, name
        worst64 = max(worst64, _unit(got64.numpy(), w))
        worst32 = max(worst32, _unit(_np(got), r))
        assert _unit(got64.numpy(), w) <= FP64_TOL, (name, _unit(got64.numpy(), w))
        assert _unit(_np(got), r) <= floor, (name, _unit(_np(got), r), floor)
        n += 1
    assert n == len(tree.leaves(params_t))
    print(f"encdec grads: port fp64 against the reference's fp64 "
          f"{worst64:.2e}; port fp32 against the reference's fp32 "
          f"{worst32:.2e}, the reference's fp32 against its fp64 {floor:.2e}")


def test_chunked_cross_entropy_matches_reference():
    from repro.models.losses import chunked_cross_entropy as ref_xent

    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 96, 16)).astype(np.float32)
    w = rng.normal(size=(16, 50)).astype(np.float32)
    lab = rng.integers(0, 50, size=(2, 96)).astype(np.int32)
    want = ref_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab), chunk=32)
    ht, wt = _t(h).requires_grad_(), _t(w).requires_grad_()
    got = chunked_cross_entropy(ht, wt, torch.from_numpy(lab), chunk=32)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    gh, gw = jax.grad(lambda a, b: ref_xent(a, b, jnp.asarray(lab), chunk=32),
                      argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    got.backward()
    np.testing.assert_allclose(_np(ht.grad), np.asarray(gh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(wt.grad), np.asarray(gw), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        chunked_cross_entropy(ht, wt, torch.from_numpy(lab), chunk=40)


# ------------------------------------------------------ steps and launcher
def test_prefill_and_decode_steps_call_the_model():
    cfg = smoke_shrink(get_config("qwen3-4b"))
    model = build_model(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    cache, logits = make_prefill_step(model)({"tokens": tokens}, 18)
    _, want = model.prefill(torch.from_numpy(tokens).long(), 18)
    assert torch.equal(logits, want)
    nxt = logits.argmax(-1)[:, None]
    got, _ = make_decode_step(model)(cache, nxt, 16)
    assert got.shape == (2, cfg.vocab_size) and torch.isfinite(got).all()


def test_train_lowers_the_loss(monkeypatch):
    """The reference's ``test_loss_decreases_small_lm`` through the port's
    launcher, from the reference's seed-0 initial weights: the port draws
    other numbers from a seed, runs from different draws part far under
    Adam at lr 5e-3, and its own draws drop the loss by about 0.1 in 80
    steps, some below."""
    from repro_torch.launch import train as launcher

    ref_model, params, cfg = _ref_setup("llama3.2-3b", dtype=jnp.bfloat16)
    weights = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params))
    monkeypatch.setattr(launcher, "build_model",
                        lambda c, seed, device: build_model(c, weights,
                                                            device=device))
    losses = train("llama3.2-3b", steps=80, smoke=True, global_batch=4,
                   seq_len=32, lr=5e-3, device="cpu")
    assert len(losses) == 80 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])


def test_train_refuses_a_mesh_and_defaults_to_the_card():
    """A mesh of 2 needs a run of 2 processes (tests/test_torch_train_mesh.py
    trains on them); a mesh of one runs the sharded step on a one-rank
    group it starts and leaves; the default device is the card."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="run of 1"):
        train("llama3.2-3b", steps=1, mesh_shape=(2, 1), device="cpu")
    assert not dist.is_initialized()
    train("llama3.2-3b", steps=1, global_batch=2, seq_len=16,
          mesh_shape=(1, 1), device="cpu")
    assert not dist.is_initialized()
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train("llama3.2-3b", steps=1)


def test_straggler_watchdog_flags_slow_steps():
    dog = StragglerWatchdog(threshold=3.0, decay=0.5)
    assert not any(dog.observe(i, 1.0) for i in range(5))
    assert dog.observe(5, 10.0) and dog.flagged == [5]


def test_llama3_2_3b_config_matches_reference():
    ours, theirs = get_config("llama3.2-3b"), ref_get_config("llama3.2-3b")
    assert dataclasses.asdict(ours) == {
        f.name: getattr(theirs, f.name) for f in dataclasses.fields(ours)}


