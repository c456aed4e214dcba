"""The port's encoder-decoder (``models/encdec.py``, seamless-m4t-medium)
held against the JAX package on the CPU.

Both sides run the reference's smoke shrink (d 64, 4 heads on 4 kv heads
of 16, 2 encoder and 2 decoder layers, V 512) on the reference's
``init_params`` weights carried across by ``lm_params_from_numpy``, with
frame embeddings and tokens drawn with numpy from fixed seeds: 512
frames (a multiple of the reference's key block of 512, see the padded
keys below) and 128 or 512 tokens, so the cross-attention's queries and
keys differ in length.

The reference's encoder scans its layers with a carry that starts as the
bf16 embeds; with fp32 (or fp64) weights the first layer's output turns
fp32 and ``lax.scan`` refuses it, so for those weights the test runs the
reference's own blocks (``_self_attn``, ``_mlp``) in a Python loop
(:func:`looped_encode`).  Tolerances, each with its reason:

- fp64 (the reference's ``F32`` widened to fp64 under
  ``jax.enable_x64``; the port runs fp64 on the CPU from fp64 weights):
  memory, hidden states and gradients within 1e-9 of max|value|; the
  logits within 1e-6 (the port returns them as fp32, as the reference's
  ``astype(F32)`` does at its width); the caches, which both sides round
  to bf16 (the reference stores them so), bitwise.
- fp32: the model is still bf16 where its input is: the first encoder
  layer normalises the bf16 embeds into bf16 and casts its attention
  output to bf16, and with the reference's init (the head count as wq's
  and wk's fan-in) the attention is hard.  Two fp32 evaluations of the
  same function then part by whole bf16 steps wherever a value sits near
  a rounding boundary, and the hard attention carries such a step on:
  the reference's own fp32 final hidden states sit up to 4.0e-2 of
  max|value| from its fp64 ones (its memory 2.5e-3, its logits 1.1e-3).
  So each fp32 output is held to the reference's fp32 no further than
  the reference's fp32 is from its fp64, the largest over the compared
  outputs (capped at FP32_FLOOR_CAP), and the fp64 check above is the
  exact one.  The decode path has no
  bf16 cast (the decoder starts from fp32 token embeddings): fp32 decode
  steps agree within 1e-4 of max|logit|.
- bf16: every block, fed the same input on both sides, within one bf16
  step of max|value| (2^-7; only summation orders and the flash
  kernel's bf16 P differ).  End to end the random weights amplify such
  single steps: each side's bf16 logits sit 41% (128 tokens) and 24%
  (512) of max|logit| from the reference's fp64 ones on this CPU, the
  two sides' 1.6% and 4.5% apart.  So the bf16 logits are held nearer
  the reference's bf16 logits than those are to fp64, and within the JAX
  suite's bf16 attention tolerance, 3e-2 of max|logit|, at 128 tokens.
- the reference's padded keys: its non-causal ``blockwise_attention``
  pads the keys to a multiple of 512 with zeros and masks nothing, so
  each padded key scores 0 and adds to the softmax's denominator.  At
  192 and 640 frames the port's encoder attention is within 1e-5 of a
  dense numpy softmax and the reference's more than 0.1 from it; at 512
  both agree.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_shrink as ref_smoke_shrink  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import encdec as jE  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import losses as jLo  # noqa: E402
from repro.parallel.sharding import count_params as ref_count_params  # noqa: E402
from repro.parallel.sharding import init_params as ref_init_params  # noqa: E402

from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.decode_demo import serve  # noqa: E402
from repro_torch.models import EncDecLM, build_model, param_defs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402

ARCH = "seamless-m4t-medium"
FRAMES = 512
FP64_TOL = 1e-9
LOGIT64_TOL = 1e-6
# the reference's fp32 prefill outputs against its fp64 ones, the largest
# over memory, hidden states, logits and caches: 2.0e-2 (S 128) and
# 4.0e-2 (S 512), both the final hidden states; capped here
FP32_FLOOR_CAP = 5e-2
TOL = 1e-4
ULP16 = 2.0 ** -7
BF16_TOL = 3e-2
ATTN_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _rel(got, want) -> float:
    want = _np(want)
    return float(np.abs(_np(got) - want).max() / max(np.abs(want).max(), 1e-30))


def _exact_casts(fn, *args):
    """``fn`` compiled by XLA with every bf16 cast rounded as written (see
    ``tests/test_torch_lm.py``)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def looped_encode(ref_model):
    """The reference's ``encode`` with its layer scan run as a Python
    loop over its own blocks: the scan refuses fp32 or fp64 weights,
    whose first layer turns the bf16 carry wider."""
    cfg = ref_model.cfg

    def encode(params, embeds):
        B, S, _ = embeds.shape
        h = embeds.astype(jnp.bfloat16)
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
        for i in range(cfg.encoder_layers):
            lp = jax.tree.map(lambda a: a[i], params["enc_layers"])
            h, _ = ref_model._self_attn(lp, h, positions, causal=False)
            h = ref_model._mlp(lp, h)
        return jL.rms_norm(h, params["enc_norm"], cfg.norm_eps)

    return encode


@contextlib.contextmanager
def x64_reference(*modules):
    """The reference's ``F32`` widened to fp64 in its layers, losses and
    encoder-decoder (and ``modules``), under ``jax.enable_x64``."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in (jL, jE, jLo, *modules):
            mp.setattr(mod, "F32", jnp.float64)
        yield


def _ref(dtype="bfloat16"):
    """(reference model, its smoke-shrink params in ``dtype`` as numpy):
    for fp32 and fp64 the model's encoder is :func:`looped_encode`."""
    ref_model = ref_build_model(ref_smoke_shrink(ref_get_config(ARCH)))
    params = ref_init_params(ref_model.param_defs(), jax.random.PRNGKey(0))
    if dtype != "bfloat16":
        ref_model.encode = looped_encode(ref_model)
    np_dtype = {"bfloat16": jnp.bfloat16, "float32": np.float32,
                "float64": np.float64}[dtype]
    return ref_model, jax.tree.map(lambda a: np.asarray(a, np_dtype), params)


def _port(params_np) -> EncDecLM:
    cfg = smoke_shrink(get_config(ARCH))
    return build_model(cfg, lm_params_from_numpy(cfg, params_np), device="cpu")


def _inputs(S, frames=FRAMES, seed=0, B=2):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.normal(size=(B, frames, 64)).astype(np.float32),
            "tokens": rng.integers(0, 512, size=(B, S), dtype=np.int32)}


def _ref_outputs(ref_model, params, inp, max_len, dtype):
    """The reference's memory, hidden states, prefill cache and logits,
    as numpy (fp64 under :func:`x64_reference`)."""
    def run(p, b):
        mem = ref_model.encode(p, b["embeds"])
        h, _ = ref_model.hidden_states(p, b)
        cache, logits = ref_model.prefill(p, b, max_len=max_len)
        return mem, h, cache, logits

    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    if dtype == "float64":
        with x64_reference():
            out = jax.jit(run)(jax.tree.map(jnp.asarray, params), jin)
    elif dtype == "bfloat16":
        out = _exact_casts(run, params, jin)
    else:
        out = jax.jit(run)(params, jin)
    return jax.tree.map(lambda a: np.asarray(a), out)


def _port_outputs(model, inp, max_len):
    with torch.inference_mode():
        mem = model.encode(torch.from_numpy(inp["embeds"]))
    tokens = torch.from_numpy(inp["tokens"]).long()
    with torch.no_grad():
        h, aux = model.hidden_states(inp)
    assert float(aux) == 0.0
    cache, logits = model.prefill(tokens, max_len,
                                  embeds=torch.from_numpy(inp["embeds"]))
    return mem, h, cache, logits


# --------------------------------------------------------------- configs
def test_config_matches_reference():
    ours, theirs = get_config(ARCH), ref_get_config(ARCH)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.is_encdec and theirs.is_encdec
    small, ref_small = smoke_shrink(ours), ref_smoke_shrink(theirs)
    for f in dataclasses.fields(small):
        assert getattr(small, f.name) == getattr(ref_small, f.name), f.name
    assert (small.num_layers, small.encoder_layers, small.d_model,
            small.num_heads, small.resolved_head_dim, small.vocab_size) == (
        2, 2, 64, 4, 16, 512)


@pytest.mark.parametrize("smoke", [True, False])
def test_param_defs_match_reference(smoke):
    """Every reference declaration, its ``enc_layers`` and ``dec_layers``
    rows unstacked, has the port's shape, init rule and scale, in the
    port's ``enc_layers`` and ``layers``; the counts agree (977.8 M
    parameters at the published widths)."""
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    if smoke:
        cfg, ref_cfg = smoke_shrink(cfg), ref_smoke_shrink(ref_cfg)
    defs = param_defs(cfg)
    ref_defs = ref_build_model(ref_cfg).param_defs()
    stacks = {"enc_layers": "enc_layers", "dec_layers": "layers"}
    assert set(defs) == set(ref_defs) - set(stacks) | set(stacks.values())
    for k, d in ref_defs.items():
        if k in stacks:
            rows = defs[stacks[k]]
            n = next(iter(d.values())).shape[0]
            assert len(rows) == n
            for row in rows:
                assert set(row) == set(d), k
                for name, rd in d.items():
                    assert row[name].shape == rd.shape[1:], (k, name)
                    assert (row[name].init, row[name].scale) == (
                        rd.init, rd.scale), (k, name)
        else:
            assert defs[k].shape == d.shape, k
            assert (defs[k].init, defs[k].scale) == (d.init, d.scale), k
    assert count_params(defs) == ref_count_params(ref_defs)
    if not smoke:
        assert count_params(defs) == 977_758_208


def test_params_carried_row_for_row():
    _, params = _ref()
    model = _port(params)
    assert len(model.enc_layers) == len(model.layers) == 2
    for i in range(2):
        for side, rows in (("enc_layers", model.enc_layers),
                           ("dec_layers", model.layers)):
            for name, t in rows[i].tensors().items():
                np.testing.assert_array_equal(
                    t.float().numpy(),
                    np.asarray(params[side][name][i], np.float32))
    tree = model.param_tree()
    assert list(tree) == ["embed", "enc_norm", "final_norm", "head",
                          "enc_layers", "layers"]


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("frames,ref_agrees", [(192, False), (512, True),
                                               (640, False)])
def test_encoder_attention_against_dense_softmax(frames, ref_agrees):
    """Non-causal attention over ``frames`` keys (the encoder's, and the
    cross-attention's over the memory) against a dense numpy softmax:
    the port's within 1e-5 of max|value| at every length (192 takes
    the naive path, 512 and 640 K4's plain version); the reference's
    only where ``frames % 512 == 0``, and more than 0.1 away elsewhere,
    where its zero-padded keys join the softmax."""
    rng = np.random.default_rng(frames)
    q, k, v = (rng.normal(size=(2, frames, 4, 16)).astype(np.float32)
               for _ in range(3))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) / 4.0
    p = np.exp(s - s.max(-1, keepdims=True))
    dense = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    got = L.blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=False)
    assert _rel(got, dense) <= ATTN_TOL
    theirs = _rel(jL.blockwise_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=False), dense)
    if ref_agrees:
        assert theirs <= ATTN_TOL
    else:
        assert theirs > 0.1, theirs


@pytest.mark.parametrize("S", [128, 512])
def test_bf16_blocks_match_reference(S):
    """Each block in bf16, fed the same input on both sides: the encoder
    layers' self-attention (non-causal) and MLP, the decoder layers'
    self-attention (causal) with the k and v it caches, the memory's
    keys and values and the cross-attention over them (S queries on 512
    frames): within one bf16 step of max|value|."""
    ref_model, params = _ref()
    model = _port(params)
    rng = np.random.default_rng(S)
    h_enc = jnp.asarray(rng.normal(size=(2, FRAMES, 64))).astype(jnp.bfloat16)
    h_dec = jnp.asarray(rng.normal(size=(2, S, 64))).astype(jnp.bfloat16)
    pos_e, pos_d = (jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (2, n))
                    for n in (FRAMES, S))

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()

    def tpos(x):
        return torch.from_numpy(np.array(x)).long()

    errs = {}
    for i in range(2):
        lp = jax.tree.map(lambda a: a[i], params["enc_layers"])
        p = model.enc_layers[i].tensors()
        want = _exact_casts(lambda lp, h: ref_model._self_attn(
            lp, h, pos_e, causal=False)[0], lp, h_enc)
        got, _ = model._self_attn(p, t(h_enc), tpos(pos_e), causal=False)
        errs[f"enc{i}.attn"] = _rel(got, want)
        want = _exact_casts(ref_model._mlp, lp, h_enc)
        errs[f"enc{i}.mlp"] = _rel(model._mlp(p, t(h_enc)), want)

        lp = jax.tree.map(lambda a: a[i], params["dec_layers"])
        p = model.layers[i].tensors()
        want, (wk, wv) = _exact_casts(lambda lp, h: ref_model._self_attn(
            lp, h, pos_d, causal=True), lp, h_dec)
        got, (k, v) = model._self_attn(p, t(h_dec), tpos(pos_d), causal=True)
        errs[f"dec{i}.attn"] = _rel(got, want)
        errs[f"dec{i}.k"], errs[f"dec{i}.v"] = _rel(k, wk), _rel(v, wv)
        mk, mv = _exact_casts(ref_model._mem_kv, lp, h_enc)
        k, v = model._mem_kv(p, t(h_enc))
        errs[f"dec{i}.mem_k"], errs[f"dec{i}.mem_v"] = _rel(k, mk), _rel(v, mv)
        want = _exact_casts(ref_model._cross_attn, lp, h_dec, mk, mv)
        got = model._cross_attn(p, t(h_dec), t(mk), t(mv))
        errs[f"dec{i}.cross"] = _rel(got, want)
    assert max(errs.values()) <= ULP16, errs


# ---------------------------------------------------------------- models
def test_encode_matches_reference_fp64_fp32_bf16():
    """The memory at 512 frames: fp64 within 1e-9; fp32 no further from
    the reference's fp32 than that is from its fp64; bf16 within 3e-2
    of max|value|."""
    inp = _inputs(128)
    emb = jnp.asarray(inp["embeds"])
    mem = {}
    for dtype in ("float64", "float32", "bfloat16"):
        ref_model, params = _ref(dtype)
        if dtype == "float64":
            with x64_reference():
                want = jax.jit(ref_model.encode)(
                    jax.tree.map(jnp.asarray, params), emb)
        elif dtype == "float32":
            want = jax.jit(ref_model.encode)(params, emb)
        else:
            want = _exact_casts(ref_model.encode, params, emb)
        with torch.inference_mode():
            got = _port(params).encode(torch.from_numpy(inp["embeds"]))
        mem[dtype] = (got, np.asarray(want))
    got, want = mem["float64"]
    assert got.dtype == torch.float64 and _rel(got, want) <= FP64_TOL
    floor = _rel(mem["float32"][1], want)
    assert floor <= FP32_FLOOR_CAP, floor
    got, want = mem["float32"]
    assert got.dtype == torch.float32 and _rel(got, want) <= floor
    got, want = mem["bfloat16"]
    assert got.dtype == torch.bfloat16 and _rel(got, want) <= BF16_TOL


@pytest.mark.parametrize("S", [128, 512])
def test_prefill_matches_reference(S):
    """Memory, hidden states, prefill logits and caches at 512 frames x
    S tokens (max_len S + 4).  fp64: within 1e-9 (logits 1e-6, returned
    as fp32), the caches rounded to bf16 bitwise the reference's; fp32:
    each output no further from the reference's fp32 (its caches bf16)
    than the reference's own fp32 is from its fp64, the largest over the
    outputs; bf16: the logits nearer the reference's bf16 logits than
    those are to its fp64 ones, and within 3e-2 of max|logit| at 128
    tokens."""
    inp = _inputs(S, seed=S)
    max_len = S + 4
    out = {}
    for dtype in ("float64", "float32", "bfloat16"):
        ref_model, params = _ref(dtype)
        out[dtype] = (_port_outputs(_port(params), inp, max_len),
                      _ref_outputs(ref_model, params, inp, max_len, dtype))
    (mem, h, cache, logits), (rmem, rh, rcache, rlogits) = out["float64"]
    assert h.dtype == cache["self_k"].dtype == torch.float64
    assert _rel(mem, rmem) <= FP64_TOL and _rel(h, rh) <= FP64_TOL
    assert _rel(logits, rlogits) <= LOGIT64_TOL
    for k, w in rcache.items():
        assert tuple(cache[k].shape) == w.shape, k
        np.testing.assert_array_equal(
            cache[k].to(torch.bfloat16).float().numpy(), w.astype(np.float32))
    ref64 = out["float64"][1]
    (mem, h, cache, logits), (rmem, rh, rcache, rlogits) = out["float32"]
    assert logits.dtype == torch.float32 == cache["cross_k"].dtype
    pairs = {"memory": (mem, rmem), "hidden": (h, rh),
             "logits": (logits, rlogits),
             **{k: (cache[k], rcache[k]) for k in rcache}}
    want64 = {"memory": ref64[0], "hidden": ref64[1], "logits": ref64[3],
              **ref64[2]}
    floor = max(_rel(w, want64[k]) for k, (_, w) in pairs.items())
    assert floor <= FP32_FLOOR_CAP, floor
    errs = {k: _rel(g, w) for k, (g, w) in pairs.items()}
    assert max(errs.values()) <= floor, (errs, floor)
    (_, _, cache, logits), (_, _, rcache, rlogits) = out["bfloat16"]
    assert cache["self_k"].dtype == torch.bfloat16
    assert tuple(cache["self_k"].shape) == (2, 2, max_len, 4, 16)
    assert tuple(cache["cross_k"].shape) == (2, 2, FRAMES, 4, 16)
    err = _rel(logits, rlogits)
    assert err <= _rel(rlogits, ref64[3]), err
    if S == 128:
        assert err <= BF16_TOL


def _cache(tree, dtype=None):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        dtype or torch.bfloat16) for k, v in tree.items()}


def test_decode_matches_reference_bf16():
    """Four decode steps from the reference's bf16 prefill cache (512
    frames, 128 tokens), both sides fed the same tokens: each step's
    logits within 3e-2 of max|logit|, and the self-attention cache the
    port writes in place within one bf16 step of the reference's."""
    ref_model, params = _ref()
    model = _port(params)
    S, steps = 128, 4
    inp = _inputs(S, seed=3)
    rcache, _ = _exact_casts(
        lambda p, b: ref_model.prefill(p, b, max_len=S + steps), params,
        {k: jnp.asarray(v) for k, v in inp.items()})
    cache = _cache(rcache)
    fed = np.random.default_rng(4).integers(0, 512, (steps, 2, 1),
                                            dtype=np.int32)
    for i in range(steps):
        want, rcache = _exact_casts(ref_model.decode_step, params, rcache,
                                    jnp.asarray(fed[i]), jnp.int32(S + i))
        got, cache = model.decode_step(cache, torch.from_numpy(fed[i]).long(),
                                       S + i)
        assert got.dtype == torch.float32
        assert _rel(got, want) <= BF16_TOL, i
    for k in ("self_k", "self_v"):
        assert _rel(cache[k], rcache[k]) <= ULP16, k


def test_decode_matches_reference_fp32():
    """An fp32 model decodes from an fp32 cache.  The reference's decode
    refuses an fp32 model on its own bf16 prefill cache (it writes fp32
    k into the bf16 cache), so both sides decode from that cache cast to
    fp32 here: four steps within 1e-4 of max|logit| (no bf16 cast on the
    decode path)."""
    ref_model, params = _ref("float32")
    model = _port(params)
    S, steps = 128, 4
    inp = _inputs(S, seed=5)
    rcache, _ = jax.jit(lambda p, b: ref_model.prefill(
        p, b, max_len=S + steps))(params,
                                  {k: jnp.asarray(v) for k, v in inp.items()})
    fed = np.random.default_rng(6).integers(0, 512, (steps, 2, 1),
                                            dtype=np.int32)
    with pytest.raises(TypeError):
        ref_model.decode_step(params, rcache, jnp.asarray(fed[0]),
                              jnp.int32(S))
    rcache = jax.tree.map(lambda a: a.astype(jnp.float32), rcache)
    cache = _cache(rcache, torch.float32)
    step = jax.jit(ref_model.decode_step)
    for i in range(steps):
        want, rcache = step(params, rcache, jnp.asarray(fed[i]),
                            jnp.int32(S + i))
        got, cache = model.decode_step(cache, torch.from_numpy(fed[i]).long(),
                                       S + i)
        assert _rel(got, want) <= TOL, i
    for k in ("self_k", "self_v"):
        assert _rel(cache[k], rcache[k]) <= TOL, k


def test_prefill_counts_no_kernel_launch_on_the_cpu():
    """On the CPU the wrappers run the plain versions: no K4 launch is
    counted, and the non-causal counters stay 0."""
    _, params = _ref()
    fa.reset_launches()
    _port(params).prefill(torch.zeros(1, 128, dtype=torch.long), 128,
                          embeds=torch.zeros(1, FRAMES, 64))
    assert fa.LAUNCHES["flash_attention"] == 0
    assert fa.NONCAUSAL == {"wgmma": 0, "simt": 0}


def test_cache_spec_and_init_cache():
    model = build_model(smoke_shrink(get_config(ARCH)), seed=0, device="cpu")
    spec = model.cache_spec(3, 40, enc_len=24)
    assert spec == {
        "self_k": ((2, 3, 40, 4, 16), torch.bfloat16),
        "self_v": ((2, 3, 40, 4, 16), torch.bfloat16),
        "cross_k": ((2, 3, 24, 4, 16), torch.bfloat16),
        "cross_v": ((2, 3, 24, 4, 16), torch.bfloat16)}
    assert model.cache_spec(3, 40)["cross_k"][0] == (2, 3, 40, 4, 16)
    cache = model.init_cache(3, 40, 24, dtype=torch.float32)
    assert all(c.dtype == torch.float32 and not c.any()
               for c in cache.values())
    with pytest.raises(ValueError, match="embeds"):
        model.prefill(torch.zeros(1, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="max_len"):
        model.prefill(torch.zeros(1, 8, dtype=torch.long), 4,
                      embeds=torch.zeros(1, 8, 64))


def test_build_model_defaults_to_the_card():
    cfg = get_config(ARCH)
    assert isinstance(build_model(smoke_shrink(cfg), device="cpu"), EncDecLM)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)


def test_serve_and_its_example_on_cpu(capsys):
    """decode_demo's serve (frames = prompt length, as the reference's
    demo) and the serve_lm example with ``--arch seamless-m4t-medium``:
    tokens of the right shapes and range, reproducible from the seed."""
    r = serve(ARCH, smoke=True, batch=3, prompt_len=64, gen_tokens=5, seed=1,
              device="cpu")
    assert r["generated"].shape == (3, 5)
    assert ((r["generated"] >= 0) & (r["generated"] < 512)).all()
    assert tuple(r["prefill_logits"].shape) == (3, 512)
    assert torch.isfinite(r["prefill_logits"]).all()
    again = serve(ARCH, smoke=True, batch=3, prompt_len=64, gen_tokens=5,
                  seed=1, device="cpu")
    np.testing.assert_array_equal(again["generated"], r["generated"])
    got = serve_lm.main(["--device", "cpu", "--arch", ARCH])
    assert got[ARCH]["generated"].shape == (4, 24)
    assert ARCH in capsys.readouterr().out
