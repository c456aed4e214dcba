"""The port's LM serving path (configs, parameters, layers, prefill and
decode of the dense, MoE, VLM, SSM and hybrid families) held against the
JAX package.

Both sides run the reference's smoke shrink of each architecture on the
same weights: the JAX ``init_params`` pytree, carried across by
``lm_params_from_numpy``, and the same numpy-drawn tokens.  In fp32 the
point is the algorithm: prefill logits and caches, and four decode steps
fed the same tokens, agree to rtol/atol 2e-3.  With the bf16 weights the
point is where the casts sit: logits agree to 3e-2 of max|logit|, the
JAX suite's bf16 attention tolerance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as ref_archs  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_shrink as ref_smoke_shrink  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.parallel.sharding import count_params as ref_count_params  # noqa: E402
from repro.parallel.sharding import init_params as ref_init_params  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCHS, get_config, smoke_shrink  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.launch.decode_demo import serve  # noqa: E402
from repro_torch.models import build_model, param_defs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.params import ParamDef, count_params, init_params  # noqa: E402

MODELS = ("qwen3-4b", "mamba2-130m", "deepseek-7b", "deepseek-moe-16b",
          "llama4-scout-17b-a16e", "qwen2-vl-72b", "zamba2-7b")
TOL = 2e-3
BF16_TOL = 3e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", MODELS + ("llama3-405b",))
def test_config_matches_reference(arch):
    ours, theirs = get_config(arch), ref_get_config(arch)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    small, ref_small = smoke_shrink(ours), ref_smoke_shrink(theirs)
    for f in dataclasses.fields(small):
        assert getattr(small, f.name) == getattr(ref_small, f.name), f.name


def test_only_served_models_are_registered():
    """The served models (the hybrid zamba2-7b among them), the
    encoder-decoder seamless-m4t-medium (``tests/test_torch_encdec.py``),
    llama3.2-3b (the training launcher's default) and llama3-405b (the
    dry run's, built only abstractly) are registered: the reference's
    ten, in its order; an unknown name raises."""
    assert list(ARCHS) == list(ref_archs)
    assert set(ARCHS) == set(MODELS) | {"llama3.2-3b", "seamless-m4t-medium",
                                        "llama3-405b"}
    assert "zamba2-7b" in ARCHS
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama3-1t")


# the reference's stacked layer groups, each with its stacking axes: the
# hybrid's ``groups`` stack (groups, attn_every) rows
STACKS = {"dense_layers": 1, "moe_layers": 1, "layers": 1, "groups": 2,
          "tail": 1}


def _ref_layer_defs(ref_defs):
    """The reference's stacked layer declarations, one dict per layer in
    layer order: its ``dense_layers`` rows, then its ``moe_layers`` rows
    (the SSM's ``layers``; the hybrid's ``groups`` rows in row-major
    order, then its ``tail``)."""
    out = []
    for stack, axes in STACKS.items():
        if stack in ref_defs:
            lead = next(iter(ref_defs[stack].values())).shape[:axes]
            out += [{n: (d.shape[axes:], d)
                     for n, d in ref_defs[stack].items()}
                    for _ in range(int(np.prod(lead)))]
    return out


def _same_defs(ours, theirs):
    """Unstacked declarations (nested dicts alike) with the same shapes,
    init rules and scales."""
    assert set(ours) == set(theirs)
    for k, d in theirs.items():
        if isinstance(d, dict):
            _same_defs(ours[k], d)
        else:
            assert ours[k].shape == d.shape, k
            assert (ours[k].init, ours[k].scale) == (d.init, d.scale), k


@pytest.mark.parametrize("arch", MODELS)
@pytest.mark.parametrize("smoke", [True, False])
def test_param_defs_match_reference(arch, smoke):
    """Every reference declaration, unstacked per layer (the dense
    stack, then the MoE stack; the hybrid's groups, then its tail), has
    the port's shape, init rule and scale, the hybrid's unstacked shared
    block too; the counts agree."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    if smoke:
        cfg, ref_cfg = smoke_shrink(cfg), ref_smoke_shrink(ref_cfg)
    defs = param_defs(cfg)
    ref_defs = ref_build_model(ref_cfg).param_defs()
    assert set(defs) == set(ref_defs) - set(STACKS) | {"layers"}
    _same_defs({k: v for k, v in defs.items() if k != "layers"},
               {k: v for k, v in ref_defs.items() if k not in STACKS})
    ref_layers = _ref_layer_defs(ref_defs)
    assert len(defs["layers"]) == len(ref_layers) == cfg.num_layers
    for layer, ref_layer in zip(defs["layers"], ref_layers):
        assert set(layer) == set(ref_layer)
        for n, (shape, theirs) in ref_layer.items():
            assert layer[n].shape == shape, n
            assert (layer[n].init, layer[n].scale) == (theirs.init,
                                                       theirs.scale), n
    assert count_params(defs) == ref_count_params(ref_defs)


def test_param_init_rules():
    gen = torch.Generator().manual_seed(0)
    p = init_params({"w": ParamDef((256, 512)), "z": ParamDef((3,), "zeros"),
                     "o": ParamDef((3,), "ones"),
                     "s": ParamDef((4096,), scale=0.02, dtype=torch.float32)},
                    gen)
    assert p["w"].dtype == torch.bfloat16 and p["s"].dtype == torch.float32
    assert abs(float(p["w"].float().std()) - 256 ** -0.5) < 0.01
    assert abs(float(p["s"].std()) - 0.02) < 0.002
    assert p["z"].eq(0).all() and p["o"].eq(1).all()
    again = init_params({"w": ParamDef((256, 512))},
                        torch.Generator().manual_seed(0))
    assert torch.equal(again["w"], p["w"])


def test_entry_points_default_to_the_card():
    cfg = smoke_shrink(get_config("qwen3-4b"))
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve("qwen3-4b")


def test_unported_features_raise():
    """What was unported runs or is refused with a reason: a mesh of
    more than one device trains over its processes and is refused on a
    run of one process.  llama3-405b, unported until item
    11.6.1, is registered and its abstract build runs (meta tensors,
    nothing allocated); the encoder-decoder family, unported until item
    11.5, builds, and the gradient through a sliding window (item 11.4b)
    runs."""
    from repro_torch.launch.train import train
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import abstract_state

    big = get_config("llama3-405b")
    state = abstract_state(big, opt.OptimizerConfig(moment_dtype="int8"))
    assert count_params(param_defs(big)) == 405_853_388_800
    assert {str(t.device) for t in tree.leaves(state)} == {"meta"}
    with pytest.raises(ValueError, match="run of 1 processes"):
        train("seamless-m4t-medium", steps=1, mesh_shape=(2, 1),
              device="cpu")
    cfg = smoke_shrink(get_config("qwen3-4b"))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(cfg, family="vit"), device="cpu")
    encdec = smoke_shrink(get_config("seamless-m4t-medium"))
    assert type(build_model(encdec, device="cpu")).__name__ == "EncDecLM"
    q = torch.zeros(1, 128, 2, 8, requires_grad=True)
    out = L.blockwise_attention(q, q, q, window=4)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


# ---------------------------------------------------------------- layers
def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(6, 4)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for state in (None, st):
        want, want_st = jL.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            None if state is None else jnp.asarray(state))
        got, got_st = L.causal_conv1d(_t(x), _t(w),
                                      None if state is None else _t(state))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(got_st), np.asarray(want_st))


def test_rope_norm_swiglu_decode_attention_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0) + 7
    np.testing.assert_allclose(
        _np(L.apply_rope(_t(x), torch.from_numpy(pos).long(), 1e6)),
        np.asarray(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    scale = rng.normal(size=(8,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.rms_norm(_t(x), _t(scale))),
        np.asarray(jL.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(2, 5, 8)).astype(np.float32)
    wg, wu = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(16, 8)).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.swiglu(_t(h), _t(wg), _t(wu), _t(wd))),
        np.asarray(jL.swiglu(*map(jnp.asarray, (h, wg, wu, wd)))),
        rtol=1e-4, atol=1e-4)
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 12, 2, 8)).astype(np.float32)
              for _ in range(2))
    np.testing.assert_allclose(
        _np(L.decode_attention(_t(q), _t(kc), _t(vc), 7)),
        np.asarray(jL.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                       jnp.int32(7))),
        rtol=1e-5, atol=1e-5)


def test_prefill_attention_matches_reference_blockwise():
    """The port's prefill attention (flash kernel path) against the
    reference model's jnp blockwise attention, GQA, causal."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 256, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 256, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = jL.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    fa.reset_launches()
    got = L.blockwise_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------- models
def _pair(arch, dtype):
    """(reference model, reference params, port model) on the reference's
    smoke-shrink weights, in ``dtype``."""
    ref_cfg = ref_smoke_shrink(ref_get_config(arch))
    ref_model = ref_build_model(ref_cfg)
    params = ref_init_params(ref_model.param_defs(), jax.random.PRNGKey(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    cfg = smoke_shrink(get_config(arch))
    tree = jax.tree.map(np.asarray, params)
    model = build_model(cfg, lm_params_from_numpy(cfg, tree), device="cpu")
    return ref_model, params, model


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_cache(got, want, tol):
    for k, w in want.items():
        if isinstance(w, dict):
            _close_cache(got[k], w, tol)
            continue
        assert tuple(got[k].shape) == w.shape, k
        if got[k].dtype == torch.bfloat16:
            # the conv carries are stored in bf16 on both sides, whatever
            # the activation type: an fp32 difference far below ``tol``
            # can still round one element to the neighbouring bf16 value,
            # so these are held to one bf16 step (2^-8 relative)
            np.testing.assert_allclose(_np(got[k]), np.asarray(w, np.float32),
                                       rtol=2 ** -7, atol=tol)
        else:
            _close(got[k], w, tol)


@pytest.mark.parametrize("arch,S", [
    ("qwen3-4b", 128),      # the flash kernel's path (S % 128 == 0)
    ("qwen3-4b", 40),       # ragged: the naive reference's path
    ("mamba2-130m", 128),   # chunked SSD (two chunks of 64)
    ("mamba2-130m", 50),    # ragged: the sequential scan
    ("deepseek-moe-16b", 40),       # ragged: a dense layer, then MoE
    ("llama4-scout-17b-a16e", 40),  # ragged: MoE layers only, top-1
])
def test_prefill_and_decode_match_reference_fp32(arch, S):
    ref_model, params, model = _pair(arch, "float32")
    B, steps = 2, 4
    vocab = ref_model.cfg.vocab_size
    prompts = _tokens(vocab, (B, S), seed=S)
    max_len = S + steps
    ref_cache, ref_logits = jax.jit(
        lambda p, t: ref_model.prefill(p, {"tokens": t}, max_len=max_len)
    )(params, jnp.asarray(prompts))
    fa.reset_launches()
    ssd.reset_launches()
    cache, logits = model.prefill(torch.from_numpy(prompts).long(),
                                  max_len=max_len)
    assert fa.LAUNCHES["flash_attention"] == 0
    assert ssd.LAUNCHES["ssd_chunk"] == 0
    _close(logits, ref_logits, TOL)
    _close_cache(cache, ref_cache, TOL)

    # decode from the reference's prefill cache on both sides: the conv
    # carries are bf16 whatever the activation type, and an fp32
    # difference far below TOL can round one carry to its bf16 neighbour,
    # which the recurrence then carries on at 2^-8 relative
    cache = _cache_from(ref_cache)
    ref_step = jax.jit(ref_model.decode_step)
    fed = _tokens(vocab, (steps, B, 1), seed=S + 1)
    for i in range(steps):
        ref_logits, ref_cache = ref_step(params, ref_cache,
                                         jnp.asarray(fed[i]),
                                         jnp.int32(S + i))
        logits, cache = model.decode_step(
            cache, torch.from_numpy(fed[i]).long(), S + i)
        _close(logits, ref_logits, TOL)
    _close_cache(cache, ref_cache, TOL)


def _cache_from(tree):
    if isinstance(tree, dict):
        return {k: _cache_from(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _exact_casts(fn, *args):
    """``fn`` compiled by XLA with every bf16 cast rounded as written.
    By default XLA's CPU backend may keep excess precision across a
    cast to bf16 inside a fusion, which the port's eager PyTorch never
    does; with it off the two differ only by summation order."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _prompt(cfg, B, S, seed):
    """The prompt as numpy arrays: tokens, and for a VLM backbone
    embeds (B, S, D) and M-RoPE positions (3, B, S) whose temporal,
    height and width rows differ."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S),
                                  dtype=np.int32)}
    if cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        out["positions"] = np.stack([t, t // 8, t % 8])
    return out


# the hybrid's bf16 stack amplifies single rounding steps of the chunked
# SSD's other summation order (each side's bf16 logits 15-46% of
# max|logit| from its fp32 ones at S = 64-128, the two sides 5.2% apart
# at S = 128 on this CPU): tests/test_torch_hybrid.py holds it block by
# block within one bf16 step, and end to end at S = 32
BF16_MODELS = tuple(m for m in MODELS if m != "zamba2-7b")


@pytest.mark.parametrize("arch", BF16_MODELS)
def test_prefill_and_decode_match_reference_bf16(arch):
    ref_model, params, model = _pair(arch, "bfloat16")
    B, S = 2, 128
    vocab = ref_model.cfg.vocab_size
    prompt = _prompt(model.cfg, B, S, seed=9)
    ref_cache, ref_logits = _exact_casts(
        lambda p, b: ref_model.prefill(p, b, max_len=S + 2),
        params, {k: jnp.asarray(v) for k, v in prompt.items()})
    extra = {k: torch.from_numpy(prompt[k]) for k in ("embeds", "positions")
             if k in prompt}
    cache, logits = model.prefill(torch.from_numpy(prompt["tokens"]).long(),
                                  max_len=S + 2, **extra)
    assert logits.dtype == torch.float32
    scale = float(np.abs(np.asarray(ref_logits)).max())
    err = float(np.abs(_np(logits) - np.asarray(ref_logits)).max())
    assert err <= BF16_TOL * scale, (err, scale)
    fed = _tokens(vocab, (B, 1), seed=10)
    mrope = np.full((3, B, 1), S, np.int32) if model.cfg.mrope else None
    ref_logits, _ = _exact_casts(
        ref_model.decode_step, params, ref_cache, jnp.asarray(fed),
        jnp.int32(S), None if mrope is None else jnp.asarray(mrope))
    step_extra = () if mrope is None else (torch.from_numpy(mrope),)
    logits, _ = model.decode_step(cache, torch.from_numpy(fed).long(), S,
                                  *step_extra)
    scale = float(np.abs(np.asarray(ref_logits)).max())
    err = float(np.abs(_np(logits) - np.asarray(ref_logits)).max())
    assert err <= BF16_TOL * scale, (err, scale)


@pytest.mark.parametrize("arch", MODELS)
def test_serve_on_cpu_returns_the_right_shapes(arch):
    r = serve(arch, smoke=True, batch=3, prompt_len=64, gen_tokens=5,
              seed=1, device="cpu")
    vocab = smoke_shrink(get_config(arch)).vocab_size
    assert r["generated"].shape == (3, 5)
    assert ((r["generated"] >= 0) & (r["generated"] < vocab)).all()
    assert tuple(r["prefill_logits"].shape) == (3, vocab)
    assert torch.isfinite(r["prefill_logits"]).all()
    assert r["prefill_s"] > 0 and r["decode_s"] > 0
    assert r["decode_tok_per_s"] > 0
    again = serve(arch, smoke=True, batch=3, prompt_len=64, gen_tokens=5,
                  seed=1, device="cpu")
    np.testing.assert_array_equal(again["generated"], r["generated"])
