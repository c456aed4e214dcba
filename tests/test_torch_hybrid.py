"""The port's Zamba2 hybrid (``models/hybrid.py``) and the sliding window
of K4's forward, held against the JAX package on the CPU.

Inputs are drawn with numpy from fixed seeds; both sides run the
reference's smoke shrink of zamba2-7b (4 layers, ``attn_every`` 2,
window 64) and a 7-layer cut of it with the published ``attn_every`` 6
(one group of 6 mamba layers and the shared block, then one tail layer),
on the reference's ``init_params`` weights carried across by
``lm_params_from_numpy``.

Tolerances, each with its reason:

- the window in K4's plain version, ``ref.attention_ref`` and
  ``ops.attention``: 1e-5 against the reference's jnp
  ``blockwise_attention`` (fp32; another tiling of the online softmax);
- fp32 hidden states, prefill logits and decode: 1e-3 of max|value|.
  Only summation orders differ (the chunked SSD's above all), but the
  shrink's random weights amplify them: the readings reach 4.8e-4 at
  S = 64 on this CPU.  The card-against-CPU fp32 check of the smoke uses
  the same 1e-3;
- bf16: every block and the cache entries it writes, fed the same input
  on both sides, within one bf16 step of max|value| (2^-7: a rounding
  moved by one step, the blocks differing only in summation order).
  End to end the random weights amplify such single steps: on this CPU
  each side's bf16 logits are 15-46% of max|logit| from its own fp32
  logits at S = 64-128, and the two sides' 2.5-5% apart at S = 64-128.
  So the bf16 stack is held end to end at S = 32, shorter than an SSD
  chunk (both sides run the sequential scan), to the JAX suite's bf16
  attention tolerance, 3e-2 of max|value|.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import smoke_shrink as ref_smoke_shrink  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.parallel.sharding import init_params as ref_init_params  # noqa: E402

from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.interop import _unstack, lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, param_defs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.ssm_model import mamba_block  # noqa: E402

ARCH = "zamba2-7b"
TOL = 1e-3
ATTN_TOL = 1e-5
ULP16 = 2.0 ** -7
BF16_TOL = 3e-2
# the default shrink (4 layers, a shared block after every 2) and 7
# layers at the published attn_every 6 (one group, one tail layer)
SHRINKS = {"smoke": {}, "seven": dict(num_layers=7, attn_every=6)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _rel(got, want) -> float:
    want = _np(want)
    scale = max(np.abs(want).max(), 1e-30)
    return float(np.abs(_np(got) - want).max() / scale)


def _exact_casts(fn, *args):
    """``fn`` compiled with every bf16 cast rounded as written (see
    ``tests/test_torch_lm.py``)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _cfgs(shrink):
    kw = SHRINKS[shrink]
    return (dataclasses.replace(smoke_shrink(get_config(ARCH)), **kw),
            dataclasses.replace(ref_smoke_shrink(ref_get_config(ARCH)), **kw))


def _pair(shrink, dtype):
    """(reference model, its params, port model) on the reference's
    weights in ``dtype``."""
    cfg, ref_cfg = _cfgs(shrink)
    ref_model = ref_build_model(ref_cfg)
    params = ref_init_params(ref_model.param_defs(), jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(dtype), params)
    model = build_model(cfg, lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)), device="cpu")
    return ref_model, params, model


def _tokens(S, seed, B=2, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S),
                                                dtype=np.int32)


def _cache_to_torch(tree):
    """The reference's cache as tensors in the port's layout (the same
    keys, shapes and types)."""
    out = {}
    for k, v in tree.items():
        a = np.asarray(v)
        out[k] = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                  if a.dtype.name == "bfloat16"
                  else torch.from_numpy(np.array(a)))
    return out


# ------------------------------------------------------------- the window
WINDOW_CASES = [
    # (sq, sk, q_offset, window)
    (128, 128, 0, 32),
    (128, 128, 0, 64),      # the shrink's window, S = 2 windows
    (192, 256, 64, 100),    # a chunk with q_offset, window off the tiles
    (64, 512, 448, 200),    # the last rows of a long prompt
    (64, 64, 0, 1),         # each row sees only itself
    (128, 128, 0, 128),     # window = sk: causal
    (256, 256, 0, 1000),    # window > sk: causal
]


@pytest.mark.parametrize("sq,sk,q_offset,window", WINDOW_CASES)
def test_windowed_flash_plain_matches_reference(sq, sk, q_offset, window):
    """K4's plain version with a window against ``ref.attention_ref`` and
    the reference's jnp ``blockwise_attention(window=)``, fp32, GQA; a
    window of at least ``q_offset + sq`` is the causal function."""
    rng = np.random.default_rng(sq + sk + q_offset + window)
    H, KV, d = 4, 2, 16
    q = rng.normal(size=(1, sq, H, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, sk, KV, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jL.blockwise_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, q_offset=q_offset,
        window=window))
    qf = _t(q[0].transpose(1, 0, 2))
    kf, vf = (_t(x[0].transpose(1, 0, 2)) for x in (k, v))
    got = fa.flash_attention_plain(qf, kf, vf, causal=True,
                                   q_offset=q_offset, window=window)
    naive = ref.attention_ref(qf, kf.repeat_interleave(2, 0),
                              vf.repeat_interleave(2, 0), causal=True,
                              q_offset=q_offset, window=window)
    want = want[0].transpose(1, 0, 2)
    assert _rel(got, want) <= ATTN_TOL
    assert _rel(naive, want) <= ATTN_TOL
    if window >= q_offset + sq:
        causal = fa.flash_attention_plain(qf, kf, vf, causal=True,
                                          q_offset=q_offset)
        assert torch.equal(got, causal)


@pytest.mark.parametrize("S,branch", [(96, "ragged"), (256, "flash")])
def test_ops_attention_window_on_both_branches(S, branch, monkeypatch):
    """``ops.attention(window=)`` through the ragged branch (the naive
    reference) and the flash branch (the plain K4 on the CPU), against
    the reference's jnp ``blockwise_attention``; no kernel launches."""
    calls = {"ragged": 0, "flash": 0}
    naive, plain = ref.attention_ref, fa.flash_attention_plain

    def count(name, fn):
        def inner(*a, **kw):
            calls[name] += 1
            assert kw["window"] == 48
            return fn(*a, **kw)
        return inner

    monkeypatch.setattr(ref, "attention_ref", count("ragged", naive))
    monkeypatch.setattr(fa, "flash_attention_plain", count("flash", plain))
    rng = np.random.default_rng(S)
    q = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    fa.reset_launches()
    got = ops.attention(_t(q), _t(k), _t(v), causal=True, window=48)
    want = jL.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                  window=48)
    assert calls[branch] == 1 and sum(calls.values()) == 1
    assert fa.LAUNCHES["flash_attention"] == 0
    assert _rel(got, want) <= ATTN_TOL


def test_window_backward_and_negative_window_raise():
    """K4's backward takes a window (item 11.4b): on CPU tensors the
    wrapper runs the plain version, which gives autograd's gradients of
    the windowed plain forward and launches nothing; a negative window
    is refused by the forward and the backward."""
    g = torch.Generator().manual_seed(8)
    q = torch.randn(2, 64, 16, generator=g, requires_grad=True)
    o = fa.flash_attention_plain(q, q, q, window=8)
    do = torch.randn(o.shape, generator=g)
    (want,) = torch.autograd.grad(o, q, do)
    qd = q.detach()
    o, lse = fa.flash_attention_plain(qd, qd, qd, window=8, return_lse=True)
    fa.reset_launches()
    dq, dk, dv = fa.flash_attention_bwd(qd, qd, qd, o, lse, do, window=8)
    assert set(fa.LAUNCHES.values()) == {0}
    torch.testing.assert_close(dq + dk + dv, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bwd(qd, qd, qd, o, lse, do, window=-1)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=-1)


# --------------------------------------------------------------- params
@pytest.mark.parametrize("shrink", sorted(SHRINKS))
def test_param_defs_match_reference_unstacked(shrink):
    """The reference's declarations, unstacked by ``interop._unstack``
    (its ``groups`` stacked twice, its ``tail``), equal the port's leaf
    for leaf: shape, init rule and scale."""
    cfg, ref_cfg = _cfgs(shrink)
    ref_defs = ref_build_model(ref_cfg).param_defs()
    # zero-stride arrays of the stacked shapes: unstacked without memory
    shapes = jax.tree.map(lambda d: np.broadcast_to(np.float32(0), d.shape),
                          ref_defs, is_leaf=lambda x: hasattr(x, "init"))
    got = _unstack(cfg, shapes,
                   lambda x, i: np.shape(x if i is None else x[i]))
    defs = param_defs(cfg)
    assert len(defs["layers"]) == len(got["layers"]) == cfg.num_layers
    for k in ("embed", "final_norm", "head"):
        assert defs[k].shape == got[k]
    for n, d in defs["shared"].items():
        ref_d = ref_defs["shared"][n]
        assert d.shape == got["shared"][n] == ref_d.shape, n
        assert (d.init, d.scale) == (ref_d.init, ref_d.scale), n
    stacked = {**ref_defs["groups"]}
    for j, (layer, shaped) in enumerate(zip(defs["layers"], got["layers"])):
        assert set(layer) == set(shaped) == set(stacked), j
        for n, d in layer.items():
            assert d.shape == shaped[n], (j, n)
            assert (d.init, d.scale) == (stacked[n].init, stacked[n].scale)


def test_params_carried_row_for_row():
    """``lm_params_from_numpy`` puts row ``i`` of group ``g`` at layer
    ``g·attn_every + i`` and the tail after the groups; the shared block
    stays one set."""
    ref_model, params, model = _pair("seven", jnp.float32)
    tree = model.param_tree()
    for j in range(7):
        src = (jax.tree.map(lambda a: a[0, j], params["groups"]) if j < 6
               else jax.tree.map(lambda a: a[j - 6], params["tail"]))
        for n, w in src.items():
            np.testing.assert_array_equal(_np(tree["layers"][j][n]),
                                          np.asarray(w))
    for n, w in params["shared"].items():
        np.testing.assert_array_equal(_np(tree["shared"][n]), np.asarray(w))


# ---------------------------------------------------------------- fp32
@pytest.mark.parametrize("shrink", sorted(SHRINKS))
@pytest.mark.parametrize("S", [64, 128])
def test_hidden_states_match_reference_fp32(shrink, S):
    """The forward (the training path's, each block checkpointed) at
    S <= window and S > window through K4's flash path, fp32."""
    ref_model, params, model = _pair(shrink, jnp.float32)
    toks = _tokens(S, seed=S)
    want, _ = jax.jit(ref_model.hidden_states)(params,
                                               {"tokens": jnp.asarray(toks)})
    got, aux = model.hidden_states({"tokens": toks})
    assert float(aux) == 0.0
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("shrink", sorted(SHRINKS))
@pytest.mark.parametrize("S", [40, 64, 96, 128])
def test_prefill_logits_match_reference_fp32(shrink, S):
    """Prefill's last-position logits at S <= window (40: ragged, the
    sequential scan; 64) and S > window (96, 128), fp32."""
    ref_model, params, model = _pair(shrink, jnp.float32)
    toks = _tokens(S, seed=S + 1)
    _, want = jax.jit(lambda p, t: ref_model.prefill(
        p, {"tokens": t}, max_len=S + 4))(params, jnp.asarray(toks))
    _, got = model.prefill(torch.from_numpy(toks).long(), max_len=S + 4)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("shrink", sorted(SHRINKS))
@pytest.mark.parametrize("S", [32, 64, 128])
def test_decode_from_the_same_cache_matches_reference_fp32(shrink, S):
    """One decode step on both sides from the reference's own prefill
    cache (its rings rounded to bf16 by its prefill, cast to fp32 here so
    that its decode takes an fp32 model), at lengths where the two ring
    layouts coincide: logits and every cache entry at 1e-4."""
    ref_model, params, model = _pair(shrink, jnp.float32)
    toks = _tokens(S + 1, seed=S + 2)
    ref_cache, _ = jax.jit(lambda p, t: ref_model.prefill(
        p, {"tokens": t}, max_len=S + 4))(params, jnp.asarray(toks[:, :S]))
    ref_cache = {k: v.astype(jnp.float32) if k.startswith("attn") else v
                 for k, v in ref_cache.items()}
    cache = _cache_to_torch(ref_cache)
    want, ref_cache = jax.jit(ref_model.decode_step)(
        params, ref_cache, jnp.asarray(toks[:, S:]), jnp.int32(S))
    got, cache = model.decode_step(cache, torch.from_numpy(toks[:, S:]).long(),
                                   S)
    assert _rel(got, want) <= TOL
    for k, w in ref_cache.items():
        # the conv carries are bf16 on both sides: one step apart at most
        tol = ULP16 if cache[k].dtype == torch.bfloat16 else TOL
        assert _rel(cache[k], w) <= tol, k


@pytest.mark.parametrize("shrink", sorted(SHRINKS))
@pytest.mark.parametrize("S", [32, 64, 96, 128, 160])
def test_ring_decode_equals_prefill_fp32(shrink, S, monkeypatch):
    """The ring: prefill of S tokens, then decode of token S and S + 1,
    equals the prefill of all S + 2 tokens (fp32 model, fp32 rings),
    whether the prompt fills the window or not, and whether S is a
    multiple of it (96, 160: the reference's own layout evicts the wrong
    key there).  The cache spec keeps the conv carries in bf16 (the
    reference's); here they are held in fp32, so that the decode differs
    from the prefill only by summation order and the ring is what is
    under test."""
    _, _, model = _pair(shrink, jnp.float32)
    init = model.init_cache

    def fp32_carries(*a, **kw):
        return {k: v.float() for k, v in init(*a, **kw).items()}

    monkeypatch.setattr(model, "init_cache", fp32_carries)
    toks = torch.from_numpy(_tokens(S + 2, seed=S + 3)).long()
    cache, _ = model.prefill(toks[:, :S], max_len=S + 2)
    assert cache["attn_k"].dtype == torch.float32
    for i in range(2):
        got, cache = model.decode_step(cache, toks[:, S + i:S + i + 1], S + i)
        _, want = model.prefill(toks[:, :S + i + 1], max_len=S + 2)
        assert _rel(got, want) <= TOL, i


@pytest.mark.parametrize("S", [96, 128])
def test_reference_ring_layout_diverges_where_S_is_not_a_multiple(S):
    """The divergence kept as found.  The reference lays its prefill
    rings out as the last ``eff`` keys in order; the port by ``position %
    eff``.  The same cache re-laid the port's way (``np.roll``) decodes
    through the reference exactly as it does through the port (1e-3),
    and the two layouts are one at S = 128 (a multiple of the window):
    the reference's decode from its own layout is the same there, and
    far from it at S = 96."""
    ref_model, params, model = _pair("smoke", jnp.float32)
    toks = jnp.asarray(_tokens(S + 1, seed=S + 3))
    cache, _ = jax.jit(lambda p, t: ref_model.prefill(
        p, {"tokens": t}, max_len=S + 1))(params, toks[:, :S])
    cache = {k: v.astype(jnp.float32) if k.startswith("attn") else v
             for k, v in cache.items()}
    eff = cache["attn_k"].shape[2]
    relaid = {k: jnp.roll(v, (S - eff) % eff, axis=2)
              if k.startswith("attn") else v for k, v in cache.items()}
    step = jax.jit(ref_model.decode_step)
    theirs, _ = step(params, cache, toks[:, S:], jnp.int32(S))
    fixed, _ = step(params, relaid, toks[:, S:], jnp.int32(S))
    ours, _ = model.decode_step(_cache_to_torch(relaid),
                                torch.from_numpy(np.array(toks[:, S:])).long(),
                                S)
    assert _rel(ours, fixed) <= TOL
    if S % eff == 0:
        np.testing.assert_array_equal(np.asarray(theirs), np.asarray(fixed))
    else:
        assert _rel(theirs, fixed) > 1e-2


# ---------------------------------------------------------------- bf16
@pytest.mark.parametrize("shrink", sorted(SHRINKS))
@pytest.mark.parametrize("S", [32, 64, 128])
def test_bf16_blocks_and_their_caches_match_reference(shrink, S):
    """bf16: each block on the reference's own input (the reference's
    stack run block by block): the output and the cache entries it writes
    (a mamba layer's state and conv carries, the shared block's k and v)
    within one bf16 step of max|value|."""
    ref_model, params, model = _pair(shrink, jnp.bfloat16)
    cfg = model.cfg
    tree = model.param_tree()
    toks = _tokens(S, seed=S + 4)
    h = params["embed"][jnp.asarray(toks)]
    jpos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (2, S))
    pos = torch.arange(S).expand(2, S)
    ae, ng = cfg.attn_every, model.n_groups
    for j in range(cfg.num_layers):
        src = (params["groups"], (j // ae, j % ae)) if j < ng * ae else (
            params["tail"], (j - ng * ae,))
        lp = jax.tree.map(lambda a: a[src[1]], src[0])
        want, ws, (wx, wbc) = _exact_casts(ref_model._mamba, lp, h)
        got, gs, (gx, gbc) = mamba_block(cfg, tree["layers"][j],
                                         _t(h, torch.bfloat16))
        for g_, w in ((got, want), (gs, ws), (gx, wx), (gbc, wbc)):
            assert _rel(g_, w) <= ULP16, j
        h = want
        if model._group_after(j) is not None:
            want, (wk, wv) = _exact_casts(
                lambda sp, x: ref_model._shared_attn(sp, x, jpos),
                params["shared"], h)
            got, (gk, gv) = model._shared_attn(tree["shared"],
                                               _t(h, torch.bfloat16), pos)
            for g_, w in ((got, want), (gk, wk), (gv, wv)):
                assert _rel(g_, w) <= ULP16, j
            h = want


@pytest.mark.parametrize("shrink", sorted(SHRINKS))
def test_bf16_prefill_matches_reference_within_a_chunk(shrink):
    """bf16 end to end at S = 32 (shorter than an SSD chunk: both sides
    run the sequential scan): the prefill logits, then one decode step
    from each side's own cache, within 3e-2 of max|logit| (the JAX
    suite's bf16 attention tolerance); the caches hold the reference's
    keys and types (their values are held block by block above)."""
    ref_model, params, model = _pair(shrink, jnp.bfloat16)
    S = 32
    toks = _tokens(S + 1, seed=5)
    ref_cache, want = _exact_casts(lambda p, t: ref_model.prefill(
        p, {"tokens": t}, max_len=S + 2), params, jnp.asarray(toks[:, :S]))
    cache, got = model.prefill(torch.from_numpy(toks[:, :S]).long(),
                               max_len=S + 2)
    assert _rel(got, want) <= BF16_TOL
    assert set(cache) == set(ref_cache)
    for k, w in ref_cache.items():
        assert cache[k].dtype == (torch.float32 if "ssm" in k
                                  else torch.bfloat16), k
        assert tuple(cache[k].shape) == w.shape, k
    want, _ = _exact_casts(ref_model.decode_step, params, ref_cache,
                           jnp.asarray(toks[:, S:]), jnp.int32(S))
    got, _ = model.decode_step(cache, torch.from_numpy(toks[:, S:]).long(), S)
    assert _rel(got, want) <= BF16_TOL


def test_cache_spec_and_init_cache_types():
    """The reference's cache keys and shapes; bf16 rings unless
    ``init_cache(dtype=)`` overrides them; the SSM state fp32 and the
    conv carries bf16 whatever the override."""
    cfg, ref_cfg = _cfgs("seven")
    model = build_model(cfg, seed=0, device="cpu")
    spec = ref_build_model(ref_cfg).cache_spec(2, 100)
    ours = model.cache_spec(2, 100)
    assert set(ours) == set(spec)
    for k, (sds, _) in spec.items():
        assert ours[k][0] == sds.shape, k
    assert ours["attn_k"][0][2] == cfg.window  # min(window, max_len)
    assert model.cache_spec(2, 40)["attn_k"][0][2] == 40
    cache = model.init_cache(2, 100, dtype=torch.float32)
    assert cache["attn_k"].dtype == cache["attn_v"].dtype == torch.float32
    assert cache["ssm"].dtype == cache["tail_ssm"].dtype == torch.float32
    assert cache["conv_x"].dtype == torch.bfloat16
    assert cache["tail_conv_bc"].dtype == torch.bfloat16
    assert model.init_cache(2, 100)["attn_k"].dtype == torch.bfloat16


def test_windowed_gradient_raises_and_forward_loss_runs():
    """The hybrid's loss runs forward, and since item 11.4b its gradient
    runs through the windowed attention (at S = 128 the window of 64
    binds): every parameter, the shared block's included, gets a finite
    gradient that is not all zero."""
    model = build_model(smoke_shrink(get_config(ARCH)), seed=0, device="cpu")
    batch = {"tokens": _tokens(128, seed=6), "labels": _tokens(128, seed=7)}
    loss, parts = model.loss(batch)
    assert torch.isfinite(loss) and float(parts["aux"]) == 0.0
    model.train_mode(True)
    loss, _ = model.loss(batch)
    loss.backward()
    for p in model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
        assert p.grad.any()


@pytest.mark.parametrize("S", [64, 96, 128])
def test_bf16_logits_nearer_the_reference_than_bf16_is_to_fp32(S):
    """End to end in bf16, past an SSD chunk: the port's logits stay far
    nearer the reference's than either side's bf16 logits are to its
    own fp32 logits on the same weights (the shrink amplifies single
    bf16 roundings; this bounds the port's share of the distance)."""
    ref_model, params, model = _pair("smoke", jnp.bfloat16)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    m32 = build_model(model.cfg, lm_params_from_numpy(
        model.cfg, jax.tree.map(np.asarray, p32)), device="cpu")
    toks = _tokens(S, seed=S)

    def ref_prefill(p, fn):
        return np.asarray(fn(lambda p, t: ref_model.prefill(
            p, {"tokens": t}, max_len=S + 2)[1], p, jnp.asarray(toks)))

    want = ref_prefill(params, _exact_casts)
    want32 = ref_prefill(p32, lambda f, *a: jax.jit(f)(*a))
    got = model.prefill(torch.from_numpy(toks).long(), max_len=S + 2)[1]
    got32 = m32.prefill(torch.from_numpy(toks).long(), max_len=S + 2)[1]
    port_vs_ref = _rel(got, want)
    assert port_vs_ref <= 0.25 * _rel(want, want32), port_vs_ref
    assert port_vs_ref <= 0.25 * _rel(got, got32), port_vs_ref


def test_rope_freqs_come_from_the_host_once():
    """The rotary frequencies are the reference's (to an ulp: XLA's
    ``pow`` and torch's differ there too), computed on the host once per
    (head dim, theta, device) and reused (a card's ``pow`` may land an
    ulp away, which long positions multiply), and a table first made
    under ``inference_mode`` still serves autograd."""
    with torch.inference_mode():
        first = L.rope_freqs(112, 500000.0, "cpu")
    again = L.rope_freqs(112, 500000.0, torch.device("cpu"))
    assert again is first and not first.is_inference()
    np.testing.assert_allclose(
        first.numpy(), np.asarray(jL.rope_freqs(112, 500000.0)), rtol=3e-7)
    x = torch.randn(1, 4, 2, 112, requires_grad=True)
    L.apply_rope(x, torch.arange(4)[None], 500000.0).sum().backward()
    assert x.grad is not None
