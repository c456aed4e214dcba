"""The port's MoE layer, M-RoPE and the MoE / VLM families of
``DecoderLM`` held against the JAX package.

``moe_layer`` runs on numpy-drawn inputs at fp32 on both sides, with
both dispatches: the routing (ids, kept slots) must be equal, the
outputs within rtol/atol 2e-3 (the LM tests' ``TOL``) and the Switch aux
loss within 1e-6; one shape drops tokens (asserted), one drops none.
``apply_mrope`` agrees to 1e-6.  The models run the reference's smoke
shrinks on its ``init_params`` weights, carried across by
``lm_params_from_numpy``: prefill and four decode steps at fp32 (TOL,
caches key for key; ``tests/test_torch_lm.py`` holds the bf16 runs), and
deepseek-moe-16b's loss and every gradient against
``jax.value_and_grad`` at 2e-3 (the loss relative, each gradient of its
tensor's max|grad|).
"""

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

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import decode_demo  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = 2e-3
AUX_TOL = 1e-6
ROPE_TOL = 1e-6
MOE_ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
ARCHS = MOE_ARCHS + ("qwen2-vl-72b",)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _ref_route(x, router_w, top_k, dispatch):
    """The reference's routing decisions, as its ``moe_layer`` computes
    them: (ids (T, k), keep (T·k,))."""
    T = x.shape[0] * x.shape[1]
    E = router_w.shape[1]
    logits = jnp.asarray(x).reshape(T, -1) @ jnp.asarray(router_w)
    probs = jax.nn.softmax(logits, axis=-1)
    _, ids = jax.lax.top_k(probs, top_k)
    cap = max(8, -(-int(1.25 * T * top_k / E) // 8) * 8)
    flat = np.asarray(ids).reshape(-1)
    mypos = np.zeros_like(flat)
    seen = np.zeros(E, np.int64)
    for i, e in enumerate(flat):  # first come, first served
        mypos[i] = seen[e]
        seen[e] += 1
    return np.asarray(ids), mypos < cap


def _moe_inputs(T, D, E, F, skew, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, T // 2, D)).astype(np.float32)
    router = (0.3 * rng.normal(size=(D, E))).astype(np.float32)
    # feature 0 is positive in every token and favours the low experts,
    # which then overflow their capacity
    x[..., 0] = 1.0 + np.abs(x[..., 0])
    router[0] += skew * np.linspace(1.0, 0.0, E, dtype=np.float32)
    w = [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return x, router, w


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("T,E,k,skew,drops", [
    (96, 8, 2, 2.0, True),   # cap 32 of 192 slots, the low experts overfull
    (6, 4, 2, 0.0, False),   # cap 8 >= every slot: nothing dropped
    (64, 16, 6, 2.0, True),  # deepseek's top-6 at a small width
])
def test_moe_layer_matches_reference(dispatch, T, E, k, skew, drops):
    D, F = 32, 48
    x, router, (wg, wu, wd) = _moe_inputs(T, D, E, F, skew, seed=T + E)
    want, want_aux = jL.moe_layer(
        *map(jnp.asarray, (x, router, wg, wu, wd)), top_k=k,
        dispatch=dispatch)
    got, aux = L.moe_layer(*map(_t, (x, router, wg, wu, wd)), top_k=k,
                           dispatch=dispatch)
    _, _, ids, keep, dest, cap = L.moe_route(_t(x), _t(router), k,
                                             dispatch=dispatch)
    ref_ids, ref_keep = _ref_route(x, router, k, dispatch)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert bool((~keep).any()) == drops
    # every kept slot has a row of its own; dropped ones the trash row
    kept = dest[keep]
    assert kept.unique().numel() == kept.numel()
    assert bool((dest[~keep] == E * cap).all())
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


def test_moe_dispatches_agree():
    """"sort" and "cumsum" give the same positions in the expert."""
    x, router, _ = _moe_inputs(128, 32, 8, 16, 2.0, seed=3)
    a = L.moe_route(_t(x), _t(router), 2, dispatch="sort")
    b = L.moe_route(_t(x), _t(router), 2, dispatch="cumsum")
    for u, v in zip(a[:5], b[:5]):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="dispatch"):
        L.moe_route(_t(x), _t(router), 2, dispatch="scatter")


@pytest.mark.parametrize("T,k,E,cap", [(4, 6, 64, 8), (2048, 6, 64, 240),
                                       (256, 6, 64, 32), (10, 1, 16, 8)])
def test_moe_capacity(T, k, E, cap):
    assert L.moe_capacity(T, k, E) == cap


def test_apply_mrope_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, size=(3, 2, 7)).astype(np.int32)
    want = jL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.apply_mrope(_t(x), torch.from_numpy(pos).long(), 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=ROPE_TOL,
                               atol=ROPE_TOL)
    # one position on all three axes is plain RoPE
    same = np.broadcast_to(pos[0], (3, 2, 7))
    np.testing.assert_allclose(
        _np(L.apply_mrope(_t(x), torch.from_numpy(same.copy()).long(), 1e6)),
        _np(L.apply_rope(_t(x), torch.from_numpy(pos[0]).long(), 1e6)),
        rtol=ROPE_TOL, atol=ROPE_TOL)


# ---------------------------------------------------------------- models
def _pair(arch):
    """(reference model, its fp32 params, the port's model on them)."""
    ref_model = ref_build_model(ref_smoke_shrink(ref_get_config(arch)))
    params = ref_init_params(ref_model.param_defs(), jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    cfg = smoke_shrink(get_config(arch))
    model = build_model(cfg, lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)), device="cpu")
    return ref_model, params, model


def _prompt(cfg, B, S, seed, embeds=True):
    """numpy prompt inputs: tokens, and embeds and (3, B, S) positions
    with distinct temporal/height/width rows where ``cfg`` takes them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S),
                                  dtype=np.int32)}
    if cfg.embed_inputs and embeds:
        out["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        t = np.arange(S, dtype=np.int32)
        out["positions"] = np.stack([
            np.broadcast_to(t, (B, S)), np.broadcast_to(t // 8, (B, S)),
            np.broadcast_to(t % 8, (B, S))]).astype(np.int32)
    return out


def _close_tree(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w)
            continue
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(_np(got[k]), np.asarray(w, np.float32),
                                   rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_fp32(arch):
    """qwen2-vl-72b's prompt is its tokens here, with M-RoPE positions:
    the reference casts embeds to bf16 whatever the model's type, and its
    layer scan then refuses an fp32 model (the carry's type changes);
    the bf16 run in ``tests/test_torch_lm.py`` takes the embeds."""
    ref_model, params, model = _pair(arch)
    cfg = model.cfg
    B, S, steps = 2, 128, 4
    prompt = _prompt(cfg, B, S, seed=7, embeds=False)
    ref_cache, ref_logits = jax.jit(
        lambda p, b: ref_model.prefill(p, b, max_len=S + steps)
    )(params, {k: jnp.asarray(v) for k, v in prompt.items()})
    inputs = {k: torch.from_numpy(v) for k, v in prompt.items()}
    inputs["tokens"] = inputs["tokens"].long()
    cache, logits = decode_demo.prefill(model, inputs, max_len=S + steps)
    np.testing.assert_allclose(_np(logits), np.asarray(ref_logits),
                               rtol=TOL, atol=TOL)
    _close_tree(cache, ref_cache)

    fed = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                            size=(steps, B, 1), dtype=np.int32)
    ref_step = jax.jit(ref_model.decode_step)
    for i in range(steps):
        mrope = (jnp.full((3, B, 1), S + i, jnp.int32) if cfg.mrope
                 else None)
        ref_logits, ref_cache = ref_step(params, ref_cache,
                                         jnp.asarray(fed[i]),
                                         jnp.int32(S + i), mrope)
        logits, cache = decode_demo.decode_step(
            model, cache, torch.from_numpy(fed[i]).long(), S + i)
        np.testing.assert_allclose(_np(logits), np.asarray(ref_logits),
                                   rtol=TOL, atol=TOL)
    _close_tree(cache, ref_cache)


def test_moe_loss_and_grads_match_reference():
    """deepseek-moe-16b's shrink (a dense layer, then an MoE layer with
    shared experts): loss, aux and every gradient against
    ``jax.value_and_grad``."""
    ref_model, params, model = _pair("deepseek-moe-16b")
    cfg = model.cfg
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                              size=(2, 65), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (ref_loss, ref_met), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss(p, {k: jnp.asarray(v) for k, v in
                                     batch.items()}), has_aux=True))(params)
    model.train_mode(True)
    loss, met = model.loss(batch)
    loss.backward()
    aux = float(met["aux"].detach())
    assert aux > 0
    assert abs(aux - float(ref_met["aux"])) <= AUX_TOL
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=TOL)
    mine = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, ref_grads))
    got = dict(tree.flatten(model.param_tree()))
    want = dict(tree.flatten(mine))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].grad
        assert g is not None and g.shape == w.shape, path
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= TOL * scale, (path, err, scale)


def test_embeds_take_the_token_path():
    """Prompt embeddings that are the embedding rows of the tokens give
    the token prompt's logits and cache exactly (bf16 model: the cast to
    bf16 is exact), M-RoPE positions of the text on all three axes
    included."""
    cfg = smoke_shrink(get_config("qwen2-vl-72b"))
    model = build_model(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    inputs = decode_demo.prompt_inputs(cfg, 2, 64, gen)
    assert inputs["embeds"].shape == (2, 64, cfg.d_model)
    assert inputs["positions"].shape == (3, 2, 64)
    rows = model.top.embed.detach()[inputs["tokens"]].float()
    c1, l1 = model.prefill(inputs["tokens"], 70,
                           positions=inputs["positions"])
    c2, l2 = model.prefill(None, 70, embeds=rows,
                           positions=inputs["positions"])
    assert torch.equal(l1, l2)
    for grp in c1:
        for name in c1[grp]:
            assert torch.equal(c1[grp][name], c2[grp][name])


def test_step_makers_pass_vlm_inputs():
    """``make_prefill_step`` takes a VLM batch (embeds, M-RoPE positions)
    and ``make_decode_step`` the (3, B, 1) positions, as the reference's
    step makers pass them to the model."""
    from repro_torch.train.train_step import make_decode_step, make_prefill_step

    cfg = smoke_shrink(get_config("qwen2-vl-72b"))
    model = build_model(cfg, seed=5, device="cpu")
    inputs = decode_demo.prompt_inputs(cfg, 2, 64, torch.Generator().manual_seed(6))
    cache, logits = make_prefill_step(model)(dict(inputs), 66)
    want_cache, want = decode_demo.prefill(model, inputs, 66)
    assert torch.equal(logits, want)
    nxt = logits.argmax(-1)[:, None]
    mrope = torch.full((3, 2, 1), 64)
    got, _ = make_decode_step(model)(cache, nxt, 64, mrope)
    ref, _ = model.decode_step(want_cache, nxt, 64, mrope)
    assert torch.equal(got, ref)
    # M-RoPE at a position other than the text's moves the logits
    other, _ = model.decode_step(want_cache, nxt, 64, mrope + 7)
    assert not torch.equal(other, ref)
