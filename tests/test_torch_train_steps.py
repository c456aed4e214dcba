"""The port's train step and launcher over steps (three steps against
the reference's, the VLM trainer, the encoder-decoder's state, the
optimizer state's carry-over, checkpoints and resume, the example twin):
the cases of ``tests/test_torch_train.py`` that run whole steps, in a
file of their own so that another worker runs them beside that file's
loss and gradient cases.  The same checks, shapes, data and tolerances
(``tests/test_torch_train.py``'s docstring)."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import TrainState as RefTrainState  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402

from repro_torch import configs, tree  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.data.pipeline import SyntheticTextDataset  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.interop import lm_params_from_numpy, opt_state_from_numpy  # noqa: E402
from repro_torch.launch.train import train, train_batch, train_dataset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainState,
    init_state,
    load_state,
    make_train_step,
)

from test_torch_encdec import x64_reference  # noqa: E402
from test_torch_train import _np, _ref_setup  # noqa: E402


@pytest.mark.parametrize("arch,S", [("qwen3-4b", 128), ("mamba2-130m", 128),
                                    ("deepseek-moe-16b", 128)])
def test_three_train_steps_match_reference(arch, S):
    check_three_train_steps(arch, S)


def check_three_train_steps(arch, S):
    """Three steps of make_train_step from one converted state (fp32),
    on the launcher's batches: each step's loss within rtol 1e-4 of the
    reference's.  The encoder-decoder's steps run in fp64 on both sides
    (the port's update then works in fp64 too) and without weight decay:
    in fp32 its first encoder layer's bf16 casts part two evaluations by
    whole bf16 steps (see ENCDEC_FLOOR_CAP), and Adam's first steps,
    about lr·sign(g), carry the gradients' differences into the weights
    (the two packages' fp32 losses part by 4.4e-4 at step 2); the
    reference decays its stacked norms (ROADMAP.md, "Divergences kept as
    found"), which moves them by lr·wd and, through the same casts, the
    losses.  In fp64 without decay the losses read 1.4e-16, 2.2e-10 and
    1.7e-6 apart on this CPU."""
    fp64 = arch == "seamless-m4t-medium"
    ref_model, params, cfg = _ref_setup(arch)
    width = np.float64 if fp64 else np.float32
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              **({"weight_decay": 0.0} if fp64 else {}))
    rcfg, ocfg = ref_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    model = build_model(cfg, lm_params_from_numpy(
        cfg, jax.tree.map(lambda a: np.asarray(a, width), params)),
        device="cpu")
    state = init_state(model, ocfg)
    step = make_train_step(model, ocfg)
    ds = train_dataset(cfg, S, 2, seed=4)
    with x64_reference(ref_opt) if fp64 else contextlib.nullcontext():
        params = jax.tree.map(lambda a: jnp.asarray(a, width), params)
        rstate = RefTrainState(params, ref_opt.init(rcfg, params),
                               jnp.zeros((), jnp.int32))
        rstep = jax.jit(ref_make_train_step(ref_model, rcfg))
        for i in range(3):
            batch = train_batch(cfg, ds, i)
            rstate, rmet = rstep(rstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
            state, met = step(state, batch)
            assert set(met) == {"loss", "xent", "aux", "grad_norm", "lr"}
            assert float(met["loss"]) == pytest.approx(float(rmet["loss"]),
                                                       rel=1e-4)
            assert float(met["lr"]) == pytest.approx(float(rmet["lr"]),
                                                      rel=1e-6)
    assert int(state.step) == 3
    assert all(p.grad is None for p in tree.leaves(state.params))
    if fp64:
        assert {p.dtype for p in tree.leaves(state.params)} == {torch.float64}


def test_vlm_trainer_matches_reference(monkeypatch):
    """``launch.train.train("qwen2-vl-72b")`` (the VLM backbone's smoke
    shrink) on the reference's seed-0 weights gives the reference
    trainer's losses: both feed the step the stub frontend's embeddings
    with M-RoPE positions and no tokens.  bf16 weights, as both trainers
    build them: rtol 2e-4 (the two read 4.9e-5 apart on the CPU, bf16
    roundings of the loss's sums), where the token embeddings in place
    of the embeds move the losses by up to 4.3e-3."""
    from repro.launch.train import train as ref_train
    from repro_torch.launch import train as launcher

    ref_model, params, cfg = _ref_setup("qwen2-vl-72b", dtype=jnp.bfloat16)
    weights = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params))
    monkeypatch.setattr(launcher, "build_model",
                        lambda c, seed, device: build_model(c, weights,
                                                            device=device))
    kw = dict(steps=3, smoke=True, global_batch=2, seq_len=64)
    losses = train("qwen2-vl-72b", device="cpu", **kw)
    want = ref_train("qwen2-vl-72b", **kw)
    assert len(losses) == len(want) == 3
    np.testing.assert_allclose(losses, want, rtol=2e-4)


def test_train_batches_follow_the_reference_rule():
    """The trainer's dataset and batches for each family: embeddings of
    the model's width and M-RoPE positions for the VLM, without tokens;
    frame embeddings and tokens for the encoder-decoder (its encoder
    reads the one, its decoder the other); tokens alone for the
    others."""
    for arch, keys in (("qwen2-vl-72b", {"embeds", "positions", "labels"}),
                       ("seamless-m4t-medium", {"embeds", "tokens", "labels"}),
                       ("deepseek-moe-16b", {"tokens", "labels"}),
                       ("zamba2-7b", {"tokens", "labels"})):
        cfg = smoke_shrink(get_config(arch))
        batch = train_batch(cfg, train_dataset(cfg, 16, 2), 0)
        assert set(batch) == keys, arch
        if "embeds" in batch:
            assert batch["embeds"].shape == (2, 16, cfg.d_model)
        if "positions" in batch:
            assert batch["positions"].shape == (3, 2, 16)


def test_encdec_step_changes_every_encoder_parameter(tmp_path):
    """The encoder-decoder's training state holds its encoder: one step
    of the launcher's batch changes every encoder parameter (and every
    other), each with its moments, and a checkpoint of the state stores
    and restores the encoder's tensors."""
    cfg = smoke_shrink(get_config("seamless-m4t-medium"))
    model = build_model(cfg, seed=0, device="cpu")
    # lr 1e-2: a bf16 norm weight of 1 moves by less than its ulp at 1e-3
    ocfg = opt.OptimizerConfig(learning_rate=1e-2, warmup_steps=0)
    state = init_state(model, ocfg)
    before = {k: v.clone() for k, v in tree.flatten(state.params)}
    enc = [k for k in before if k.startswith(("enc_layers/", "enc_norm"))]
    assert len(enc) == 1 + cfg.encoder_layers * 9
    assert all(k in dict(tree.flatten(state.opt["m"])) for k in enc)
    batch = train_batch(cfg, train_dataset(cfg, 128, 2), 0)
    state, met = make_train_step(model, ocfg)(state, batch)
    assert np.isfinite(float(met["loss"]))
    after = dict(tree.flatten(state.params))
    unchanged = [k for k, v in before.items() if torch.equal(v, after[k])]
    assert not unchanged, unchanged
    moments = dict(tree.flatten(state.opt["v"]))
    assert all(float(moments[k].abs().max()) > 0 for k in enc)
    CheckpointManager(str(tmp_path)).save(1, state, blocking=True)
    fresh = init_state(build_model(cfg, seed=1, device="cpu"), ocfg)
    restored = load_state(fresh, CheckpointManager(str(tmp_path)).restore(
        fresh, device="cpu"))
    for k, v in tree.flatten(restored.params):
        assert torch.equal(v, after[k]), k


def test_opt_state_from_numpy_matches_reference_values():
    ref_model, params, cfg = _ref_setup("mamba2-130m")
    for moments in ("float32", "int8"):
        rcfg = ref_opt.OptimizerConfig(moment_dtype=moments)
        rstate = ref_opt.init(rcfg, params)
        g = jax.tree.map(lambda p: 0.5 * p, params)
        _, rstate, _ = jax.jit(lambda g, s, p: ref_opt.update(rcfg, g, s, p))(
            g, rstate, params)
        ours = opt_state_from_numpy(cfg, jax.tree.map(np.asarray, rstate))
        assert int(ours["count"]) == 1
        deq = ((lambda m: m[0].float() * m[1]) if moments == "int8"
               else (lambda m: m))
        for i in range(cfg.num_layers):
            for n, stacked in rstate["m"]["layers"].items():
                want = (np.asarray(stacked[0][i], np.float32) * np.asarray(stacked[1])
                        if moments == "int8" else np.asarray(stacked[i]))
                np.testing.assert_array_equal(_np(deq(ours["m"]["layers"][i][n])), want)
        port_params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params))
        ps, vs = tree.flatten(port_params), tree.flatten(ours["v"], opt.is_moment)
        assert [p for p, _ in ps] == [p for p, _ in vs]
        for (_, p), (_, m) in zip(ps, vs):
            assert p.shape == (m[0] if moments == "int8" else m).shape


def test_checkpoint_resume_matches_straight_run(tmp_path):
    kw = dict(global_batch=2, seq_len=16, lr=1e-3, schedule_steps=10,
              device="cpu")
    full = train("llama3.2-3b", steps=10, **kw)
    first = train("llama3.2-3b", steps=5, ckpt_dir=str(tmp_path), ckpt_every=5, **kw)
    rest = train("llama3.2-3b", steps=10, ckpt_dir=str(tmp_path), ckpt_every=5, **kw)
    assert len(first) == 5 and len(rest) == 5
    np.testing.assert_allclose(first + rest, full, rtol=1e-4)
    np.testing.assert_allclose(rest[-1], full[-1], rtol=1e-4)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_train_state_checkpoint_roundtrip(tmp_path, moments):
    """A TrainState (a dataclass) with bf16 params and fp32 or int8
    moments restores bitwise into a fresh model's state."""
    cfg = smoke_shrink(get_config("mamba2-130m"))
    ocfg = opt.OptimizerConfig(moment_dtype=moments)
    model = build_model(cfg, seed=1, device="cpu")
    state = init_state(model, ocfg)
    step = make_train_step(model, ocfg)
    ds = SyntheticTextDataset(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2)
    state, _ = step(state, ds.batch(0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    fresh = init_state(build_model(cfg, seed=2, device="cpu"), ocfg)
    restored = load_state(fresh, mgr.restore(fresh, device="cpu"))
    assert isinstance(restored, TrainState) and int(restored.step) == 1
    for a, b in zip(tree.leaves(restored.params), tree.leaves(state.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for key in ("m", "v"):
        for a, b in zip(tree.leaves(restored.opt[key], opt.is_moment),
                        tree.leaves(state.opt[key], opt.is_moment)):
            pairs = zip(a, b) if moments == "int8" else [(a, b)]
            for x, y in pairs:
                assert x.dtype == y.dtype and torch.equal(x, y)


def test_example_twin_registers_and_trains(monkeypatch):
    monkeypatch.setattr(configs, "ARCHS", dict(configs.ARCHS))
    cfg = train_lm.llama3_100m()
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == (
        6, 512, 8, 4, 64, 1536, 32000, True)
    losses = train_lm.main(["--steps", "3", "--device", "cpu"])
    assert train_lm.NAME in configs.ARCHS and len(losses) == 3
