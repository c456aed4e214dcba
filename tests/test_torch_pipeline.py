"""The port's GPipe pipeline (``parallel/pipeline.py``) and the live
placement of the sharding layer (``parallel.sharding.Placement``).

The pipeline runs on 2 and 4 ``gloo`` processes (plain subprocesses on
a free port, each ``communicate`` under a timeout) and is held against
the reference's ``pipeline_forward`` on the same numpy inputs, run in a
subprocess with 4 forced XLA host devices, with the reference test's
``tanh(x @ w + b)`` layer: the output within 1e-6 of max|out|, every
gradient within 1e-5 of its tensor's max|grad| (each stage's layers get
theirs on that stage's rank, the others zero).  At world size 1 it is
the layer stack applied to each microbatch, bit for bit.  The placement
cuts each rank's block as ``local_shape`` says, gathers the whole tensor
back exactly and reduces a gradient to the mean over the batch axes, on
2 and 4 processes; on one rank all three return the tensor they were
given (same storage).

This file imports no JAX (the reference runs in its subprocess), so its
card case (``-m cuda``) runs where JAX is absent.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_forward  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    Placement,
    describe,
    local_shape,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL = 1e-6  # of max|out|
GRAD_TOL = 1e-5  # of each tensor's max|grad|
L, D, N_MICRO, MB = 8, 16, 6, 4
BUBBLES = [(8, 2), (1, 4), (6, 2), (6, 4), (3, 1)]


def _inputs():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(L, D, D)).astype(np.float32) * 0.3,
            rng.normal(size=(L, D)).astype(np.float32) * 0.1,
            rng.normal(size=(N_MICRO, MB, D)).astype(np.float32))


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def start_gloo(script: str, n: int, *args: str) -> list:
    """Start ``script`` as ``n`` plain processes of one ``gloo`` run on a
    free port, each given ``rank n port *args``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return [subprocess.Popen([sys.executable, "-c", script, str(r), str(n),
                              port, *args], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env,
                             cwd=REPO) for r in range(n)]


def collect(procs: list, timeout: float = 240) -> list[dict]:
    """Each process's ``OUT``-prefixed JSON line, by rank; every process
    killed if one fails or outlives ``timeout``."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for rc, out, err in outs:
        assert rc == 0, err[-4000:]
        recs.append(json.loads(next(line for line in out.splitlines()
                                    if line.startswith("OUT"))[3:]))
    return recs


# the reference's pipeline on 4 forced host devices: 2 stages on a
# (2, 2) ("pod", "data") mesh, 4 on (4, 1); its outputs, gradients (of
# sum(out²), the reference test's loss) and bubble fractions
REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_host_mesh
from repro.parallel.pipeline import bubble_fraction, pipeline_forward
w, b, x = (jnp.asarray(np.load(sys.argv[1])[k]) for k in ("w", "b", "x"))
def layer_apply(lp, h):
    return jnp.tanh(h @ lp["w"] + lp["b"])
out = {"bubbles": [bubble_fraction(m, s) for m, s in json.loads(sys.argv[3])]}
for P in (2, 4):
    mesh = make_host_mesh((P, 4 // P), ("pod", "data"))
    f = lambda p: pipeline_forward(layer_apply, p, x, mesh, axis="pod")
    y = jax.jit(f)({"w": w, "b": b})
    g = jax.jit(jax.grad(lambda p: jnp.sum(f(p) ** 2)))({"w": w, "b": b})
    out[P] = {"out": np.asarray(y).tolist(), "w": np.asarray(g["w"]).tolist(),
              "b": np.asarray(g["b"]).tolist()}
with open(sys.argv[2], "w") as fh:
    json.dump(out, fh)
print("DONE")
"""

# one rank of the port's pipeline over "pod" of a (n, 1) mesh, then the
# placement's block, gather and reduce on a ("data", "model") mesh of
# (2, n // 2)
WORKER = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, n, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=n, rank=rank)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.pipeline import pipeline_forward
from repro_torch.parallel.sharding import Placement, describe, local_shape
z = np.load(path)
w = torch.tensor(z["w"], requires_grad=True)
b = torch.tensor(z["b"], requires_grad=True)
x = torch.tensor(z["x"])
mesh = make_host_mesh((n, 1), ("pod", "data"), "cpu")
out = pipeline_forward(lambda lp, h: torch.tanh(h @ lp["w"] + lp["b"]),
                       {"w": w, "b": b}, x, mesh, axis="pod")
torch.sum(out ** 2).backward()
rec = {"rank": rank, "out": out.tolist(), "w": w.grad.tolist(),
       "b": b.grad.tolist()}
mesh = make_host_mesh((2, n // 2), ("data", "model"), "cpu")
full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
places = []
for spec in (("data", None), (None, "model"), (("data", "model"), None),
             ("model", "data"), (None, None)):
    pl = Placement(mesh, spec)
    blk = pl.block(full)
    grad = full * (1 + mesh.get_local_rank("data")) + mesh.get_local_rank("model")
    red = pl.reduce(grad.clone(), ("data",))
    places.append({"spec": spec, "block": blk.tolist(),
                   "want_shape": local_shape((8, 12), spec, describe(mesh)),
                   "gathered": torch.equal(pl.gather(blk), full),
                   "reduced": red.tolist(),
                   "model_rank": mesh.get_local_rank("model"),
                   "data_rank": mesh.get_local_rank("data")})
rec["places"] = places
print("OUT" + json.dumps(rec))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 2- and 4-process runs,
    started together."""
    d = tmp_path_factory.mktemp("pipeline")
    w, b, x = _inputs()
    np.savez(d / "in.npz", w=w, b=b, x=x)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, str(d / "in.npz"), str(d / "ref.json"),
         json.dumps(BUBBLES)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO)
    procs = {n: start_gloo(WORKER, n, str(d / "in.npz")) for n in (2, 4)}
    got = {n: collect(p) for n, p in procs.items()}
    try:
        out, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "DONE" in out, err[-4000:]
    with open(d / "ref.json") as fh:
        want = json.load(fh)
    return got, want


def test_bubble_fraction_matches_reference(runs):
    _, want = runs
    assert [bubble_fraction(m, s) for m, s in BUBBLES] == want["bubbles"]
    assert bubble_fraction(8, 2) == 1 / 9 and bubble_fraction(3, 1) == 0


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_output_matches_reference(runs, n):
    got, want = runs
    ref = np.asarray(want[str(n)]["out"])
    for rec in got[n]:
        err = np.abs(np.asarray(rec["out"]) - ref).max()
        assert err <= OUT_TOL * np.abs(ref).max(), (rec["rank"], err)


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_gradients_match_reference(runs, n):
    """Each rank holds its stage's layers' gradients, equal to the
    reference's (not n times them), and zero for the other layers."""
    got, want = runs
    per = L // n
    for key in ("w", "b"):
        ref = np.asarray(want[str(n)][key])
        total = np.zeros_like(ref)
        for rec in got[n]:
            g = np.asarray(rec[key])
            mine = slice(rec["rank"] * per, (rec["rank"] + 1) * per)
            others = np.delete(g, np.arange(L)[mine], axis=0)
            assert not others.any(), (key, rec["rank"])
            total[mine] = g[mine]
        err = np.abs(total - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (key, err)


@pytest.mark.parametrize("n", [2, 4])
def test_placement_round_trips_over_processes(runs, n):
    """On a (2, n/2) ("data", "model") mesh: each block has
    ``local_shape``'s shape and is the slice a dimension split over its
    axes (a tuple's first the slowest) gives; the gather restores the
    whole tensor exactly; the reduce is this rank's block of the mean
    over "data"."""
    got, _ = runs
    full = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    sizes = {"data": 2, "model": n // 2}
    for rec in got[n]:
        for pl in rec["places"]:
            ranks = {"data": pl["data_rank"], "model": pl["model_rank"]}

            def cut(a):
                for dim, entry in enumerate(pl["spec"]):
                    axes = () if entry is None else (
                        (entry,) if isinstance(entry, str) else tuple(entry))
                    k, i = 1, 0
                    for ax in axes:
                        k, i = k * sizes[ax], i * sizes[ax] + ranks[ax]
                    size = a.shape[dim] // k
                    a = np.take(a, np.arange(i * size, (i + 1) * size),
                                axis=dim)
                return a

            blk = np.asarray(pl["block"])
            assert blk.shape == tuple(pl["want_shape"]), pl["spec"]
            np.testing.assert_array_equal(blk, cut(full))
            assert pl["gathered"], pl["spec"]
            # "data" ranks 0 and 1 hold full·1 + m and full·2 + m (m the
            # "model" rank): their mean is full·1.5 + m
            np.testing.assert_array_equal(np.asarray(pl["reduced"]),
                                          cut(full * 1.5 + ranks["model"]))


@pytest.fixture
def one_rank():
    """A one-rank ``gloo`` run for the test (left as it was found)."""
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield
    if started:
        dist.destroy_process_group()


def test_placement_is_the_identity_on_one_rank(one_rank):
    mesh = make_host_mesh((1, 1), ("data", "model"), "cpu")
    t = torch.randn(4, 6)
    for spec in (("data", "model"), (("data", "model"), None), (None, None)):
        pl = Placement(mesh, spec)
        assert local_shape(tuple(t.shape), spec, describe(mesh)) == (4, 6)
        assert pl.block(t) is t and pl.gather(t) is t
        assert pl.reduce(t, ("data",)).data_ptr() == t.data_ptr()
        assert pl.counted and pl.split_axes == ()


def _sequential(f, layers, x):
    out = []
    for m in range(x.shape[0]):
        h = x[m]
        for lp in layers:
            h = f(lp, h)
        out.append(h)
    return torch.stack(out)


@pytest.mark.parametrize("stacked", [True, False])
def test_pipeline_on_one_rank_is_the_stack_bitwise(one_rank, stacked):
    """A one-rank "pod" axis: the output and every gradient equal the
    sequential stack's bit for bit, for stacked parameters (the
    reference's layout) and a list of layers (the port's models')."""
    mesh = make_host_mesh((1,), ("pod",), "cpu")
    w, b, x = (torch.from_numpy(a) for a in _inputs())

    def f(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])

    def params():
        if stacked:
            return {"w": w.clone().requires_grad_(),
                    "b": b.clone().requires_grad_()}
        return [{"w": w[i].clone().requires_grad_(),
                 "b": b[i].clone().requires_grad_()} for i in range(L)]

    p_pipe, p_seq = params(), params()
    got = pipeline_forward(f, p_pipe, x, mesh, axis="pod")
    layers = ([{"w": p_seq["w"][i], "b": p_seq["b"][i]} for i in range(L)]
              if stacked else p_seq)
    want = _sequential(f, layers, x)
    assert torch.equal(got, want)
    torch.sum(got ** 2).backward()
    torch.sum(want ** 2).backward()
    leaves = (lambda p: [p["w"], p["b"]]) if stacked else (
        lambda p: [t for lp in p for t in (lp["w"], lp["b"])])
    for a, c in zip(leaves(p_pipe), leaves(p_seq)):
        assert torch.equal(a.grad, c.grad)


@pytest.mark.cuda
def test_pipeline_on_card_is_the_layer_stack_bitwise():
    """The smoke's ``pipeline`` check on the card: two decoder layers of
    qwen3-4b's published widths through ``pipeline_forward`` on a
    one-rank ``nccl`` mesh, 4 microbatches of 1 x 512 (K4 forward and
    backward): output and gradients equal the layer stack's, bitwise."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    started = not dist.is_initialized()
    mesh = make_host_mesh((1,), ("pod",), "cuda")
    try:
        cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2)
        model = build_model(cfg, seed=0, device="cuda").train_mode(True)
        S = 512
        pos = torch.arange(S, device="cuda").expand(1, S)
        x = torch.randn(4, 1, S, cfg.d_model, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0)
                        ).to(torch.bfloat16)

        def f(p, h):
            return model._block(p, h, pos, False, None)[0]

        layers = [lp.tensors() for lp in model.layers]
        fa.reset_launches()
        got = pipeline_forward(f, layers, x, mesh, axis="pod")
        got.float().square().sum().backward()
        g_pipe = [t.grad.clone() for lp in layers for t in lp.values()]
        assert fa.LAUNCHES["flash_attention"] >= 8
        assert fa.LAUNCHES["flash_attention_bwd"] >= 8
        for lp in layers:
            for t in lp.values():
                t.grad = None
        want = _sequential(f, layers, x)
        want.float().square().sum().backward()
        assert torch.equal(got, want)
        for a, lp in zip(g_pipe, [t for lp in layers for t in lp.values()]):
            assert torch.equal(a, lp.grad)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
