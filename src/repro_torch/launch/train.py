"""Training driver, on one device or over the processes of a mesh.

The port's twin of the reference's ``repro.launch.train``: deterministic
resumable data, async atomic checkpoints with auto-resume from the
latest one, and a straggler watchdog (an EMA step-time monitor that
flags and logs slow steps; at cluster scale the hook that re-runs a
step's batch, which the deterministic pipeline makes safe).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 200 --ckpt-dir CKPT

The default device is the card; ``--device cpu`` runs the kernels' plain
versions on the host.  Without ``--full`` the model is the reference's
smoke shrink of the architecture.

``--mesh D M`` trains on a ("data", "model") mesh of D x M processes,
one per device, each started with the same arguments and its own
``--process-id`` (``gloo`` on the CPU, ``nccl`` on the cards, one
process per card):

    python -m repro_torch.launch.train --device cpu --mesh 2 1 \\
        --coordinator localhost:29500 --num-processes 2 --process-id 0

(and ``--process-id 1``).  Each rank takes its rows of the global batch
and steps its blocks of the state (``train.train_step.TrainLayout``,
the architecture's sharding recipe), computing as the reference's
recipe: each layer gathered over "data" inside its checkpointed block,
and for the decoder-only families (dense, MoE, the VLM backbone) the
heads, FFN columns and vocabulary split over "model"; the SSM, the
hybrid and the encoder-decoder run their products whole.  The launcher
logs which axes do what.  Checkpoints hold the whole state, so a run
resumes on any mesh.  A mesh of one process runs the same sharded step
on a one-rank group.
"""

from __future__ import annotations

import argparse
import math
import time

import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config, smoke_shrink
from ..core.executor import resolve_device
from ..data.pipeline import SyntheticTextDataset
from ..distributed.transport import init_multi_host
from ..models import build_model
from ..obs import log as obs_log
from ..train import optimizer as opt
from ..train.train_step import (
    TrainLayout,
    init_state,
    load_state,
    make_train_step,
)
from .mesh import _backend, make_host_mesh


class StragglerWatchdog:
    """EMA step-time monitor; at scale the callback re-enqueues the step's
    batch (safe: the pipeline is deterministic per step index)."""

    def __init__(self, threshold: float = 3.0, decay: float = 0.9):
        self.ema: float | None = None
        self.threshold = threshold
        self.decay = decay
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.threshold * self.ema
        self.ema = dt if self.ema is None else (
            self.decay * self.ema + (1 - self.decay) * dt
        )
        if slow:
            self.flagged.append(step)
        return slow


def train_dataset(cfg, seq_len: int, global_batch: int,
                  seed: int = 0) -> SyntheticTextDataset:
    """The reference trainer's dataset for ``cfg``: an ``embed_inputs``
    model (the VLM backbone) and an encoder-decoder also get
    stub-frontend embeddings of their width, and an M-RoPE model (3, B,
    S) positions."""
    return SyntheticTextDataset(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
        embed_dim=cfg.d_model if cfg.embed_inputs or cfg.is_encdec else 0,
        mrope=cfg.mrope)


def train_batch(cfg, ds: SyntheticTextDataset, step: int) -> dict:
    """Batch ``step`` as the reference's step takes it: without
    ``tokens`` for a decoder-only ``embed_inputs`` model, which reads
    ``embeds``; an encoder-decoder reads both, the embeds in its encoder
    and the tokens in its decoder."""
    batch = ds.batch(step)
    if cfg.embed_inputs and not cfg.is_encdec:
        del batch["tokens"]
    return batch


def train(
    arch: str,
    steps: int = 100,
    smoke: bool = True,
    global_batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    mesh_shape: tuple[int, ...] = (),
    log_every: int = 10,
    seed: int = 0,
    lr: float = 1e-3,
    schedule_steps: int | None = None,
    device="cuda",
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> list[float]:
    """Train ``arch`` for ``steps`` steps (resuming from the latest
    checkpoint in ``ckpt_dir``, if any); returns the loss of each step
    run, the global batch's.  Weights are drawn from ``seed`` on
    ``device``.

    With ``mesh_shape`` (("data", "model") sizes) the step is the sharded
    one on a live mesh of that many processes under the architecture's
    ``sharding_recipe``: this process joins the run through
    ``coordinator``, ``num_processes`` and ``process_id`` (or one already
    started), takes the card of its rank on ``"cuda"``, and leaves the
    run at the end if it joined it here.  ``()`` trains on one device
    without a mesh."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_shrink(cfg)
    joined, mesh = False, None
    if mesh_shape:
        joined = not dist.is_initialized()
        if coordinator is not None:
            init_multi_host(coordinator, num_processes, process_id,
                            _backend(dev.type))
        size = dist.get_world_size() if dist.is_initialized() else 1
        if size != math.prod(mesh_shape):
            raise ValueError(f"mesh {tuple(mesh_shape)} on a run of {size} "
                             "processes")
        # the mesh picks this process's card
        mesh = make_host_mesh(tuple(mesh_shape),
                              ("data", "model")[:len(mesh_shape)], dev.type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    try:
        return _train(cfg, steps, global_batch, seq_len, ckpt_dir,
                      ckpt_every, mesh, log_every, seed, lr,
                      schedule_steps, dev)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _train(cfg, steps, global_batch, seq_len, ckpt_dir, ckpt_every,
           mesh, log_every, seed, lr, schedule_steps, dev) -> list[float]:
    """:func:`train`'s loop on ``dev`` (the run joined and its ``mesh``
    made, if any)."""
    model = build_model(cfg, seed=seed, device=dev)
    sched = schedule_steps or steps
    ocfg = opt.OptimizerConfig(
        learning_rate=lr, warmup_steps=min(20, sched // 5 + 1),
        total_steps=sched,
    )
    ds = train_dataset(cfg, seq_len, global_batch, seed)
    layout = None
    if mesh is not None:
        layout = TrainLayout(model, ocfg, mesh, cfg.sharding_recipe)
        obs_log.info(f"sharded step: {layout.describe_compute()}",
                     compute_axes=layout.compute_axes)
    state = init_state(model, ocfg, layout)
    step_fn = make_train_step(model, ocfg, layout)
    # one process writes the checkpoints; every rank gathers the state
    writer = not dist.is_initialized() or dist.get_rank() == 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state = load_state(state, mgr.restore(state, device=dev), layout)
        start_step = int(state.step)
        obs_log.info(f"resumed from step {start_step}", step=start_step)

    def save(step, blocking=False):
        whole = state if layout is None else layout.gather(state)
        if writer:
            mgr.save(step, whole, blocking=blocking)

    dog = StragglerWatchdog()
    losses = []
    for step in range(start_step, steps):
        batch = train_batch(cfg, ds, step)
        if layout is not None:
            batch = layout.rows(batch)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step on the card
        dt = time.perf_counter() - t0
        if dog.observe(step, dt):
            obs_log.warning(
                f"[watchdog] step {step} slow: {dt:.2f}s (ema {dog.ema:.2f}s)",
                step=step, dt_s=dt, ema_s=dog.ema,
            )
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            obs_log.info(
                f"step {step:5d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms",
                step=step, loss=loss, dt_s=dt,
            )
        if mgr and (step + 1) % ckpt_every == 0:
            save(step + 1)
    if mgr:
        save(steps, blocking=True)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()  # no rank returns before the checkpoint is written
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, nargs="+", default=[],
                    help="(data, model) sizes of a mesh of processes")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    losses = train(
        args.arch,
        steps=args.steps,
        smoke=args.smoke,
        global_batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        lr=args.lr,
        device=args.device,
        mesh_shape=tuple(args.mesh),
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    obs_log.info(f"first loss {losses[0]:.4f} → last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
