"""Training driver on one device.

The port's twin of the reference's ``repro.launch.train``: deterministic
resumable data, async atomic checkpoints with auto-resume from the
latest one, and a straggler watchdog (an EMA step-time monitor that
flags and logs slow steps; at cluster scale the hook that re-runs a
step's batch, which the deterministic pipeline makes safe).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 200 --ckpt-dir CKPT

The default device is the card; ``--device cpu`` runs the kernels' plain
versions on the host.  Without ``--full`` the model is the reference's
smoke shrink of the architecture.  One device only: a mesh of several
(the reference's sharded jit) waits for training over several processes,
ROADMAP.md queue 1 item 11.6.3 (the specs it needs are
``parallel.sharding``'s).
"""

from __future__ import annotations

import argparse
import math
import time

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config, smoke_shrink
from ..core.executor import resolve_device
from ..data.pipeline import SyntheticTextDataset
from ..models import build_model
from ..obs import log as obs_log
from ..train import optimizer as opt
from ..train.train_step import init_state, load_state, make_train_step


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
) -> list[float]:
    """Train ``arch`` for ``steps`` steps (resuming from the latest
    checkpoint in ``ckpt_dir``, if any); returns the loss of each step
    run.  Weights are drawn from ``seed`` on ``device``."""
    if math.prod(mesh_shape) > 1:
        raise NotImplementedError(
            f"mesh {tuple(mesh_shape)}: training on more than one device "
            "needs training over several processes (ROADMAP.md, queue 1 "
            "item 11.6.3)"
        )
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_shrink(cfg)
    model = build_model(cfg, seed=seed, device=dev)
    sched = schedule_steps or steps
    ocfg = opt.OptimizerConfig(
        learning_rate=lr, warmup_steps=min(20, sched // 5 + 1),
        total_steps=sched,
    )
    ds = train_dataset(cfg, seq_len, global_batch, seed)
    state = init_state(model, ocfg)
    step_fn = make_train_step(model, ocfg)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state = load_state(state, mgr.restore(state, device=dev))
        start_step = int(state.step)
        obs_log.info(f"resumed from step {start_step}", step=start_step)

    dog = StragglerWatchdog()
    losses = []
    for step in range(start_step, steps):
        batch = train_batch(cfg, ds, step)
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
            mgr.save(step + 1, state)
    if mgr:
        mgr.save(steps, state, blocking=True)
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
    )
    obs_log.info(f"first loss {losses[0]:.4f} → last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
