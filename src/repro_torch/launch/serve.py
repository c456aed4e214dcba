"""Contraction-serving CLI: fire a mixed tenant burst at the engine.

Launch script for :class:`repro_torch.engine.server.EngineServer`.
Submits a burst of amplitude requests (bitstrings varying on the last
``--vary`` qubits, so the server can coalesce them into open-qubit batch
contractions) plus a few correlated-sampling tenants against one circuit
family, then prints per-burst latencies and the server's coalescing
counters.  The second burst of a run is the warm path: the family's plan
is cached, so it shows what the plan cache buys.

    PYTHONPATH=src python -m repro_torch.launch.serve --rows 3 --cols 3 \
        --cycles 8 --amps 12 --samples 2 --target-dim 12 [--device cpu]

Contractions run on ``--device`` (default ``cuda``; with no GPU it fails
unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..engine import AmplitudeRequest, EngineServer, SampleRequest
from ..obs import log as obs_log
from ..quantum.circuits import sycamore_like


def _burst(
    srv: EngineServer,
    circuit,
    n_amps: int,
    n_samples: int,
    target_dim: int,
    vary: int,
    seed: int = 0,
):
    """Submit one mixed burst and wait for every ticket."""
    n = circuit.num_qubits
    rng = np.random.default_rng(seed)
    tickets = []
    for _ in range(n_amps):
        tail = rng.integers(0, 2, size=min(vary, n))
        bits = ["0"] * n
        for j, b in enumerate(tail):
            bits[n - len(tail) + j] = str(int(b))
        tickets.append(
            srv.submit(
                AmplitudeRequest(circuit, "".join(bits), target_dim=target_dim)
            )
        )
    for i in range(n_samples):
        tickets.append(
            srv.submit(
                SampleRequest(
                    circuit, num_samples=256, target_dim=target_dim,
                    seed=seed + i,
                )
            )
        )
    t0 = time.perf_counter()
    for t in tickets:
        t.result(timeout=600)
    wall = time.perf_counter() - t0
    return tickets, wall


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serve amplitude/sampling traffic on the engine"
    )
    ap.add_argument("--rows", type=int, default=3)
    ap.add_argument("--cols", type=int, default=3)
    ap.add_argument("--cycles", type=int, default=8)
    ap.add_argument("--target-dim", type=int, default=12)
    ap.add_argument("--amps", type=int, default=12,
                    help="amplitude requests per burst")
    ap.add_argument("--samples", type=int, default=2,
                    help="sampling requests per burst")
    ap.add_argument("--vary", type=int, default=4,
                    help="qubits the amplitude bitstrings vary on")
    ap.add_argument("--bursts", type=int, default=2,
                    help="bursts to fire (first is cold, rest warm)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where contractions run (cuda or cpu)")
    args = ap.parse_args(argv)

    circuit = sycamore_like(args.rows, args.cols, args.cycles, seed=args.seed)
    with EngineServer(
        max_queue=args.max_queue,
        max_batch=args.max_batch,
        max_open=max(1, args.vary),
        device=args.device,
    ) as srv:
        for burst in range(args.bursts):
            tickets, wall = _burst(
                srv, circuit, args.amps, args.samples,
                args.target_dim, args.vary, seed=args.seed + burst,
            )
            lat = sorted(t.total_s for t in tickets)
            obs_log.info(
                f"burst {burst} ({'cold' if burst == 0 else 'warm'}): "
                f"{len(tickets)} requests in {wall:.2f}s "
                f"({len(tickets)/max(wall, 1e-9):.1f} req/s), "
                f"p50 {lat[len(lat)//2]*1e3:.0f} ms, "
                f"max {lat[-1]*1e3:.0f} ms",
                burst=burst, wall_s=wall,
            )
        st = srv.stats()
    obs_log.info(
        f"served {st['completed']} ok / {st['failed']} failed / "
        f"{st['rejected']} rejected; {st['coalesced']} coalesced over "
        f"{st['groups']} groups ({st['warm_families']} warm families) "
        f"on {srv.device}",
        **{k: st[k] for k in ("completed", "coalesced", "groups")},
    )


if __name__ == "__main__":
    main()
