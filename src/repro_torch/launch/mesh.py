"""Mesh descriptions and live meshes.

The port's twin of the reference's ``repro.launch.mesh``.  A mesh is
used two ways:

  * as a description (:class:`MeshShape`: axis names and sizes), which
    is all the sharding layer reads (``parallel.sharding.resolve_spec``):
    the dry run resolves every cell on the production meshes,
    :func:`make_production_mesh`'s 16 x 16 ("data", "model") and
    2 x 16 x 16 ("pod", "data", "model"), with no device at all;
  * live, as a ``torch.distributed`` device mesh over the processes of a
    run (:func:`make_host_mesh`, :func:`multi_host_mesh`), one process
    per device: ``gloo`` processes on the CPU, ``nccl`` on the cards.

    PYTHONPATH=src python -m repro_torch.launch.mesh --device cpu \\
        --coordinator localhost:29500 --num-processes 2 --process-id 0

(and ``--process-id 1`` in a second process) prints each process's view
and proves a cross-process sum round-trips.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no device behind it."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.sizes} for axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def label(self) -> str:
        return "x".join(map(str, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data",
    "model") with ``multi_pod``."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_host_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                   device_type: str = "cuda"):
    """A live ``DeviceMesh`` of ``shape`` over the processes of the
    ``torch.distributed`` run (its world size must be the product of
    ``shape``).  One process needs no run: a one-rank group is made in
    process.  ``device_type`` is ``"cuda"`` (``nccl``; each process
    takes the card of its rank, one process per card) or ``"cpu"``
    (``gloo``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a mesh of {tuple(shape)} needs a run of {math.prod(shape)} "
                "processes: call distributed.init_multi_host first")
        dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                                rank=0, world_size=1)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def multi_host_mesh(axis_name: str = "data", device_type: str = "cuda"):
    """One flat live mesh over every process of the run: the
    data-parallel axis the multi-host transport reduces over.  Call
    :func:`repro_torch.distributed.init_multi_host` first in an
    N-process launch; at world size 1 it is a one-device mesh, so the
    same code serves both."""
    import torch.distributed as dist

    size = dist.get_world_size() if dist.is_initialized() else 1
    return make_host_mesh((size,), (axis_name,), device_type)


def main(argv=None) -> int:
    """Print this process's view of the run and prove that a
    cross-process sum round-trips through the mesh's group (run as N
    plain processes with ``--coordinator``, ``--num-processes`` and
    ``--process-id``; no launcher needed)."""
    import argparse

    import torch
    import torch.distributed as dist

    from ..distributed.transport import CollectiveTransport, init_multi_host

    p = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    rank, size = init_multi_host(args.coordinator, args.num_processes,
                                 args.process_id, _backend(args.device))
    mesh = multi_host_mesh(device_type=args.device)  # picks the card
    tp = CollectiveTransport(chunks=1, group=mesh.get_group())
    tp.push(torch.tensor([float(rank + 1)]))
    total = tp.finalize()
    expect = size * (size + 1) / 2
    ok = total is not None and float(total[0]) == expect
    print(f"mesh-smoke rank={rank}/{size} devices={mesh.size()} "
          f"psum={float(total[0]) if total is not None else None} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
