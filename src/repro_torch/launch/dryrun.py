"""Dry run: every (architecture × input shape) cell on a production mesh,
built on the ``meta`` device, to per-rank bytes and a roofline bound.

The port's twin of the reference's ``repro.launch.dryrun``, which lowers
and compiles each cell on 512 fake XLA devices.  Here a cell is built
abstractly: the training state or parameters, the batch or cache, as
meta tensors of the declared shapes and dtypes (nothing allocated, no
model built, no forward pass), their logical axes resolved on the mesh
description under the cell's sharding recipe (``parallel.sharding``).
It records each rank's argument bytes, split into parameters, optimizer
state, inputs and cache, and the roofline on the H100 (``roofline``):
the analytic compute and memory terms, and the collective term from the
sharded step's own collectives on the cell's mesh, counted from the
resolved specs (``roofline.collectives``; a serving cell counts that
compute's forward).  What only a compiled program measures (temporaries,
code size, its FLOP count) is recorded as ``null`` with its reason under
``not_measured``, never as 0.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
        --shape train_4k --mesh multi --moments int8

writes ``build/dryrun/llama3-405b__train_4k__multi__mint8.json`` (the
reference's tag).  ``repro_torch.launch.sweep`` runs the whole matrix.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from .. import tree
from ..configs import SHAPES, cell_applicable, get_config
from ..models import param_defs
from ..models.params import abstract_params, count_params, param_specs
from ..obs import log as obs_log
from ..parallel.sharding import rank_bytes
from ..roofline.analysis import (
    active_param_count,
    analytic_roofline,
    model_flops,
)
from ..roofline.collectives import step_collectives
from ..train import optimizer as opt
from ..train.train_step import abstract_state, state_logical
from .mesh import make_production_mesh
from .specs import input_specs

NOT_MEASURED = {
    "memory.output_bytes": "the outputs' shardings are a compiled "
                           "program's choice",
    "memory.temp_bytes": "only a compiled program's buffer assignment "
                         "gives its temporaries",
    "memory.code_bytes": "no compiled program: the step is eager PyTorch "
                         "and hand-written kernels",
    "useful_ratio": "needs a compiled program's FLOP count; the roofline's "
                    "FLOPs are the analytic model's",
}


def _meta_leaves(*trees) -> int:
    """How many tensors ``trees`` hold; raises unless every one is on
    the meta device."""
    leaves = [x for t in trees for x in tree.leaves(t)]
    off = {str(x.device) for x in leaves} - {"meta"}
    if off:
        raise RuntimeError(f"the dry run made tensors on {sorted(off)}")
    return len(leaves)


def mesh_label(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def dryrun_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    moment_dtype: str = "float32",
    recipe: str | None = None,
) -> dict:
    """One cell's record (or ``{"arch", "shape", "skipped": reason}``
    where the reference skips it)."""
    cfg = get_config(arch)
    if recipe is None or recipe == "arch-default":
        recipe = cfg.sharding_recipe
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    defs = param_defs(cfg)
    n_params = count_params(defs)
    abs_in, log_in = input_specs(arch, shape_name)

    def nbytes(abstract, logical) -> int:
        return rank_bytes(abstract, logical, mesh, recipe)

    split = {"params": 0, "optimizer": 0, "inputs": 0, "cache": 0}
    if shape.kind == "train":
        ocfg = opt.OptimizerConfig(moment_dtype=moment_dtype)
        st_abs, st_log = abstract_state(cfg, ocfg), state_logical(cfg, ocfg)
        split["params"] = nbytes(st_abs.params, st_log.params)
        split["optimizer"] = nbytes([st_abs.opt, st_abs.step],
                                    [st_log.opt, st_log.step])
        trees = (st_abs, abs_in)
    else:
        p_abs = abstract_params(defs)
        split["params"] = nbytes(p_abs, param_specs(defs))
        trees = (p_abs, abs_in)
    if shape.kind == "decode":
        split["cache"] = nbytes(abs_in["cache"], log_in["cache"])
        rest = [k for k in abs_in if k != "cache"]
        split["inputs"] = nbytes([abs_in[k] for k in rest],
                                 [log_in[k] for k in rest])
    else:
        split["inputs"] = nbytes(abs_in, log_in)
    n_meta = _meta_leaves(*trees)
    build_s = time.perf_counter() - t0

    coll = step_collectives(cfg, mesh, recipe, shape.global_batch,
                            shape.seq_len, shape.kind, moment_dtype)
    roof = analytic_roofline(cfg, shape, n_params, mesh.size, coll)
    n_active = active_param_count(cfg, n_params)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_label(multi_pod),
        "n_devices": mesh.size,
        "kind": shape.kind,
        "params": n_params,
        "active_params": n_active,
        "moment_dtype": moment_dtype,
        "recipe": recipe,
        "build_s": build_s,
        "meta_tensors": n_meta,
        "memory": {
            "argument_bytes": sum(split.values()),
            "argument_split": split,
            "output_bytes": None,
            "temp_bytes": None,
            "code_bytes": None,
        },
        "roofline": roof.summary(),
        "model_flops_global": model_flops(cfg, shape, n_active),
        "useful_ratio": None,
        "not_measured": NOT_MEASURED,
    }


def cell_tag(arch: str, shape: str, mesh: str, moments: str = "float32",
             recipe: str = "arch-default") -> str:
    """The reference's file name of a cell's record (without ``.json``)."""
    tag = f"{arch}__{shape}__{mesh}"
    if moments != "float32":
        tag += f"__m{moments}"
    if recipe not in ("default", "arch-default"):
        tag += f"__r{recipe}"
    return tag


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--moments", default="float32", choices=["float32", "int8"])
    ap.add_argument("--recipe", default="arch-default")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    tag = cell_tag(args.arch, args.shape, args.mesh, args.moments, args.recipe)
    path = os.path.join(args.out, tag + ".json")
    try:
        res = dryrun_cell(args.arch, args.shape,
                          multi_pod=(args.mesh == "multi"),
                          moment_dtype=args.moments, recipe=args.recipe)
    except Exception as e:  # the record says why the cell failed
        res = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "error": repr(e),
               "traceback": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    if "error" in res:
        obs_log.error(f"FAIL {tag}: {res['error']}", tag=tag)
        return 1
    if "skipped" in res:
        obs_log.info(f"SKIP {tag}: {res['skipped']}", tag=tag)
        return 0
    r, m = res["roofline"], res["memory"]["argument_split"]
    obs_log.info(
        f"OK {tag}: per rank params={m['params']} optimizer={m['optimizer']} "
        f"inputs={m['inputs']} cache={m['cache']} bytes; "
        f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
        f"collective={r['collective_s']:.3e}s "
        f"dominant={r['dominant']} bound={r['bound_s']:.3e}s",
        tag=tag)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
