"""The port's dry run held against the JAX package: the cell matrix and
its skips, per-rank argument bytes against the bytes the reference's own
specs and shapes give, every tensor on the meta device, the command
line's file name and keys, the sweep's cache, and the mesh smoke as two
``gloo`` processes.

The reference compiles each cell on 512 fake XLA devices; the port builds
it on the ``meta`` device and resolves the reference's specs on a mesh
description, so its bytes are held to the reference's ``resolve_spec``
(given a stand-in mesh) and its abstract shapes, with the shard shapes
worked out by division.  The one difference is stated exactly: an int8
moment's fp32 scale is per stacked tensor in the reference, per layer
tensor in the port, so the port holds 4 bytes more for each layer but
the first of each stacked tensor, for each of the two moments.
"""

import json
import math
import socket
import subprocess
import sys
import types

import jax
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import all_cells as ref_all_cells  # noqa: E402
from repro.configs import cell_applicable as ref_cell_applicable  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.specs import input_specs as ref_input_specs  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.parallel import sharding as ref_sh  # noqa: E402
from repro.roofline.analysis import Roofline as RefRoofline  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import abstract_state as ref_abstract_state  # noqa: E402
from repro.train.train_step import state_logical as ref_state_logical  # noqa: E402

from conftest import subprocess_kwargs  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, all_cells, get_config  # noqa: E402
from repro_torch.interop import _stacks  # noqa: E402
from repro_torch.launch import dryrun, sweep  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

MESHES = (False, True)  # single pod 16 x 16, multi-pod 2 x 16 x 16


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _ref_bytes(abstract, logical, mesh, recipe) -> int:
    """Per-rank bytes of a reference tree: its ``resolve_spec`` on each
    leaf's shape, each dimension divided by its mesh axes' product."""
    logs = jax.tree.flatten(logical, is_leaf=_is_logical)[0]
    abss = jax.tree.leaves(abstract)
    assert len(logs) == len(abss)
    total = 0
    for log, a in zip(logs, abss):
        spec = tuple(ref_sh.resolve_spec(log, mesh, a.shape, recipe))
        local = 1
        for i, dim in enumerate(a.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n = math.prod(mesh.shape[x] for x in axes)
            assert dim % n == 0
            local *= dim // n
        total += local * a.dtype.itemsize
    return total


def _stand_in(multi_pod: bool):
    m = make_production_mesh(multi_pod=multi_pod)
    return types.SimpleNamespace(axis_names=m.axis_names, shape=m.shape)


def test_all_cells_match_reference():
    assert all_cells() == ref_all_cells()
    assert len(all_cells()) == 40
    assert sum(not ok for _, _, ok, _ in all_cells()) == 8


class _Devices(TorchDispatchMode):
    """Records the device of every tensor any operation returns."""

    def __init__(self):
        super().__init__()
        self.devices: set[str] = set()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        self.devices |= {str(t.device) for t in tree.leaves(out)
                         if isinstance(t, torch.Tensor)}
        return out


@pytest.mark.parametrize("multi_pod", MESHES)
def test_dryrun_matrix_records_and_skips(multi_pod):
    """Every (arch, shape) cell on one production mesh: 32 records and 8
    skips, the skips exactly the reference's, with its reasons; every
    tensor any operation made on the way is on the meta device."""
    mode = _Devices()
    records = skips = 0
    with mode:
        for arch in ARCHS:
            for shape in SHAPES:
                rec = dryrun.dryrun_cell(arch, shape, multi_pod=multi_pod)
                ok, why = ref_cell_applicable(ref_get_config(arch),
                                              REF_SHAPES[shape])
                if not ok:
                    assert rec == {"arch": arch, "shape": shape,
                                   "skipped": why}
                    skips += 1
                    continue
                records += 1
                assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
                assert rec["n_devices"] == (512 if multi_pod else 256)
                assert rec["meta_tensors"] > 0
                assert rec["recipe"] == get_config(arch).sharding_recipe
                r = rec["roofline"]
                assert r["bound_s"] == max(r["compute_s"], r["memory_s"],
                                           r["collective_s"]) > 0
                assert r["collective_s"] == sum(
                    r["collective_bytes_per_device"].values()) / 450e9
                assert rec["useful_ratio"] is None
    assert (records, skips) == (32, 8)
    assert mode.devices == {"meta"} and mode.ops > 0


def _int8_extra(cfg, ref_defs) -> int:
    """The port's int8 scales beyond the reference's: one 4-byte scale
    per layer of each stacked tensor, not one per stacked tensor, for m
    and for v."""
    extra = 0
    for key, axes, _ in _stacks(cfg):
        for d in ref_defs[key].values():
            extra += math.prod(d.shape[:len(axes)]) - 1
    return 2 * 4 * extra


@pytest.mark.parametrize("arch", list(ARCHS))
def test_argument_bytes_match_reference(arch):
    """Per-rank parameter, optimizer, input and cache bytes of every
    applicable cell on both meshes (train cells with fp32 and int8
    moments) against the reference's abstract trees and specs."""
    cfg = get_config(arch)
    ref_model = ref_build_model(ref_get_config(arch))
    ref_defs = ref_model.param_defs()
    recipe = cfg.sharding_recipe
    for multi_pod in MESHES:
        mesh = _stand_in(multi_pod)
        for shape, cell in SHAPES.items():
            if not ref_cell_applicable(ref_get_config(arch),
                                       REF_SHAPES[shape])[0]:
                continue
            ref_in, ref_log = ref_input_specs(arch, shape)
            moments = ("float32", "int8") if cell.kind == "train" else (
                "float32",)
            for moment in moments:
                rec = dryrun.dryrun_cell(arch, shape, multi_pod, moment)
                split = rec["memory"]["argument_split"]
                assert rec["memory"]["argument_bytes"] == sum(split.values())
                if cell.kind == "train":
                    rcfg = ref_opt.OptimizerConfig(moment_dtype=moment)
                    st = ref_abstract_state(ref_model, rcfg)
                    log = ref_state_logical(ref_model, rcfg)
                    want_p = _ref_bytes(st.params, log.params, mesh, recipe)
                    want_o = _ref_bytes([st.opt, st.step], [log.opt, log.step],
                                        mesh, recipe)
                    if moment == "int8":
                        want_o += _int8_extra(cfg, ref_defs)
                    want_in = _ref_bytes(ref_in, ref_log, mesh, recipe)
                    want_c = 0
                else:
                    want_p = _ref_bytes(ref_sh.abstract_params(ref_defs),
                                        ref_sh.param_specs(ref_defs), mesh,
                                        recipe)
                    want_o = 0
                    if cell.kind == "decode":
                        want_c = _ref_bytes(ref_in["cache"], ref_log["cache"],
                                            mesh, recipe)
                        rest = [k for k in ref_in if k != "cache"]
                        want_in = _ref_bytes([ref_in[k] for k in rest],
                                             [ref_log[k] for k in rest], mesh,
                                             recipe)
                    else:
                        want_in = _ref_bytes(ref_in, ref_log, mesh, recipe)
                        want_c = 0
                assert split == {"params": want_p, "optimizer": want_o,
                                 "inputs": want_in, "cache": want_c}, (
                    shape, multi_pod, moment)


# the reference's record keys that mean something without a compiled
# program, and its roofline summary's keys
KEYS = {"arch", "shape", "mesh", "n_devices", "kind", "params",
        "active_params", "moment_dtype", "recipe", "memory", "roofline",
        "model_flops_global", "useful_ratio"}
# the process's own peak (VmHWM): its ru_maxrss would also hold the
# peak of the test process that started it, which the kernel carries
# across the exec
CLI = r"""
import sys
from repro_torch.launch.dryrun import main
rc = main(sys.argv[1:])
with open("/proc/self/status") as fh:
    print("maxrss_kb", next(int(line.split()[1]) for line in fh
                            if line.startswith("VmHWM:")))
sys.exit(rc)
"""


def test_cli_writes_reference_tag_and_keys(tmp_path):
    """llama3-405b at train_4k on the multi-pod mesh with int8 moments
    (405.85 B parameters, 811.7 GB in bf16) written from a process that
    never holds 2 GB; a skipped cell writes its reason."""
    args = ["--arch", "llama3-405b", "--shape", "train_4k", "--mesh",
            "multi", "--moments", "int8", "--out", str(tmp_path)]
    r = subprocess.run([sys.executable, "-c", CLI, *args],
                       capture_output=True, text=True, timeout=300,
                       **subprocess_kwargs())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "OK llama3-405b__train_4k__multi__mint8" in r.stdout
    maxrss = int(r.stdout.split("maxrss_kb")[1].split()[0]) * 1024
    assert maxrss < 2 << 30, maxrss
    rec = json.loads((tmp_path / "llama3-405b__train_4k__multi__mint8.json")
                     .read_text())
    assert KEYS <= set(rec)
    assert (rec["params"], rec["n_devices"], rec["moment_dtype"]) == (
        405_853_388_800, 512, "int8")
    assert set(rec["roofline"]) == set(RefRoofline(1.0, 1.0, {}, 1).summary())
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "code_bytes"} <= set(mem)
    assert rec["roofline"]["collective_s"] > 0
    for key in ("memory.output_bytes", "memory.temp_bytes",
                "memory.code_bytes", "useful_ratio"):
        section, _, name = key.rpartition(".")
        assert (rec[section] if section else rec)[name] is None, key
        assert rec["not_measured"][key], key
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                        "--recipe", "fsdp_only", "--out", str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "qwen3-4b__long_500k__single__rfsdp_only"
                          ".json").read_text())
    assert skipped["skipped"] == ref_cell_applicable(
        ref_get_config("qwen3-4b"), REF_SHAPES["long_500k"])[1]


def test_sweep_skips_recorded_cells(tmp_path):
    """Two cells, one process each (one recorded, one skipped); run
    again, both are read from their records and none is run."""
    first = sweep.sweep(str(tmp_path), meshes=("single",),
                        archs=["mamba2-130m", "llama3.2-3b"],
                        shapes=["long_500k"])
    assert first == {"ok": 2, "fail": 0, "cached": 0}
    assert json.loads((tmp_path / "llama3.2-3b__long_500k__single.json")
                      .read_text())["skipped"]
    assert json.loads((tmp_path / "mamba2-130m__long_500k__single.json")
                      .read_text())["recipe"] == "dp_only"
    again = sweep.sweep(str(tmp_path), meshes=("single",),
                        archs=["mamba2-130m", "llama3.2-3b"],
                        shapes=["long_500k"])
    assert again == {"ok": 0, "fail": 0, "cached": 2}
    assert sweep.ORDER[-1] == "llama3-405b" and set(sweep.ORDER) == set(ARCHS)
    assert sweep.SHAPES == list(SHAPES)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_mesh_smoke_two_gloo_processes():
    """``python -m repro_torch.launch.mesh`` as two ``gloo`` processes on
    the CPU: each sees a mesh of 2 and the sum 1 + 2 comes back; alone,
    a one-process mesh sums to 1."""
    cmd = [sys.executable, "-m", "repro_torch.launch.mesh", "--device", "cpu"]
    port = _free_port()
    procs = [subprocess.Popen(
        cmd + ["--coordinator", f"localhost:{port}", "--num-processes", "2",
               "--process-id", str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        **subprocess_kwargs()) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    for rank, out in enumerate(outs):
        assert f"mesh-smoke rank={rank}/2 devices=2 psum=3.0 OK" in out
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                       **subprocess_kwargs())
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh-smoke rank=0/1 devices=1 psum=1.0 OK" in r.stdout
