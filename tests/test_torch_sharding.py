"""The sharding layer's declarations in the port held against the JAX
package: the recipe tables, the parameter counts, the abstract shapes and
dtypes, and every resolved spec of every parameter, optimizer-state,
input and cache leaf, for all ten architectures at their published
widths (llama3-405b among them), the three recipes, five mesh shapes and
the four input-shape cells.

The reference's ``resolve_spec`` reads only a mesh's ``axis_names`` and
``shape``, so it takes a stand-in object here (no XLA devices).  The
reference stacks each group of layers on leading axes; the port keeps one
declaration per layer, whose logical axes are the reference's without the
stacking axes (always ``None``, so they claim no mesh axis): each
per-layer leaf is held to its stacked twin with those axes dropped.
Counts, shapes and specs are compared exactly.  One subprocess with 8
fake XLA devices holds :func:`local_shape` to ``NamedSharding``'s shard
shapes (no compile).
"""

import dataclasses
import json
import math
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.specs import input_specs as ref_input_specs  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.parallel import sharding as ref_sh  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.train_step import abstract_state as ref_abstract_state  # noqa: E402

from conftest import subprocess_kwargs  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, smoke_shrink  # noqa: E402
from repro_torch.interop import _stacks  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_production_mesh  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models import cache_spec, param_defs  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    abstract_params,
    count_params,
    is_def,
    param_specs,
)
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import abstract_state, state_logical  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((1,), ("data",))]
RECIPES = ("default", "dp_only", "fsdp_only")
MOMENTS = ("float32", "int8")


def _stand_in(sizes, axes):
    """What the reference's ``resolve_spec`` reads of a mesh."""
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))


def _ref_spec(logical, mesh, shape, recipe):
    return tuple(ref_sh.resolve_spec(tuple(logical), mesh, tuple(shape),
                                     recipe))


def _walk(t, prefix=""):
    """``{path: leaf}`` of a reference tree of nested dicts (tuples are
    leaves), paths joined as the port's ``tree.flatten`` joins them."""
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_walk(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: t}


def _rows(cfg, ref_tree: dict) -> dict:
    """The reference's parameter-shaped tree in the port's layout:
    ``{port path: (reference leaf, its stacking axes)}``, each stacked
    group's leaves repeated for every layer of the group, in layer order
    (``interop._stacks``: the hybrid's groups row-major, the
    encoder-decoder's decoder layers into ``layers``)."""
    stacks = _stacks(cfg)
    keys = {k for k, _, _ in stacks}
    out = {p: (leaf, 0) for k, v in ref_tree.items() if k not in keys
           for p, leaf in _walk({k: v}).items()}
    start = {}
    for key, axes, into in stacks:
        n = math.prod(axes)
        first = start.get(into, 0)
        for i in range(n):
            for name, leaf in ref_tree[key].items():
                out[f"{into}/{first + i}/{name}"] = (leaf, len(axes))
        start[into] = first + n
    return out


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _moment_pairs(cfg, ref_state: dict):
    """``{port path: (reference leaf, stacking axes)}`` of an optimizer
    state (``m`` and ``v`` parameter-shaped, ``count`` a scalar); an
    int8 moment's ``(q, scale)`` pair is split into ``.../0`` (q) and
    ``.../1`` (the scale, unstacked)."""
    out = {"count": (ref_state["count"], 0)}
    for m in ("m", "v"):
        for p, (leaf, axes) in _rows(cfg, ref_state[m]).items():
            if isinstance(leaf, tuple) and len(leaf) == 2 and not (
                    sh.is_logical(leaf)):
                out[f"{m}/{p}/0"] = (leaf[0], axes)
                out[f"{m}/{p}/1"] = (leaf[1], 0)
            else:
                out[f"{m}/{p}"] = (leaf, axes)
    return out


def test_tables_equal_reference():
    assert sh.LOGICAL_TO_PHYSICAL == ref_sh.LOGICAL_TO_PHYSICAL
    assert sh.RECIPES == ref_sh.RECIPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_counts_match_reference(arch):
    ref_defs = ref_build_model(ref_get_config(arch)).param_defs()
    assert count_params(param_defs(get_config(arch))) == \
        ref_sh.count_params(ref_defs)
    if arch == "llama3-405b":
        assert ref_sh.count_params(ref_defs) == 405_853_388_800


def _held(got: dict, want: dict, describe) -> int:
    """Each port leaf ``got[path]`` against ``describe(ref leaf, axes)``;
    the two trees have the same paths.  Returns the count."""
    assert set(got) == set(want)
    for path, value in got.items():
        assert value == describe(*want[path]), path
    return len(got)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_abstract_shapes_and_dtypes_match_reference(arch):
    """Parameters, optimizer state (fp32 and int8 moments), the training
    state's step, and every input and cache leaf of the four cells: the
    port's meta tensors have the reference's shapes (without its
    stacking axes) and dtypes, and the inputs and caches its logical
    axes."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    ref_model = ref_build_model(ref_cfg)
    ref_defs = ref_model.param_defs()
    defs = param_defs(cfg)

    def meta(tree_):
        flat = dict(tree.flatten(tree_))
        assert {str(t.device) for t in flat.values()} == {"meta"}
        return {p: (tuple(t.shape), _dtype_name(t.dtype))
                for p, t in flat.items()}

    def sds(leaf, axes):
        return tuple(leaf.shape[axes:]), str(leaf.dtype)

    n = _held(meta(abstract_params(defs)),
              _rows(cfg, ref_sh.abstract_params(ref_defs)), sds)
    assert n == len(tree.leaves(defs, is_def))
    logical = dict(tree.flatten(param_specs(defs), sh.is_logical))
    for path, (d, axes) in _rows(cfg, ref_defs).items():
        assert all(a is None for a in d.logical[:axes]), path
        assert logical[path] == tuple(d.logical[axes:]), path
    for moments in MOMENTS:
        ocfg = opt.OptimizerConfig(moment_dtype=moments)
        rcfg = ref_opt.OptimizerConfig(moment_dtype=moments)
        _held(meta(opt.opt_state_abstract(defs, ocfg)),
              _moment_pairs(cfg, ref_opt.opt_state_abstract(ref_defs, rcfg)),
              sds)
        state = abstract_state(cfg, ocfg)
        ref_state = ref_abstract_state(ref_model, rcfg)
        assert meta(state.step) == {"": ((), "int32")}
        assert (tuple(ref_state.step.shape), str(ref_state.step.dtype)) == \
            ((), "int32")
        assert state_logical(cfg, ocfg).step == ()
    for shape in SHAPES:
        abs_in, log_in = input_specs(arch, shape)
        ref_abs, ref_log = ref_input_specs(arch, shape)
        _held(meta(abs_in), {p: (x, 0) for p, x in _walk(ref_abs).items()},
              sds)
        assert dict(tree.flatten(log_in, sh.is_logical)) == _walk(ref_log)


def _specs(abstract, logical, mesh, recipe) -> dict:
    return {p: spec for p, _, spec in sh.flat_specs(abstract, logical, mesh,
                                                    recipe)}


def _port_specs(cfg, mesh, recipe, moments) -> dict:
    """Every resolved spec of the port's training state, by path: its
    parameters' (as ``param_shardings`` resolves them too) and its
    optimizer state's."""
    ocfg = opt.OptimizerConfig(moment_dtype=moments)
    st = _specs(abstract_state(cfg, ocfg), state_logical(cfg, ocfg), mesh,
                recipe)
    defs = param_defs(cfg)
    params = {p[len("params/"):]: s for p, s in st.items()
              if p.startswith("params/")}
    by_defs = sh.param_shardings(defs, mesh, recipe)
    for p, d in tree.flatten(defs, is_def):
        spec = by_defs
        for k in p.split("/"):
            spec = spec[int(k) if isinstance(spec, list) else k]
        assert params[p] == spec, p
    assert st["step"] == ()
    return params, {p[len("opt/"):]: s for p, s in st.items()
                    if p.startswith("opt/")}


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_resolved_specs_match_reference(arch, recipe):
    """Every parameter, optimizer (fp32 and int8) and input or cache
    leaf, on every mesh of MESHES and every cell of SHAPES: the port's
    resolved spec is ``tuple(resolve_spec(...))`` of the reference's (a
    per-layer leaf's, its stacked twin's without the stacking axes,
    which resolve to None)."""
    cfg = get_config(arch)
    ref_model = ref_build_model(ref_get_config(arch))
    ref_defs = ref_model.param_defs()
    rows = _rows(cfg, ref_defs)
    n = 0
    for sizes, axes in MESHES:
        mesh, ref_mesh = MeshShape(sizes, axes), _stand_in(sizes, axes)

        def spec(leaf, stack, logical=None):
            got = _ref_spec(leaf.logical if logical is None else logical,
                            ref_mesh, leaf.shape, recipe)
            assert all(a is None for a in got[:stack])
            return got[stack:]

        for moments in MOMENTS:
            params, moms = _port_specs(cfg, mesh, recipe, moments)
            n += _held(params, rows, spec)
            rcfg = ref_opt.OptimizerConfig(moment_dtype=moments)
            ref_abs = _moment_pairs(cfg, ref_opt.opt_state_abstract(
                ref_defs, rcfg))
            ref_log = _moment_pairs(cfg, ref_opt.opt_state_logical(
                ref_defs, rcfg))
            for path, (leaf, stack) in ref_abs.items():
                got = _ref_spec(ref_log[path][0], ref_mesh, leaf.shape,
                                recipe)
                assert all(a is None for a in got[:stack]), path
                assert moms[path] == got[stack:], (path, moments)
                n += 1
            assert set(moms) == set(ref_abs)
        for shape in SHAPES:
            abs_in, log_in = input_specs(arch, shape)
            got = _specs(abs_in, log_in, mesh, recipe)
            ref_abs, ref_log = ref_input_specs(arch, shape)
            ref_log = _walk(ref_log)
            want = {p: _ref_spec(ref_log[p], ref_mesh, x.shape, recipe)
                    for p, x in _walk(ref_abs).items()}
            assert got == want, shape
            n += len(got)
    assert n > 0


def test_resolution_rules():
    """The divisibility rule drops the rightmost axis and retries; a mesh
    axis serves one dimension; absent axes resolve to None."""
    mesh = make_production_mesh(multi_pod=True)
    assert sh.resolve_spec(("tp", "fsdp"), mesh, (128256, 16384)) == \
        ("model", "data")
    assert sh.resolve_spec(("dp", None), mesh, (1, 4096)) == (None, None)
    assert sh.resolve_spec(("dp", None), mesh, (32, 4096)) == \
        (("pod", "data"), None)
    assert sh.resolve_spec(("dp", None), mesh, (2, 4096)) == ("pod", None)
    assert sh.resolve_spec(("dp", None), mesh, (512, 8), "dp_only") == \
        (("pod", "data", "model"), None)
    assert sh.resolve_spec(("dp", None), mesh, (128, 8), "dp_only") == \
        (("pod", "data"), None)
    assert sh.resolve_spec(("tp", "tp"), mesh, (16, 16)) == ("model", None)
    flat = MeshShape((4,), ("data",))
    assert sh.resolve_spec(("tp", "fsdp"), flat, (8, 8)) == (None, "data")
    assert sh.local_shape((8, 6), ("data", None), flat) == (2, 6)
    with pytest.raises(ValueError, match="split"):
        sh.local_shape((6,), ("data",), flat)


def test_rank_bytes_sum_the_local_shards():
    mesh = MeshShape((2, 4), ("data", "model"))
    abs_ = {"w": torch.empty((8, 12), dtype=torch.bfloat16, device="meta"),
            "s": torch.empty((), dtype=torch.float32, device="meta")}
    log = {"w": ("fsdp", "tp"), "s": ()}
    assert sh.logical_shardings(abs_, log, mesh) == {"w": ("data", "model"),
                                                     "s": ()}
    assert sh.rank_bytes(abs_, log, mesh) == 4 * 3 * 2 + 4
    assert sh.rank_bytes(abs_, log, mesh, "dp_only") == 8 * 12 * 2 + 4
    with pytest.raises(ValueError, match="leaves"):
        sh.rank_bytes(abs_, {"w": ("fsdp", "tp")}, mesh)


SHARD_SHAPES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import NamedSharding
from repro.configs import get_config, smoke_shrink
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.parallel.sharding import resolve_spec
from repro.train import optimizer as opt
from repro.train.train_step import abstract_state, state_logical

is_log = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)
out = {}
for sizes, axes in ((2, 2, 2), ("pod", "data", "model")), ((4, 2), ("data", "model")):
    mesh = make_host_mesh(sizes, axes)
    for arch in sys.argv[1:]:
        model = build_model(smoke_shrink(get_config(arch)))
        ocfg = opt.OptimizerConfig()
        st, log = abstract_state(model, ocfg), state_logical(model, ocfg)
        spec = model.cache_spec(8, 64)
        pair = lambda x: isinstance(x, tuple) and len(x) == 2 and isinstance(
            x[0], jax.ShapeDtypeStruct)
        cache = jax.tree.map(lambda t: t[0], spec, is_leaf=pair)
        clog = jax.tree.map(lambda t: tuple(None if a == "layer" else a
                                            for a in t[1]), spec, is_leaf=pair)
        shard = lambda a, l: list(NamedSharding(
            mesh, resolve_spec(l, mesh, a.shape)).shard_shape(a.shape))
        trees = {"params": (st.params, log.params), "opt": (st.opt, log.opt),
                 "cache": (cache, clog)}
        out[f"{arch}@{sizes}"] = {
            k: jax.tree.map(shard, a, l, is_leaf=lambda x: isinstance(
                x, jax.ShapeDtypeStruct))
            for k, (a, l) in trees.items()}
print(json.dumps(out))
"""
SHRINKS = ("llama3.2-3b", "deepseek-moe-16b", "mamba2-130m")


def test_local_shape_matches_named_sharding():
    """The train state and decode cache (8 x 64) of three smoke shrinks on
    the 8-device meshes (2, 2, 2) and (4, 2): the port's ``local_shape``
    of each leaf is ``NamedSharding(mesh, spec).shard_shape(shape)`` of
    the reference's twin (its stacking axes, unsharded, dropped)."""
    r = subprocess.run([sys.executable, "-c", SHARD_SHAPES, *SHRINKS],
                       capture_output=True, text=True, timeout=300,
                       **subprocess_kwargs())
    assert r.returncode == 0, r.stderr[-3000:]
    ref = json.loads(r.stdout.strip().splitlines()[-1])
    n = 0
    for sizes, axes in (((2, 2, 2), ("pod", "data", "model")),
                        ((4, 2), ("data", "model"))):
        mesh = MeshShape(sizes, axes)
        for arch in SHRINKS:
            cfg = smoke_shrink(get_config(arch))
            want = ref[f"{arch}@{sizes}"]
            ocfg = opt.OptimizerConfig()
            st = abstract_state(cfg, ocfg)
            local = {p: sh.local_shape(tuple(t.shape), s, mesh)
                     for p, t, s in sh.flat_specs(
                         st, state_logical(cfg, ocfg), mesh)}
            got = {p[len("params/"):]: s for p, s in local.items()
                   if p.startswith("params/")}
            rows = _rows(cfg, want["params"])
            for path, shp in got.items():
                leaf, stack = rows[path]
                assert shp == tuple(leaf[stack:]), (arch, sizes, path)
                n += 1
            assert set(got) == set(rows)
            moms = {p[len("opt/"):]: s for p, s in local.items()
                    if p.startswith("opt/")}
            ref_moms = _moment_pairs(cfg, want["opt"])
            assert set(moms) == set(ref_moms)
            for path, shp in moms.items():
                leaf, stack = ref_moms[path]
                assert shp == tuple(leaf[stack:]), (arch, sizes, path)
                n += 1
            cache = {}
            for p, (shape, _, log) in tree.flatten(
                    cache_spec(cfg, 8, 64),
                    lambda x: isinstance(x, tuple) and len(x) == 3):
                log = tuple(None if a == "layer" else a for a in log)
                cache[p] = list(sh.local_shape(
                    shape, sh.resolve_spec(log, mesh, shape), mesh))
            assert cache == _walk(want["cache"]), (arch, sizes)
            n += len(cache)
    assert n > 100
