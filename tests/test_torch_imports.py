"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the reference package
``repro`` (checked on the syntax tree, not by text search)."""

import ast
import os

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PORT):
        out += [os.path.join(base, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_sources_found():
    files = _sources()
    assert os.path.join(ROOT, "chip_smoke.py") in files
    assert os.path.exists(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    bad = [(m, line) for m, line in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_guard_catches_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom repro.core import api\ndef f():\n    import jax.numpy as jnp\n")
    assert {m for m, _ in _imported_roots(str(p))} & set(FORBIDDEN) == {"repro", "jax"}


def test_guard_reaches_the_serving_slice():
    """The telemetry, cache, server and example modules are among the
    guarded sources."""
    files = set(_sources())
    for rel in ("obs/__init__.py", "obs/trace.py", "obs/metrics.py", "obs/log.py",
                "obs/calibrate.py", "lowering/cache.py", "engine/server.py",
                "launch/serve.py", "examples/quickstart.py",
                "examples/simulate_sycamore.py"):
        assert os.path.join(PORT, rel) in files, rel


def test_guard_reaches_the_search_and_distributed_slice():
    """The plan search, fault-tolerance and multi-process modules are
    among the guarded sources, and none reads a ``REPRO_*`` variable (the
    reference's configuration by environment; the port takes arguments
    or torch's own ``env://`` variables)."""
    files = set(_sources())
    for rel in ("optimize/search.py", "core/distributed.py",
                "checkpoint/manager.py", "distributed/scheduler.py",
                "distributed/elastic.py", "distributed/transport.py",
                "distributed/multihost.py"):
        path = os.path.join(PORT, rel)
        assert path in files, rel
        assert "REPRO_" not in open(path, encoding="utf-8").read(), rel


def test_guard_reaches_the_training_slice():
    """The training modules (data, losses, optimizer, train step,
    gradient compression, launcher, example twin) are among the guarded
    sources."""
    files = set(_sources())
    for rel in ("data/pipeline.py", "models/losses.py", "train/optimizer.py",
                "train/train_step.py", "train/grad_compress.py",
                "launch/train.py", "examples/train_lm.py",
                "configs/llama3_2_3b.py"):
        assert os.path.join(PORT, rel) in files, rel
