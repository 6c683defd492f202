"""The port imports no JAX and nothing of the reference package.

Every module of `src/repro_torch/` and the port's `chip_smoke.py` are
parsed with `ast` (not imported) and each import statement is checked.
"""
import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
FILES = PORT_FILES + [REPO / "chip_smoke.py"]


def _forbidden(tree) -> list[str]:
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [] if node.level else [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(f"line {node.lineno}: {name}")
    return bad


def test_port_has_modules():
    assert len(PORT_FILES) >= 20


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    assert _forbidden(tree) == []


def test_checker_catches_forbidden_imports():
    src = "import jax.numpy as jnp\nfrom repro.core import theory\n"
    assert len(_forbidden(ast.parse(src))) == 2
    assert _forbidden(ast.parse("from .core import theory\n")) == []


TRAINING_SLICE = ("core.sketch", "core.tree", "optim", "optim.adamw",
                  "optim.compress", "optim.schedule",
                  "kernels.fused_update", "models", "models.api",
                  "models.config", "models.layers", "models.settings",
                  "models.transformer", "configs", "configs.llama32_3b",
                  "data", "data.pipeline", "launch.steps", "launch.train",
                  "runtime", "runtime.spans", "runtime.train_loop")


CKPT_SLICE = ("ckpt", "ckpt.checkpointer", "ckpt.sketched", "ckpt.elastic",
              "runtime.resilience", "serve.cache", "serve.engine",
              "launch.serve_rp")


COLLECTIVE_SLICE = ("launch.mesh", "launch.sharding", "rp.shard",
                    "optim.compress", "launch.steps", "launch.train")


@pytest.mark.parametrize("slice_", [TRAINING_SLICE, CKPT_SLICE,
                                    COLLECTIVE_SLICE],
                         ids=["training", "ckpt", "collective"])
def test_training_slice_modules_are_checked(slice_):
    names = {".".join(p.relative_to(REPO / "src").with_suffix("").parts)
             .removesuffix(".__init__") for p in PORT_FILES}
    assert {f"repro_torch.{m}" for m in slice_} <= names


def test_port_imports_with_jax_and_reference_blocked():
    """Every module of the port imports in a process where `jax` and
    `repro` cannot be imported at all (so no transitive import hides)."""
    import subprocess
    import sys
    mods = sorted(".".join(p.relative_to(REPO / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT_FILES)
    code = ("import importlib, sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout
