"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX, anything of the JAX package ``repro``, or
``ml_dtypes`` (the card's machine has none; the checkpoint reads bf16
leaves without it)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")
# the port's subpackages, each checked by importing it alone
SUBPACKAGES = ("batch", "configs", "core", "corpus", "data", "dispatch",
               "ft", "kernels", "launch", "models", "obs", "resilience",
               "serve",
               "serve.fleet", "serve.runtime", "sharding", "sparse", "train")
# modules checked the same way on their own
MODULES = ("models.transformer", "models.pruning", "serve.engine",
           "train.loop", "train.pipeline", "ft.checkpoint", "ft.resharding",
           "core.distributed", "sharding.step", "runtime", "core.spmm",
           "core.sddmm", "sparse.legacy", "dispatch.operand",
           "launch.inputs", "launch.mesh", "launch.serve", "launch.train",
           "launch.roofline", "launch.dryrun", "launch.report")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_imports_alone(sub):
    """Each subpackage is in the files checked above, and importing it in a
    fresh interpreter loads neither JAX nor ``repro``."""
    assert any(p.parent == ROOT / "src" / "repro_torch" / sub.replace(
        ".", "/") for p in PORT_FILES)
    code = (f"import sys, repro_torch.{sub}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports_alone(mod):
    """The LM, training, checkpoint and mesh modules, each imported alone
    in a fresh interpreter, load neither JAX, ``repro`` nor
    ``ml_dtypes``."""
    assert (ROOT / "src" / "repro_torch" / (mod.replace(".", "/") + ".py")
            ) in PORT_FILES
    code = (f"import sys, repro_torch.{mod}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("sub", ["configs", "dispatch", "serve.fleet",
                                 "sharding", "sparse"])
def test_public_surface_matches_reference(sub):
    """``repro_torch.configs``, ``repro_torch.dispatch``,
    ``repro_torch.serve.fleet``, ``repro_torch.sharding`` and
    ``repro_torch.sparse`` export the
    reference's names (the deprecated ``SparseOperand`` too), each bound,
    and import alone without JAX or ``repro``."""
    import importlib
    import json

    code = (f"import json, sys, repro_torch.{sub} as m; "
            "bad = sorted(x for x in sys.modules "
            "if x.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')); "
            "unbound = [n for n in m.__all__ if not hasattr(m, n)]; "
            "print(json.dumps(sorted(m.__all__))); "
            "sys.exit(1 if bad or unbound else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    ref = importlib.import_module(f"repro.{sub}")
    assert json.loads(out.stdout) == sorted(set(ref.__all__))
