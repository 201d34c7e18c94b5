"""The port stands alone: no file of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")
# the port's subpackages, each checked by importing it alone
SUBPACKAGES = ("batch", "core", "corpus", "data", "dispatch", "kernels",
               "models", "obs", "resilience", "serve", "serve.runtime",
               "sparse", "train")


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
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("sub", ["dispatch", "sparse"])
def test_public_surface_matches_reference(sub):
    """``repro_torch.dispatch`` and ``repro_torch.sparse`` export the
    reference's names (but the deprecated ``SparseOperand``, not ported
    yet), each bound, and import alone without JAX or ``repro``."""
    import importlib
    import json

    code = (f"import json, sys, repro_torch.{sub} as m; "
            "bad = sorted(x for x in sys.modules "
            "if x.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "unbound = [n for n in m.__all__ if not hasattr(m, n)]; "
            "print(json.dumps(sorted(m.__all__))); "
            "sys.exit(1 if bad or unbound else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    ref = importlib.import_module(f"repro.{sub}")
    assert json.loads(out.stdout) == sorted(set(ref.__all__)
                                            - {"SparseOperand"})
