"""The PyTorch port imports neither JAX nor anything of the reference package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


def test_serve_import_loads_no_jax_and_no_repro():
    """Importing every module of the package (the examples and the analysis
    tools among them) loads neither and starts no process group."""
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "import repro_torch.launch.serve\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "import torch.distributed as dist\n"
        "group = dist.is_available() and dist.is_initialized()\n"
        "for want in ('repro_torch.examples.elastic_restart', 'repro_torch.launch.dryrun', "
        "'repro_torch.launch.hlo_costs', 'repro_torch.launch.roofline', "
        "'repro_torch.launch.specs', 'repro_torch.kernels.costs'):\n"
        "    assert want in sys.modules, want\n"
        "print(bad, 'process group started' if group else '')\n"
        "sys.exit(1 if bad or group else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path}: {bad}"


def test_port_calls_no_finished_attention_kernel():
    """The port's attention is its own kernels: no fused library attention and
    no torch.compile anywhere in the package (chip_smoke.py only times one)."""
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        for word in ("scaled_dot_product_attention", "torch.compile", "flash_attn"):
            assert word not in text, f"{path} uses {word}"
