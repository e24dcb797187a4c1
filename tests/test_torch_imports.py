"""The port stands alone: no module of ``repro_torch`` imports ``jax`` or the
JAX package ``repro`` (not even its numpy-only modules), and neither does
``chip_smoke.py``.  The machine with the GPU has no JAX at all.

Each module is imported in a fresh interpreter whose meta-path finder
raises on ``jax`` and ``repro``; ``chip_smoke.py``, whose imports sit inside
its phase functions, is checked statement by statement.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")

GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = {forbidden!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"the port imported {{name!r}}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not bad, bad
print(" ".join(names))
print(len(names))
"""

# modules the port must have (a sample; every module found is imported)
REQUIRED = ("repro_torch.monitor", "repro_torch.core.faults", "repro_torch.core.telemetry",
            "repro_torch.core.monitor", "repro_torch.core.engine", "repro_torch.core.platform",
            "repro_torch.core.calibration", "repro_torch.core.distributed",
            "repro_torch.core.workload", "repro_torch.core.rng")


def test_port_modules_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", GUARD.format(forbidden=FORBIDDEN)], env=env,
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 30  # every module of the port was imported
    imported = set(out.stdout.splitlines()[-2].split())
    assert set(REQUIRED) <= imported, sorted(set(REQUIRED) - imported)


def test_chip_smoke_imports_no_jax_and_no_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert "repro_torch.core" in names or any(n.startswith("repro_torch") for n in names)
