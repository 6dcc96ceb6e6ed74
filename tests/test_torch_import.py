"""The PyTorch port imports and runs without JAX.

The machine the port targets has no JAX, so ``physicl_tpu_torch`` (and the
GPU smoke script) must never import it, directly or through
``physicl_tpu``. A subprocess blocks ``jax`` in ``sys.modules`` and drives a
small CPU run through the public API.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "physicl_tpu_torch")

_BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None           # any `import jax` now raises ImportError
sys.modules["physicl_tpu"] = None   # and so does the JAX package
import numpy as np
import physicl_tpu_torch as phys
import physicl_tpu_torch.light as light

s = phys.Simulation(exit=lambda c: c.t >= 0.005, seed=1, chunk_steps=4,
                    device="cpu")
s.add_step(0, phys.UpdateTimeStep(lambda x: np.double(0.001)))
s.add_step(1, phys.newton.NewtonianKinematicsStep())
s.add_step(2, light.ScatterIsotropicStep(A=0.001, n=0.001))
m = light.ScatterSignMeasureStep(None, True)
s.add_step(3, m)
s.add_photons(light.generate_photon_state(100, E=1.0))
s.start(); s.join()
assert s.used_fused and len(s.ts) == len(m.data) == 5, (s.ts, m.data)
assert not any(k == "jax" or k.startswith(("jax.", "jaxlib"))
               for k, v in sys.modules.items() if v is not None)
print("ok")
"""


def test_import_and_run_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


_BLOCKED_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["physicl_tpu"] = None
import physicl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(physicl_tpu_torch.__path__,
                                               "physicl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(" ".join(sorted(names)))
"""


def test_every_module_imports_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT_ALL],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    on_disk = {os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
               for p in _port_sources() if p.startswith(PKG)}
    on_disk = {n[:-len(".__init__")] if n.endswith(".__init__") else n
               for n in on_disk} - {"physicl_tpu_torch"}
    assert on_disk <= names, on_disk - names


def _port_files():
    return sorted(os.path.join(root, f) for root, _, files in os.walk(PKG)
                  for f in files
                  if f.endswith((".py", ".cu", ".cuh", ".cpp", ".h")))


# a path component "physicl_tpu" (the JAX package's directory)
_JAX_TREE = re.compile(r"(^|[/\\])physicl_tpu([/\\]|$)")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_path_into_the_jax_tree(path):
    """The port keeps its own copy of whatever it needs from the JAX tree:
    no code string (docstrings and comments may cite the kernel a file
    replaces) and no ``#include`` names a path inside ``physicl_tpu/``."""
    text = open(path).read()
    if not path.endswith(".py"):
        for line in text.splitlines():
            if line.lstrip().startswith("#include"):
                assert "physicl_tpu/" not in line, line
        return
    tree = ast.parse(text, path)
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef,
                                       ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)
                  and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            assert not _JAX_TREE.search(node.value), (
                f"{path}:{node.lineno} names {node.value!r}")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    """Static guard: no module of the port names jax or physicl_tpu in an
    import statement (lazy imports inside functions included)."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "physicl_tpu"), (
                f"{path}:{node.lineno} imports {name}")
