"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither jax nor any module of the JAX package ``repro``, and no
source file under ``src/repro_torch`` imports them."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import torch  # noqa: F401  (the port's own dependency, imported as the tests do)

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_PROBE = """
import json, pkgutil, sys, importlib
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_loads_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    for name in ("repro_torch.serving.engine", "repro_torch.launch.serve",
                 "repro_torch.kernels.build", "repro_torch.interop",
                 "repro_torch.models.transformer",
                 "repro_torch.kernels.conv2d.ops", "repro_torch.models.googlenet",
                 "repro_torch.core.offload", "repro_torch.core.power",
                 "repro_torch.launch.offload_inference"):
        assert name in result["modules"]


def test_no_source_imports_jax_or_repro():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(SRC)}: {mod}")
    assert offenders == []


def test_chip_scripts_import_no_jax_or_repro():
    """``chip_smoke.py`` and ``kernel_gate_check.py`` run on the card's
    machine, where the port stands alone."""
    offenders = []
    for path in (SRC.parent / "chip_smoke.py", SRC.parent / "kernel_gate_check.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {m}" for m in mods
                          if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert offenders == []
