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
    for name in ("repro_torch.serving.engine", "repro_torch.serving.router",
                 "repro_torch.launch.serve",
                 "repro_torch.kernels.build", "repro_torch.interop",
                 "repro_torch.models.transformer",
                 "repro_torch.kernels.conv2d.ops", "repro_torch.models.googlenet",
                 "repro_torch.core.offload", "repro_torch.core.power",
                 "repro_torch.launch.offload_inference",
                 "repro_torch.kernels.ssm_scan.ops",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.models.layers.ssm", "repro_torch.models.hybrid",
                 "repro_torch.distributed.collectives",
                 "repro_torch.kernels.matmul.ops", "repro_torch.models.layers.linear",
                 "repro_torch.training.losses", "repro_torch.training.train_step",
                 "repro_torch.training.trainer", "repro_torch.optim.optimizers",
                 "repro_torch.checkpoint.checkpoint", "repro_torch.distributed.fault",
                 "repro_torch.data.pipeline", "repro_torch.launch.train",
                 "repro_torch.models.encdec", "repro_torch.models.layers.rope",
                 "repro_torch.models.layers.mlp",
                 "repro_torch.distributed.sharding", "repro_torch.distributed.policy",
                 "repro_torch.launch.mesh", "repro_torch.configs.specs",
                 "repro_torch.distributed.tensor_parallel",
                 "repro_torch.models.layers.embedding"):
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
    """``chip_smoke.py``, ``kernel_gate_check.py``, ``k5_backward_probe.py``
    and ``k7b_probe.py`` run on the card's machine, where the port stands
    alone."""
    offenders = []
    for path in (SRC.parent / "chip_smoke.py", SRC.parent / "kernel_gate_check.py",
                 SRC.parent / "k5_backward_probe.py", SRC.parent / "k7b_probe.py"):
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
