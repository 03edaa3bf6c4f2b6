"""Build the hand-written CUDA kernels with ``nvcc`` and load them with
``ctypes`` (plain C interface: no PyTorch headers, so a build takes seconds).

Each ``csrc/<name>.cu`` compiles on first use into
``build/kernels/<name>-<digest>.so`` at the repository root; the digest
covers the sources and the flags, so an edited kernel is rebuilt and a
built one is reused, with the ``-Xptxas -v`` output of its build read back
from ``<name>-<digest>.log``.  :func:`build` starts one ``nvcc`` per
source, all at once.  A failed build raises with nvcc's output.
:func:`load` may first be called from any thread (autograd runs a
backward on a thread of its own): one lock covers a library's first build
and load, and a build's temporary file is named by process and thread.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LOGS: dict[str, str] = {}            # name -> nvcc output (kept beside the .so)
CACHED: set[str] = set()             # names whose .so was built by an earlier run
_LIBS: dict[str, ctypes.CDLL] = {}  # guarded-by: _LOCK (written)
_TYPED: dict[str, set] = {}          # name -> its typed entry points; guarded-by: _LOCK (written)
_LOCK = threading.Lock()


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels build only where the CUDA toolkit is")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns name -> shared library."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            log = so.with_suffix(".log")
            LOGS[name] = log.read_text() if log.exists() else ""
            CACHED.add(name)
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        LOGS[name] = out
        if proc.returncode == 0:
            so.with_suffix(".log").write_text(out)
            os.replace(tmp, so)
        else:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str, argtypes: list, entry: str | None = None) -> ctypes.CDLL:
    """The built library of kernel ``name`` (building it on first use),
    with the C entry point ``entry`` (default ``name``; a source may have
    more than one) typed as ``argtypes -> int``."""
    entry = entry or name
    lib = _LIBS.get(name)
    if lib is not None and entry in _TYPED.get(name, ()):
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _TYPED[name] = set()
        if entry not in _TYPED[name]:
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _TYPED[name].add(entry)
        _LIBS[name] = lib
    return lib
