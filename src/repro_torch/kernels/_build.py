"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use, by its own ``nvcc`` process, into ``build/<name>-<hash>.so`` at
the root of the checkout::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The hash covers the source and the flags, so an edited source rebuilds.
The compiler's output (registers, shared memory, spills from ``-Xptxas
-v``) is kept beside the library as ``<name>-<hash>.log``.  Only sources
in this package are compiled; nothing is fetched.  ``build_all()`` starts
every compile at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h = h.hexdigest()[:12]
    return BUILD / f"{name}-{h}.so"


def _tmp(so: Path) -> Path:
    return so.with_suffix(f".{os.getpid()}.tmp")


def _start(name: str):
    """Start compiling ``name`` unless its library exists; return the
    nvcc process (or None) and the library path."""
    so = _target(name)
    if so.exists():
        return None, so
    BUILD.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc()] + FLAGS + ["-o", str(_tmp(so)), str(CSRC / f"{name}.cu")]
    with open(so.with_suffix(".log"), "w") as log:
        log.write(" ".join(cmd) + "\n")
        log.flush()
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, so


def _finish(started: Dict[str, tuple]) -> None:
    """Wait for every started compile, then raise if any failed."""
    failed = []
    for name, (proc, so) in started.items():
        if proc is None:
            continue
        if proc.wait() != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):"
                          f"\n{so.with_suffix('.log').read_text()}")
        else:
            os.replace(_tmp(so), so)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all() -> Dict[str, Path]:
    """Compile every source in parallel (one nvcc each); return the
    library paths.  Already-built sources are not recompiled."""
    started = {name: _start(name) for name in sources()}
    _finish(started)
    return {name: so for name, (_, so) in started.items()}


def build_log(name: str) -> str:
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        started = {name: _start(name)}
        _finish(started)
        lib = _LIBS[name] = ctypes.CDLL(str(started[name][1]))
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by the C entry point
    ``name`` of ``lib``."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{msg(err).decode()}")
