"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface, so it compiles in
seconds without PyTorch's headers.  The shared libraries go to a git-ignored
directory inside the package (``_build/``), named by a digest of the source,
the shared ``csrc/*.cuh`` headers and the flags, so an unchanged source is
built once.  Nothing here runs at
import time: kernels are built on first use, on a machine with a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
#: nvcc's report (registers, shared memory, spills) of the last build of each source
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin directory on PATH or set CUDA_HOME")


def _target(name: str) -> Path:
    # the shared headers count too: a changed header rebuilds every source
    src = b"".join(p.read_bytes() for p in [CSRC_DIR / name, *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(name).stem}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/<name>`` that is not built yet, one ``nvcc`` per
    source, all started together, then load each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        if name in _LOADED:
            continue
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in names:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(_target(name)))
    return {name: _LOADED[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if needed."""
    return _LOADED.get(name) or build([name])[name]
