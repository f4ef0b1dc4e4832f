"""ctypes bindings of ``oket_native.cpp``, built with g++ on first use.

The library goes to the package's git-ignored ``_build/``, named by a
digest of the source and the flags (as ``utils/cuda_build.py`` names the
CUDA libraries), written under a per-process name and moved into place, so
ranks that build at once do not collide.  Where no compiler exists, or
``OKET_DISABLE_NATIVE`` is set (read at every call), each function returns
None and its caller takes the numpy branch, which defines the same arrays.
ctypes releases the GIL for the length of each call.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "oket_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"liboket_native-{digest}.so"


def _i32():
    return np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _i64():
    return np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _bind(lib: ctypes.CDLL) -> None:
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.oket_count_5col.restype = ctypes.c_int
    lib.oket_count_5col.argtypes = [ctypes.c_char_p, p64, p64, p64]
    lib.oket_parse_5col.restype = ctypes.c_int64
    lib.oket_parse_5col.argtypes = [ctypes.c_char_p, _i32(), _i64(), _i32(), _i64(), _i32()]
    lib.oket_unique_remap.restype = ctypes.c_int64
    lib.oket_unique_remap.argtypes = [_i32(), ctypes.c_int64, ctypes.c_int64, _i32(), _i32(), _i32()]
    lib.oket_grad_plan.restype = ctypes.c_int64
    lib.oket_grad_plan.argtypes = [
        _i32(), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        _i64(), _i32(), np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), _i32(),
    ]


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call of the process (None when the
    build or the load fails; the reason is logged once)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            try:
                subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)], check=True, capture_output=True,
                               timeout=300)
                os.replace(tmp, path)
            except (OSError, subprocess.SubprocessError) as e:
                logger.warning("native helpers not built (%s): the numpy branches run", e)
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            logger.warning("could not load %s (%s): the numpy branches run", path, e)
            return None
        _bind(lib)
        _LIB = lib
        return _LIB


def _lib() -> Optional[ctypes.CDLL]:
    return None if os.environ.get("OKET_DISABLE_NATIVE") else _load()


def native_available() -> bool:
    return _lib() is not None


def read_triple_file_native(
    path: str,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """The 5-column parse of ``data/dataset.py::read_triple_file``: (triples
    [T, 3] int32, subject offsets [T + 1] int64, subject mentions int32,
    object offsets, object mentions), or None without the library."""
    lib = _lib()
    if lib is None:
        return None
    nt, ns, no = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.oket_count_5col(str(path).encode(), ctypes.byref(nt), ctypes.byref(ns), ctypes.byref(no))
    if rc != 0:
        raise FileNotFoundError(f"native reader could not open {path} (rc={rc})")
    T, S, O = nt.value, ns.value, no.value
    triples = np.empty((T, 3), np.int32)
    s_off = np.zeros(T + 1, np.int64)
    s_val = np.empty(S, np.int32)
    o_off = np.zeros(T + 1, np.int64)
    o_val = np.empty(O, np.int32)
    written = lib.oket_parse_5col(str(path).encode(), triples.reshape(-1), s_off, s_val, o_off, o_val)
    if written != T:
        raise RuntimeError(f"native parse wrote {written} triples, counted {T} ({path})")
    return triples, s_off, s_val, o_off, o_val


def unique_remap_native(toks: np.ndarray, vocab: int, scratch: np.ndarray):
    """``(uids, remapped)``: the sorted unique ids of ``toks`` with 0 always
    among them, and ``toks`` remapped into that compact id space (numpy's
    ``union1d(0, toks)`` and ``searchsorted``), or None without the library.
    ``scratch`` is int32 of at least ``vocab`` elements, reused across calls
    of one thread."""
    lib = _lib()
    if lib is None:
        return None
    if scratch.dtype != np.int32 or scratch.size < vocab:
        raise ValueError(f"scratch must be int32 of at least {vocab} elements")
    flat = np.ascontiguousarray(toks.reshape(-1), dtype=np.int32)
    uids = np.empty(flat.size + 1, np.int32)
    remapped = np.empty(flat.size, np.int32)
    u = lib.oket_unique_remap(flat, flat.size, vocab, scratch, uids, remapped)
    if u < 0:
        raise ValueError(f"oket_unique_remap refused vocab={vocab}")
    return uids[:u].copy(), remapped.reshape(toks.shape)


def grad_plan_native(remapped: np.ndarray, n_unique: int, K: int, oob: int):
    """The gather-sum plan of ``train/sparse.py::build_token_grad_plan`` over
    a remapped [R, L] token matrix -> ``(pos [S, K] int32, valid [S, K]
    bool, uid [S] int32, n_slots)`` with S the worst-case capacity
    ``n_unique + R * L // K + 2``: the caller trims or pads it to its bucket.
    Slots from ``n_slots`` on have ``valid`` False, ``pos`` 0 and ``uid`` ``oob``
    (out of range: dropped).  None without the library."""
    lib = _lib()
    if lib is None:
        return None
    R, L = remapped.shape
    rm = np.ascontiguousarray(remapped, dtype=np.int32)
    if rm.size and (rm.min() < 0 or rm.max() >= n_unique):  # the kernel counts into [0, n_unique)
        raise ValueError(f"remapped ids must lie in [0, {n_unique})")
    cap = int(n_unique + R * L // K + 2)
    scratch = np.empty(max(n_unique + 1, L + 1) + R, np.int64)
    pos = np.zeros(cap * K, np.int32)
    valid = np.zeros(cap * K, np.uint8)
    uid = np.empty(cap, np.int32)
    s = lib.oket_grad_plan(rm, R, L, n_unique, K, oob, cap, scratch, pos, valid, uid)
    if s < 0:
        raise ValueError(f"oket_grad_plan: capacity {cap} too small")
    return pos.reshape(cap, K), valid.reshape(cap, K).view(bool), uid, int(s)
