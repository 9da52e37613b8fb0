"""ctypes binding for the native CPU engine (native_src/mrnnt.cpp).

PyTorch-side counterpart of ``monotonic_rnnt_tpu/native.py``: the C entry
point ``mrnnt_loss_packed``, the counterpart of the reference's
``compute_rnnt_loss`` (rnnt_entrypoint.h:24-25), and the CPU engine of the
port's torch binding. ``native_src/`` is a verbatim copy of the JAX
package's sources, kept here so the port imports nothing of that package.

The library is compiled with g++ at first use into the package's
``build/`` directory (OpenMP and -march=native when the compiler takes
them), under a name that hashes the sources and the flags, through a
temporary file renamed into place, so concurrent processes (pytest workers)
never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .utils.status import RnntError, Status

_PACKAGE_DIR = Path(__file__).resolve().parent
NATIVE_DIR = _PACKAGE_DIR / "native_src"
BUILD_DIR = _PACKAGE_DIR / "build"
_BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
# Tried in turn: a compiler without OpenMP or -march=native still builds.
_EXTRA_FLAGS = (("-fopenmp", "-march=native"), ("-fopenmp",), ())
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library built from native_src/ lives."""
    digest = hashlib.sha256(" ".join(_BASE_FLAGS).encode())
    for extra in _EXTRA_FLAGS:
        digest.update(" ".join(extra).encode())
    for src in (NATIVE_DIR / "mrnnt.cpp", NATIVE_DIR / "mrnnt.h"):
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmrnnt_native-{digest.hexdigest()[:16]}.so"


def _compile() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    base = ["g++", f"-I{NATIVE_DIR}", *_BASE_FLAGS,
            str(NATIVE_DIR / "mrnnt.cpp"), "-o", str(tmp)]
    last = None
    try:
        for extra in _EXTRA_FLAGS:
            try:
                subprocess.run(base[:2] + list(extra) + base[2:], check=True,
                               capture_output=True)
            except subprocess.CalledProcessError as exc:
                last = exc
                continue
            os.replace(tmp, out)  # atomic: concurrent builds agree
            return out
    except FileNotFoundError as exc:
        raise RnntError(Status.EXECUTION_FAILED,
                        "native build needs g++ on PATH") from exc
    finally:
        tmp.unlink(missing_ok=True)
    raise RnntError(Status.EXECUTION_FAILED,
                    f"native build failed: {last.stderr.decode()[-500:]}")


def load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_compile()))
            f32p = ctypes.POINTER(ctypes.c_float)
            i32, i32p = ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
            # See native_src/mrnnt.h for the parameters.
            lib.mrnnt_loss_packed.argtypes = [
                f32p, i32p, i32, i32p, i32p, i32, i32, i32, i32, i32p, i32,
                i32, f32p, f32p, ctypes.c_void_p]
            lib.mrnnt_loss_packed.restype = ctypes.c_int
            lib.mrnnt_workspace_bytes.argtypes = [
                i32, i32p, i32p, ctypes.POINTER(ctypes.c_int64)]
            lib.mrnnt_workspace_bytes.restype = ctypes.c_int
            lib.mrnnt_status_string.argtypes = [ctypes.c_int]
            lib.mrnnt_status_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int32))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rnnt_loss_native(
    acts: np.ndarray,
    labels: np.ndarray,
    input_lengths,
    label_lengths,
    blank_id: int = 0,
    num_threads: int = 0,
    alignment: Optional[np.ndarray] = None,
    max_distance_from_alignment: int = 0,
    with_grads: bool = True,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Packed-layout loss via the native engine.

    acts: [sum_b T_b*(S_b+1), V] float32 (reference packed layout);
    labels: [B, S_max] int32. Returns (costs [B], grads like acts or None).
    """
    lib = load_library()
    acts = np.ascontiguousarray(np.asarray(acts, dtype=np.float32))
    labels = _i32(labels)
    ilen, slen = _i32(input_lengths), _i32(label_lengths)
    batch = len(ilen)

    # Validate sizes before handing raw pointers to C (the engine trusts
    # them; a mismatch would read/write out of bounds, not raise).
    if acts.ndim != 2:
        raise RnntError(Status.INVALID_VALUE,
                        f"acts must be packed 2-D [rows, V], got {acts.shape}")
    if len(slen) != batch:
        raise RnntError(Status.INVALID_VALUE,
                        "input_lengths and label_lengths disagree on batch")
    expect_rows = int((ilen.astype(np.int64) * (slen + 1)).sum())
    if acts.shape[0] != expect_rows:
        raise RnntError(Status.INVALID_VALUE,
                        f"packed acts have {acts.shape[0]} rows, lengths "
                        f"imply {expect_rows}")
    if labels.ndim != 2 or labels.shape[0] != batch or (
            batch and labels.shape[1] < int(slen.max())):
        raise RnntError(Status.INVALID_VALUE,
                        f"labels must be [B, >=max(S_b)], got {labels.shape}")
    v = acts.shape[-1]
    costs = np.zeros((batch,), np.float32)
    grads = np.zeros_like(acts) if with_grads else None

    align_ptr, t_stride = None, 0
    if alignment is not None:
        alignment = _i32(alignment)
        if alignment.ndim != 2 or alignment.shape[0] != batch or (
                batch and alignment.shape[1] < int(ilen.max())):
            raise RnntError(Status.INVALID_VALUE,
                            f"alignment must be [B, >=max(T_b)], got "
                            f"{alignment.shape}")
        t_stride = alignment.shape[1]
        align_ptr = _ptr(alignment, ctypes.c_int32)

    rc = lib.mrnnt_loss_packed(
        _ptr(acts, ctypes.c_float), _ptr(labels, ctypes.c_int32),
        ctypes.c_int32(batch), _ptr(ilen, ctypes.c_int32),
        _ptr(slen, ctypes.c_int32), ctypes.c_int32(v),
        ctypes.c_int32(labels.shape[1] if labels.ndim == 2 else 0),
        ctypes.c_int32(blank_id), ctypes.c_int32(num_threads), align_ptr,
        ctypes.c_int32(t_stride), ctypes.c_int32(max_distance_from_alignment),
        _ptr(costs, ctypes.c_float),
        _ptr(grads, ctypes.c_float) if grads is not None else None, None)
    if rc != 0:
        msg = lib.mrnnt_status_string(rc).decode()
        raise RnntError(Status.INVALID_VALUE, f"native engine: {msg}")
    return costs, grads
