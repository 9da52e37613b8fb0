"""Builds the CUDA sources in ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into the package's
``build/`` directory at first use. The file name carries a hash of the
sources and the flags, so an edit rebuilds it. ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("stats_alpha", "beta_grad", "grad_pass", "banded", "split",
           "stream", "loss_glue")
# No --use_fast_math: __expf/__logf would loosen parity with the oracle.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_BUILD_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                           " the CUDA kernels are built from csrc/ at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmrnnt_{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compiles every library of `names` that is not built yet, in parallel."""
    pending = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in pending:
        try:
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out\n{log}")
            continue
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.mrnnt_error_string.argtypes = [ctypes.c_int]
        lib.mrnnt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib
