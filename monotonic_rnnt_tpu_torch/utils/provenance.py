"""Provenance stamps for generated evidence.

PyTorch counterpart of ``monotonic_rnnt_tpu/utils/provenance.py``: a record
to embed in every measurement the port emits, so that a reader can tell a
genuine re-run from a copied file: wall-clock timestamp, the repository's
git sha (and dirty flag), the device and card it ran on with the card's
power limit, the torch and CUDA versions, and the seed that drove the run.
"""

from __future__ import annotations

import datetime
import platform
import subprocess
from pathlib import Path

import torch

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent


def _git(*args: str) -> str:
    """git's output in the checkout, or "unknown" where git or the
    repository is missing."""
    try:
        return subprocess.run(
            ["git", *args], cwd=_REPO_ROOT, capture_output=True, text=True,
            timeout=10, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _power_limit(index: int) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def provenance_stamp(seed=None, device="cuda", **extra) -> dict:
    """{timestamp, git_sha, git_dirty, device, device_kind, torch_version,
    cuda_version, power_limit, seed, ...extra}.

    device: the device the stamped run used. A CUDA device is named by
    torch.cuda.get_device_name and its power limit read with nvidia-smi;
    asking for one where torch sees no card raises. For the CPU,
    device_kind is the host's processor and power_limit is None.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"provenance_stamp: device {device!r} asked "
                               "for, but torch sees no CUDA device")
        index = dev.index if dev.index is not None else (
            torch.cuda.current_device())
        kind = torch.cuda.get_device_name(index)
        power = _power_limit(index)
    else:
        kind = platform.processor() or platform.machine()
        power = None
    stamp = {
        "timestamp": datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        "git_sha": _git("rev-parse", "HEAD"),
        "git_dirty": bool(_git("status", "--porcelain")),
        "device": str(dev),
        "device_kind": kind,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "power_limit": power,
    }
    if seed is not None:
        stamp["seed"] = seed
    stamp.update(extra)
    return stamp
