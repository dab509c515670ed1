"""Device resolution and a report of the card.

Counterpart of ``deepspeed_tpu/platform/accelerator.py``. The port runs on
CUDA unless the caller asks for the CPU by name: an entry point given no
device and finding no card raises instead of carrying on quietly on the
host, so a run that meant to measure the card can never measure the CPU.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import torch

DeviceLike = Optional["str | torch.device"]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); ``"cpu"`` → the host;
    ``"cuda"`` / ``"cuda:N"`` → that card (raises without one)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch: no CUDA device is available. Entry "
                "points run on the card unless the caller passes "
                "device='cpu' explicitly.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def nvidia_smi_line(timeout: float = 20.0) -> Optional[str]:
    """``name, power.limit`` of the first card as nvidia-smi prints it
    (``--query-gpu=name,power.limit --format=csv,noheader``), or None
    where nvidia-smi is missing."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    res = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=timeout, check=False)
    if res.returncode != 0:
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_report() -> dict:
    """Name, count and power limit of the cards this process sees."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_report: no CUDA device is available")
    return {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": nvidia_smi_line()}
