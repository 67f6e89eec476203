"""The device a harness entry point runs on, and what its records say of it.

``resolve`` refuses a CUDA device when there is no card: the bench, the
experiments and the CLI never fall back to the CPU.  ``name`` is the CSV
rows' ``device`` (the card's name, or "cpu"; their ``backend`` is the
device type), and ``card_info`` the environment a measurement is printed
beside: nvidia-smi's name and power limit, torch's CUDA version
and nvcc's.
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device; SystemExit with a message if it is a
    CUDA device and torch sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {device} (torch.cuda.is_available() is "
                         "False); --device cpu runs the kernels' plain PyTorch versions")
    return dev


def name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _lines(cmd) -> list[str]:
    """The output lines of cmd, none if it cannot run."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.stdout.strip().splitlines()]


def card_info(device) -> dict:
    """The card's name and power limit as nvidia-smi prints them, torch's
    version and CUDA version, and nvcc's release line (None on the CPU)."""
    dev = torch.device(device)
    info = {"device": name(dev), "torch": torch.__version__, "torch_cuda": torch.version.cuda,
            "nvidia_smi": None, "nvcc": None}
    if dev.type == "cuda":
        from fpr_tpu_torch import kernels

        index = dev.index if dev.index is not None else torch.cuda.current_device()
        smi = _lines(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
        info["nvidia_smi"] = smi[index] if index < len(smi) else (smi[0] if smi else None)
        try:
            nvcc = _lines([kernels._nvcc(), "--version"])
        except RuntimeError:  # no nvcc found
            nvcc = []
        info["nvcc"] = nvcc[-1] if nvcc else None
    return info
