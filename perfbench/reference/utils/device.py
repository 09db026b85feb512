"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU.  With
no GPU and no CPU request it raises: the port never carries on quietly on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    implied) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (or --cpu on the CLI) "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """Full-precision float32 products and convolutions.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits).  The VAD's convolutions run in float32 and its probabilities
    feed hysteresis thresholds, and the loudness meter's 2048-tap FIR is a
    float32 convolution too, so the pipeline path turns TF32 off for both
    matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def eval_device(cpu: bool) -> tuple[str | None, str] | None:
    """The device and the device line of an evaluation script:
    ``("cpu", "cpu")`` under ``--cpu``; on the card ``(None, its name and
    power limit as nvidia-smi gives them)``; None when no card is present
    (the script then refuses to run)."""
    import subprocess

    if cpu:
        return "cpu", "cpu"
    if not torch.cuda.is_available():
        return None
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return None, line
