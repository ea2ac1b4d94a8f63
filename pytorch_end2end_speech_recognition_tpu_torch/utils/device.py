"""Device selection, the card's identity and its published peaks.

The port's entry points run on CUDA unless the caller asks for the CPU; a
request for CUDA on a machine without a card raises instead of falling back.
"""

from __future__ import annotations

import subprocess

import torch

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit: bf16 tensor cores, float32 outside the tensor cores, HBM3.
H100_PEAKS = {
    "bf16_flops": 989e12,
    "fp32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


def resolve(device=None) -> torch.device:
    """`device` (None -> 'cuda') as a torch.device; raises when CUDA is
    asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def card_info() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (first card only)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def set_tf32(enabled: bool) -> None:
    """Set both TF32 switches explicitly: float32 matmuls and cuDNN
    convolutions. Off wherever float32 results are compared."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
