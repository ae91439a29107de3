"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. With no
card present it raises; it never carries on quietly on the CPU. Only an
explicit ``device="cpu"`` (what the CPU tests pass) runs the plain PyTorch
versions of the kernels.

TF32 is turned off for matrix products and convolutions: the denoiser's
≤1e-4 per-sample parity budget against the NumPy oracle needs full f32
arithmetic wherever the output depends on it.
"""

from __future__ import annotations

import torch


def _disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_disable_tf32()


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        _disable_tf32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
