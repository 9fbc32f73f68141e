"""Device and dtype policy of the port.

State and coefficients are f32 on the card (f64 in the parity tests); every
global reduction (dot products, norms, the Newton convergence norm)
accumulates in f64 when the state is f32.  At 3M+ unknowns an f32
accumulation loses about half its digits, and the Newton tolerance and the
FGMRES residual estimate need them.

There is no hidden global device: every function takes its device from its
tensor arguments or from an explicit ``device`` argument.
"""

from __future__ import annotations

import torch


def reduce_dtype(dtype: torch.dtype) -> torch.dtype:
    """f64 for f32 inputs, the input dtype otherwise."""
    return torch.float64 if dtype == torch.float32 else dtype


def require_cuda(device: torch.device | str = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise when it asks for CUDA
    and this process has no CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is False"
        )
    return device
