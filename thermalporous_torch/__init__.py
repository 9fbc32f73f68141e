"""thermalporous_torch: the PyTorch / CUDA port of ``thermalporous_tpu``.

A fully implicit (backward-Euler) thermal reservoir simulator: TPFA finite
volumes on structured 2D/3D grids, a two-phase (p, T, S_w) model with
Peaceman wells, Newton with line search, FGMRES, and the CPTR two-stage
preconditioner (Quasi-IMPES decoupling, geometric multigrid on the pressure
and temperature blocks, block-Jacobi stage 2).

The JAX package ``thermalporous_tpu`` is the reference; this package imports
neither it nor ``jax``.  Its hot spots are hand-written CUDA kernels for the
NVIDIA H100 (``csrc/``, wrapped in ``kernels/``); on CPU tensors every
kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from thermalporous_torch._device import reduce_dtype, require_cuda
from thermalporous_torch.core.grid import Grid
from thermalporous_torch.physics.props import PhysicalParams

__all__ = ["Grid", "PhysicalParams", "__version__", "reduce_dtype", "require_cuda"]
