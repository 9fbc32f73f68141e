"""Hand-written CUDA kernels of the port and their launch counters.

The wrappers live in ``kernels/stencil.py`` (block matvec, scalar matvec,
Chebyshev smooth, red-black block Gauss–Seidel sweep),
``kernels/residual.py`` (fused two-phase residual) and
``kernels/deep_cycle.py`` (fused multigrid coarse subtree).
Importing builds nothing: the CUDA library is compiled and loaded at the
first launch on a CUDA tensor (``kernels/_lib.py``).  This package module
imports its submodules only inside functions, because ``core/stencil.py``
imports ``kernels/stencil.py`` while the models import ``core``.
"""


def wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from thermalporous_torch.kernels.deep_cycle import deep_correction
    from thermalporous_torch.kernels.residual import fused_residual
    from thermalporous_torch.kernels.stencil import (
        block_matvec,
        chebyshev_smooth,
        fused_block_rbgs,
        matvec,
    )

    return {
        "block_matvec": block_matvec,
        "matvec": matvec,
        "chebyshev_smooth": chebyshev_smooth,
        "fused_residual": fused_residual,
        "fused_block_rbgs": fused_block_rbgs,
        "deep_correction": deep_correction,
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
