"""Hand-written CUDA kernels of the port and their launch counters.

The wrappers live in ``kernels/stencil.py`` (block matvec, scalar matvec,
Chebyshev smooth, red-black stage 2 and half-sweep),
``kernels/residual.py`` (fused residual and J·v of each model) and
``kernels/deep_cycle.py`` (fused multigrid coarse subtree).
Importing builds nothing: the CUDA library is compiled and loaded at the
first launch on a CUDA tensor (``kernels/_lib.py``).  This package module
imports its submodules only inside functions, because ``core/stencil.py``
imports ``kernels/stencil.py`` while the models import ``core``.
"""


def wrappers() -> dict:
    """Every kernel wrapper of the port, by the name of its launch counter
    (the residual and J·v wrappers keep one counter per model form, in
    ``kernels/residual.py``'s ``launches``)."""
    from thermalporous_torch.kernels.deep_cycle import deep_correction
    from thermalporous_torch.kernels.residual import fused_jvp, fused_residual
    from thermalporous_torch.kernels.stencil import (
        block_matvec,
        block_rbgs_half_sweep,
        chebyshev_smooth,
        fused_stage2_rbgs,
        matvec,
    )

    return {
        "block_matvec": block_matvec,
        "matvec": matvec,
        "chebyshev_smooth": chebyshev_smooth,
        "fused_residual": fused_residual,
        "fused_residual_sp": fused_residual,
        "fused_stage2_rbgs": fused_stage2_rbgs,
        "block_rbgs_half_sweep": block_rbgs_half_sweep,
        "deep_correction": deep_correction,
        "fused_jvp": fused_jvp,
        "fused_jvp_sp": fused_jvp,
    }


def launch_counts() -> dict[str, int]:
    from thermalporous_torch.kernels.residual import launches

    return {name: launches[name] if name in launches else fn.launches
            for name, fn in wrappers().items()}


def variant_counts() -> dict[str, int]:
    """Launches of the kernels' bf16-coefficient and batched instantiations
    ("<wrapper> bf16", "<wrapper> batched"), each also counted in
    :func:`launch_counts` under its wrapper."""
    from thermalporous_torch.kernels.stencil import variant_launches

    return dict(variant_launches)


def second_output_counts() -> dict[str, int]:
    """Second outputs of the smooth kernel by kind ("residual", "product"):
    scalar matvecs that ran inside a smooth's launch, not as ``matvec``."""
    from thermalporous_torch.kernels.stencil import second_outputs

    return dict(second_outputs)


def reset_launch_counts() -> None:
    from thermalporous_torch.kernels.residual import launches
    from thermalporous_torch.kernels.stencil import second_outputs, variant_launches

    for name, fn in wrappers().items():
        if name in launches:
            launches[name] = 0
        else:
            fn.launches = 0
    for kind in second_outputs:
        second_outputs[kind] = 0
    variant_launches.clear()
