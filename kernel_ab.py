"""Time the stencil kernels of this checkout against another one's on one
NVIDIA GPU, in turns (other, this, this, other), each turn in a process of
its own that builds and loads its checkout's kernels.

    python3 kernel_ab.py --other DIR [--json PATH]

DIR is a second checkout of the repository (for example the parent commit
unpacked with ``git archive``).  Each turn takes the flagship's Jacobian
(``tp_spe10_full``, 60x220x85, f32, perturbed state, the subtree fused
from 145.2k cells) through that checkout's ``chip_smoke.preset_state`` and
times, on the card alone (``chip_smoke.time_device_ms``): the block matvec
(nc = k = 3), the scalar matvec (the T<-p coupling), the smooth on the
finest pressure level (degree 4 from x0 and from zero), the stage 2 (k =
2), the red half-sweep, the fused subtree (pressure K-cycle, temperature
V-cycle) and one CPTR apply.  Prints one line per kernel with the four
turns' milliseconds, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent


def worker(tree: str) -> dict:
    """One turn in checkout ``tree``: {case: card ms}."""
    sys.path.insert(0, tree)
    import dataclasses

    import torch

    import chip_smoke as cs
    from thermalporous_torch.core.stencil import apply_blocks
    from thermalporous_torch.kernels import _lib
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.cpr import cpr_apply
    from thermalporous_torch.precond.gmg import _fusable, _fused_correction

    _lib.build()
    _lib.load()
    dev = torch.device("cuda")
    _, _, _, pc, st, state = cs.preset_state("tp_spe10_full", torch.float32, dev,
                                             dict(fuse_below=cs.FLAGSHIP_FUSE_BELOW))
    grid = st.grid_shape
    g = torch.Generator(device=dev).manual_seed(21)
    rand = lambda shape: torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
    v3, r, x0, b = rand((3,) + grid), rand((3,) + grid), rand((3,) + grid), rand(grid)
    fine, lam = state.gmg_p.stencils[0].packed, state.gmg_p.lam_max[0]
    x1 = apply_blocks(state.w, r)[0:2].contiguous()
    calls = {
        "block_matvec nc=k=3": lambda: kst.block_matvec(st.coef, v3, 3),
        "matvec T<-p": lambda: kst.matvec(state.a_tp.packed, b),
        "chebyshev deg=4 x0": lambda: kst.chebyshev_smooth(fine, b, x0[0], lam, 4, 0.3),
        "chebyshev deg=4 zero": lambda: kst.chebyshev_smooth(fine, b, None, lam, 4, 0.3),
        "fused_stage2_rbgs k=2": lambda: kst.fused_stage2_rbgs(st.coef, state.dinv, r, x1),
        "block_rbgs_half_sweep red": lambda: kst.block_rbgs_half_sweep(st.coef, state.dinv,
                                                                       r, x0, 0),
        "cpr_apply": lambda: cpr_apply(state, r, pc),
    }
    for hname, hier, hcfg in (("p", state.gmg_p, pc.gmg), ("T", state.gmg_t, pc.gmg_t)):
        entry = next(l for l in range(1, len(hier.stencils))
                     if _fusable(hier, l, hcfg, torch.float32))
        rc = rand(hier.stencils[entry].grid_shape)
        calls[f"deep_correction {hname} {hcfg.cycle_type}-cycle"] = (
            lambda hier=hier, entry=entry, rc=rc, hcfg=hcfg:
            _fused_correction(hier, entry, rc, dataclasses.replace(hcfg)))
    return {name: cs.time_device_ms(fn, reps=30) for name, fn in calls.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout")
    ap.add_argument("--json", help="also write the record to this path")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    import torch

    if not torch.cuda.is_available() or args.other is None:
        print("kernel_ab: needs a CUDA device and --other", file=sys.stderr)
        return 2
    other = str(pathlib.Path(args.other).resolve())
    turns = []
    for label, tree in (("other", other), ("this", str(HERE)), ("this", str(HERE)),
                        ("other", other)):
        out = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                              "--worker", tree], cwd=tree, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        turns.append((label, json.loads(out.stdout.strip().splitlines()[-1])))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0])
    for name in turns[0][1]:
        print(f"{name}: " + ", ".join(f"{label} {t[name]:.4f}" for label, t in turns)
              + " ms on the card")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"device": smi.stdout.strip(), "turns": turns}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
