"""Drive thermalporous_torch on one NVIDIA GPU, phase by phase.

    python3 chip_smoke.py [--json PATH]

Phases (each prints one line with its wall time):
  0  device: CUDA device name, and name/power limit from nvidia-smi;
  1  build: compile csrc/*.cu with nvcc (into thermalporous_torch/_build/);
  2  kernel parity at the main path's shapes: each hand-written kernel
     against its plain PyTorch version on the card, f32 and f64, with the
     max relative error and the median time of each; then the same on a 3D
     case with gravity (60x220x85, the SPE10 size);
  3  slice parity: the benchmark configuration at 32x32, f64, 3 steps, on the
     GPU and on the CPU: Newton and FGMRES counts per step must agree;
  4  main path: the benchmark workload (two-phase CPTR step, 1024x1024, f32):
     a 600 s step, then 3 dt-doubling steps with the benchmark's cutback
     rule; per-step counts and walls, cell-updates/s, and each kernel's
     launch count in that run (each must be > 0).

Then a JSON line with one record per kernel, and as the last line
{"ok": true, "device": {...}}.  Any failure exits nonzero without the ok
line; without CUDA the script exits nonzero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances, as max|kernel - plain| / max|plain| over each output component.
TOL_F64 = 1e-12
# f32 stencils: same op order and rounding (built with --fmad=false), so any
# difference would be a bug; the bound leaves room for nothing but ulps.
TOL_F32_STENCIL = 1e-5
# f32 residual: exp10f/expf in the kernel and the library pow/exp of the
# plain version differ by up to 2 ulp (~2.4e-7 relative in mu_w, mu_o), and
# the residual sums accumulation and flux terms much larger than itself.
TOL_F32_RESIDUAL = 1e-4

N_MAIN = 1024          # bench.py grid
N_SLICE = 32           # phase-3 grid
SLICE_COARSE = 16      # phase-3 max_coarse_cells: keeps a 4-level hierarchy at 32^2
KERNEL_SOURCES = {
    "block_matvec": ("thermalporous_torch/csrc/stencil.cu",
                     "thermalporous_tpu/kernels/stencil_pallas.py:207"),
    "matvec": ("thermalporous_torch/csrc/stencil.cu",
               "thermalporous_tpu/kernels/stencil_pallas.py:155"),
    "chebyshev_smooth": ("thermalporous_torch/csrc/stencil.cu",
                         "thermalporous_tpu/kernels/stencil_pallas.py:317"),
    "fused_residual": ("thermalporous_torch/csrc/residual.cu",
                       "thermalporous_tpu/kernels/residual_pallas.py:185"),
}


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[phase {name}] {time.perf_counter() - t0:.2f} s  {msg}", flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor, per_component: bool) -> tuple[float, float]:
    """(max|a-b|/max|b|, max|a-b|); with ``per_component`` the relative
    error is the largest over the leading (equation) axis."""
    d = (a - b).abs()
    if per_component:
        per = [float(d[c].max() / b[c].abs().max()) for c in range(a.shape[0])]
        return max(per), float(d.max())
    return float(d.max() / b.abs().max()), float(d.max())


def time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events, warmed up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bench_case(n: int, dtype, device):
    """The bench.py workload: grid, data, model, solver configuration."""
    from thermalporous_torch.core import Grid
    from thermalporous_torch.models import TwoPhaseModel, make_problem_data
    from thermalporous_torch.physics import PhysicalParams, Well

    pp = PhysicalParams()
    grid = Grid(shape=(n, n), spacing=(5.0, 5.0), thickness=10.0)
    rng = np.random.default_rng(11)
    kx = 2e-13 * np.exp(0.5 * rng.standard_normal(grid.shape))
    wells = [Well(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0),
             Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7)]
    data = make_problem_data(grid, pp, kx=kx, phi=0.2, wells=wells,
                             dtype=dtype, device=device)
    return TwoPhaseModel(grid, pp, s_init=0.2), data


def flagship_case(dtype, device):
    """A 3D two-phase case at the SPE10 size (60x220x85 = 1.12M cells) with
    gravity: the kernels' 3D path, which the 2D benchmark does not run."""
    from thermalporous_torch.core import Grid
    from thermalporous_torch.models import TwoPhaseModel, make_problem_data
    from thermalporous_torch.physics import PhysicalParams, Well

    pp = PhysicalParams()
    shape = (60, 220, 85)
    grid = Grid(shape=shape, spacing=(6.096, 3.048, 0.6096), gravity=9.81,
                depth_top=1000.0)
    rng = np.random.default_rng(12)
    kx = 2e-13 * np.exp(rng.standard_normal(shape))
    wells = [Well(cells=((0, 0, 40),), control="bhp", p_bh=4.0e7, T_inj=420.0),
             Well(cells=((59, 219, 40),), control="bhp", p_bh=1.0e7)]
    data = make_problem_data(grid, pp, kx=kx, kz=0.1 * kx, phi=0.2, wells=wells,
                             dtype=dtype, device=device)
    return TwoPhaseModel(grid, pp, s_init=0.2), data


def bench_configs(max_coarse_cells: int = 1024):
    from thermalporous_torch.precond import CPRConfig, GMGConfig
    from thermalporous_torch.solve import NewtonConfig

    cfg = NewtonConfig(rtol=1e-4, atol=2e-5, ksp_rtol=1e-2, ksp_maxiter=24,
                       max_iters=14, pc_lag="every", krylov_op="stencil",
                       ksp_basis="bf16", ksp_orth="cgs2g")
    pc = CPRConfig(stage2_cols=True,
                   gmg=GMGConfig(cycle_type="k", max_coarse_cells=max_coarse_cells,
                                 degree=4),
                   gmg_t=GMGConfig(cycle_type="v", max_coarse_cells=max_coarse_cells,
                                   degree=2))
    return cfg, pc


def perturbed_state(model, data, seed: int = 5):
    u0 = model.initial_state(data)
    rng = np.random.default_rng(seed)
    amp = np.array([1e5, 5.0, 0.1]).reshape((3,) + (1,) * (u0.dim() - 1))
    du = torch.as_tensor(amp * rng.standard_normal(tuple(u0.shape)),
                         dtype=u0.dtype, device=u0.device)
    return u0, (u0 + du).contiguous()


def kernel_cases(model, data, pc, tol_st, tol_res, dev):
    """(label, kernel name, kernel call, plain call, tolerance) at the
    shapes the step gives each kernel on this problem."""
    from thermalporous_torch.kernels import residual as kres
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.cpr import cpr_setup

    u0, u = perturbed_state(model, data)
    st = model.assemble_stencil(u, u0, 600.0, data)
    state = cpr_setup(st, pc)
    fine, coarse = state.gmg_p.stencils[0], state.gmg_p.stencils[-1]
    lam = state.gmg_p.lam_max[0]
    grid, dtype = st.grid_shape, st.coef.dtype
    g = torch.Generator(device=dev).manual_seed(3)
    rand = lambda shape: torch.randn(shape, generator=g, dtype=dtype, device=dev)
    v, b, x0, vc = rand((3,) + grid), rand(grid), rand(grid), rand(coarse.grid_shape)
    gs = "x".join(map(str, grid))
    cases = []
    for k in (3, 2):
        vk = v[:k].contiguous()
        cases.append((f"block_matvec k={k} {gs}", "block_matvec",
                      lambda vk=vk, k=k: kst.block_matvec(st.coef, vk, k),
                      lambda vk=vk: kst.block_matvec_plain(st.coef, vk), tol_st))
    for s, vv in ((fine, b), (coarse, vc)):
        label = "x".join(map(str, s.grid_shape))
        cases.append((f"matvec {label}", "matvec",
                      lambda s=s, vv=vv: kst.matvec(s.packed, vv),
                      lambda s=s, vv=vv: kst.matvec_plain(s.packed, vv), tol_st))
    for deg in (4, 2):
        for xx, xs in ((x0, "x0"), (None, "zero")):
            args = (fine.packed, b, xx, lam, deg, 0.3)
            cases.append((f"chebyshev deg={deg} {xs} {gs}", "chebyshev_smooth",
                          lambda a=args: kst.chebyshev_smooth(*a),
                          lambda a=args: kst.chebyshev_smooth_plain(*a), tol_st))
    cases.append((f"fused_residual {gs}", "fused_residual",
                  lambda: kres.fused_residual(model, u, u0, 600.0, data),
                  lambda: model.residual(u, u0, 600.0, data), tol_res))
    return cases


def kernel_parity(dev) -> dict:
    """Phase 2: each kernel against its plain version, at the benchmark's
    2D shapes and on a 3D case."""
    _, pc = bench_configs()
    rec = {}
    for dtype in (torch.float64, torch.float32):
        tname = "f64" if dtype == torch.float64 else "f32"
        tol_st = TOL_F64 if dtype == torch.float64 else TOL_F32_STENCIL
        tol_res = TOL_F64 if dtype == torch.float64 else TOL_F32_RESIDUAL
        for make in (lambda: bench_case(N_MAIN, dtype, dev),
                     lambda: flagship_case(dtype, dev)):
            model, data = make()
            for label, kname, kern, plain, tol in kernel_cases(
                    model, data, pc, tol_st, tol_res, dev):
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                rel, abs_ = rel_err(got, ref, kname in ("block_matvec",
                                                        "fused_residual"))
                ok = math.isfinite(rel) and rel <= tol and bool(torch.isfinite(got).all())
                ms, plain_ms = time_ms(kern), time_ms(plain)
                print(f"  {tname} {label}: max_rel_err {rel:.3e} (tol {tol:.0e}) "
                      f"max_abs_err {abs_:.3e}  kernel {ms:.4f} ms  plain "
                      f"{plain_ms:.4f} ms  {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise SystemExit(f"parity breach: {tname} {label}")
                # the record keeps each kernel's first case at the benchmark's
                # shape in f32
                if dtype == torch.float32 and kname not in rec:
                    rec[kname] = {"max_abs_err": abs_, "max_rel_err": rel,
                                  "ms": ms, "plain_ms": plain_ms, "case": label}
            del model, data
            torch.cuda.empty_cache()
    return rec


def run_steps(step, model, data, dt0: float, n_double: int, sync):
    """The bench.py schedule: dt0, then n_double doubling steps with up to 6
    halvings each; returns per-step records and the final state."""
    u = model.initial_state(data)
    recs = []
    dt = dt0
    for i in range(n_double + 1):
        if i > 0:
            dt *= 2.0
        t0 = time.perf_counter()
        u_new, stats = step(u, dt, data)
        retries = 0
        while not stats.converged and retries < 6 and i > 0:
            dt *= 0.5
            retries += 1
            u_new, stats = step(u, dt, data)
        sync()
        wall = time.perf_counter() - t0
        if not stats.converged:
            raise SystemExit(f"step {i} (dt={dt}) did not converge")
        recs.append({"step": i, "dt": dt, "newton": stats.iters,
                     "fgmres": stats.ksp_iters, "retries": retries,
                     "wall_s": wall, "norm": stats.norm})
        u = u_new
    return recs, u


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the full record to this path")
    args = ap.parse_args()

    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from thermalporous_torch import require_cuda
    from thermalporous_torch.kernels import _lib, launch_counts, reset_launch_counts
    from thermalporous_torch.solve import make_step_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # (0) device
    t0 = time.perf_counter()
    dev = require_cuda("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("0 device", t0, f"{name}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"count {torch.cuda.device_count()}")

    # (1) build
    t0 = time.perf_counter()
    path, secs, log = _lib.build()
    _lib.load()
    for line in log.splitlines():
        if "Used" in line or "error" in line.lower():
            print("  " + line.strip())
    phase("1 build", t0, f"nvcc {secs:.1f} s -> {path}")

    # (2) kernel parity at the main path's shapes
    t0 = time.perf_counter()
    krec = kernel_parity(dev)
    phase("2 kernel parity", t0, "all kernels within tolerance")

    # (3) slice parity, GPU against CPU
    t0 = time.perf_counter()
    cfg, pc = bench_configs(max_coarse_cells=SLICE_COARSE)
    counts = {}
    for d in ("cpu", "cuda"):
        model, data = bench_case(N_SLICE, torch.float64, d)
        step = make_step_fn(model, "cptr", cfg, pc, device=d)
        sync = torch.cuda.synchronize if d == "cuda" else (lambda: None)
        recs, _ = run_steps(step, model, data, 600.0, 2, sync)
        counts[d] = [(r["newton"], r["fgmres"]) for r in recs]
    if counts["cpu"] != counts["cuda"]:
        raise SystemExit(f"slice parity: cpu {counts['cpu']} != cuda {counts['cuda']}")
    phase("3 slice parity", t0, f"{N_SLICE}^2 f64 (newton, fgmres) per step: "
          f"cpu {counts['cpu']} == cuda {counts['cuda']}")

    # (4) main path
    t0 = time.perf_counter()
    cfg, pc = bench_configs()
    model, data = bench_case(N_MAIN, torch.float32, dev)
    step = make_step_fn(model, "cptr", cfg, pc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    recs, u = run_steps(step, model, data, 600.0, 3, torch.cuda.synchronize)
    launches = launch_counts()
    for r in recs:
        print(f"  step {r['step']} dt {r['dt']:.0f} s: newton {r['newton']} "
              f"fgmres {r['fgmres']} retries {r['retries']} wall {r['wall_s']:.3f} s")
    ncells = N_MAIN * N_MAIN
    doubling = recs[1:]
    cu_s = ncells * sum(r["newton"] for r in doubling) / sum(r["wall_s"] for r in doubling)
    s, t = u[2], u[1]
    sane = (tuple(u.shape) == (3, N_MAIN, N_MAIN) and bool(torch.isfinite(u).all())
            and float(s.min()) >= -1e-3 and float(s.max()) <= 1.0 + 1e-3
            and float(t.min()) >= 300.0 - 1.0 and float(t.max()) <= 420.0 + 1.0)
    print(f"  launches {launches}")
    print(f"  S in [{float(s.min()):.4f}, {float(s.max()):.4f}], "
          f"T in [{float(t.min()):.2f}, {float(t.max()):.2f}] K")
    if not sane:
        raise SystemExit("main path: state out of physical bounds or not finite")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise SystemExit(f"main path launched no {missing}")
    phase("4 main path", t0, f"{N_MAIN}^2 f32: {cu_s:.1f} cell-updates/s over the "
          f"{len(doubling)} doubling steps; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCES[k][0],
                "replaces": KERNEL_SOURCES[k][1], "launches": launches[k],
                "max_abs_err": krec[k]["max_abs_err"], "ms": krec[k]["ms"],
                "plain_ms": krec[k]["plain_ms"]} for k in KERNEL_SOURCES]
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"device": smi, "kernels": kernels, "kernel_cases": krec,
                       "slice_counts": counts, "main_steps": recs,
                       "cell_updates_per_s": cu_s,
                       "total_s": time.perf_counter() - t_all}, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
