"""Drive thermalporous_torch on one NVIDIA GPU, phase by phase.

    python3 chip_smoke.py [--json PATH]

Phases (each prints one line with its wall time):
  0  device: CUDA device name, and name/power limit from nvidia-smi;
  1  build: compile csrc/*.cu with nvcc (one process per source, all
     started together) into thermalporous_torch/_build/;
  2  kernel parity at the main paths' shapes: each hand-written kernel
     against its plain PyTorch version on the card, f32 and f64, with the
     max relative error and the median time of each, on the benchmark's
     1024x1024 case and on the flagship (tp_spe10_full, 60x220x85): there
     also the red-black Gauss-Seidel stage 2 on the flagship Jacobian, the
     fused coarse subtree at the entry levels of the pressure and
     temperature hierarchies, each kernel's bound, a torch.sparse.mm
     yardstick for the two matvecs, and the CPTR apply with the subtree
     fused from the ~36k-cell level, from the ~5k-cell level and unfused;
  3  slice parity: the benchmark configuration at 32x32, f64, 3 steps, on the
     GPU and on the CPU: Newton and FGMRES counts per step must agree;
  4  main path: the benchmark workload (two-phase CPTR step, 1024x1024, f32):
     a 600 s step, then 3 dt-doubling steps with the benchmark's cutback
     rule; per-step counts and walls, cell-updates/s, and each kernel's
     launch count in that run (each must be > 0);
  5  flagship parity: tp_spe10_full's configuration on a 12x22x9 synthetic
     SPE10 grid, f64, through the Simulator on the GPU and on the CPU for 3
     controller steps: accepted dt, Newton and FGMRES counts must agree;
  6  flagship: tp_spe10_full at 60x220x85, f32, Simulator.run for the first
     4 controller steps from dt_init = 600 s; per-step counts and walls,
     cell-updates/s, peak memory, S and T bounds, and the launch count of
     every kernel in that run (each must be > 0);
  7  flagship layers: the phase-6 run again with synchronized timers
     around each layer (assembly, CPTR setup, FGMRES, CPTR apply, residual),
     and the device's busy share over one more step from the profiler.

Then the card's name and power limit, a JSON line with one record per
kernel (its flagship f32 case and its launches in phase 6), and as the
last line {"ok": true, "device": {...}}.  Any failure exits nonzero without
the ok line; without CUDA the script exits nonzero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# coarse subtree: the K-cycle's dot products (block reductions against
# torch.dot) and the dense coarsest solve (one warp per row against torch.mv)
# sum in another order; every other pass rounds as the plain version does.
# The CG(2) coefficients carry those last-bit differences into the result.
TOL_F64_DEEP = 1e-11
TOL_F32_DEEP = 1e-4

N_MAIN = 1024          # bench.py grid
N_SLICE = 32           # phase-3 grid
SLICE_COARSE = 16      # phase-3 max_coarse_cells: keeps a 4-level hierarchy at 32^2
FLAGSHIP_SMALL = (12, 22, 9)   # phase-5 grid
# phase 5: coarsest levels of at most 16 cells keep >= 3 levels in both
# hierarchies, K-cycles from 256 cells run at this size, and the subtree
# below 300 cells is fused
SMALL_GMG = dict(max_coarse_cells=16, kcycle_min_cells=256, fuse_below=300)
FLAGSHIP_STEPS = 4
# fuse_below candidates on the flagship hierarchies: the ~36k-cell and the
# ~5k-cell levels of the adaptive pressure hierarchy are the entries
FUSE_CANDIDATES = (40_000, 6_000)
# fuse_below of the phase-6 flagship run, on both hierarchies: the CPTR
# apply was fastest with the subtree fused from the ~36k-cell level
# (phase 2's apply times; PERF.md has the numbers)
FLAGSHIP_FUSE_BELOW = 40_000

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and FP32 outside the
# tensor cores; the bound of a call is the larger of bytes/peak and ops/peak
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
KERNEL_SOURCES = {
    "block_matvec": ("thermalporous_torch/csrc/stencil.cu",
                     "thermalporous_tpu/kernels/stencil_pallas.py:207"),
    "matvec": ("thermalporous_torch/csrc/stencil.cu",
               "thermalporous_tpu/kernels/stencil_pallas.py:155"),
    "chebyshev_smooth": ("thermalporous_torch/csrc/stencil.cu",
                         "thermalporous_tpu/kernels/stencil_pallas.py:317"),
    "fused_residual": ("thermalporous_torch/csrc/residual.cu",
                       "thermalporous_tpu/kernels/residual_pallas.py:185"),
    "fused_block_rbgs": ("thermalporous_torch/csrc/rbgs.cu",
                         "thermalporous_tpu/kernels/stencil_pallas.py:408"),
    "deep_correction": ("thermalporous_torch/csrc/deep_cycle.cu",
                        "thermalporous_tpu/kernels/deep_cycle.py:289"),
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


def time_cold_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn()`` with the L2 cache flushed before each
    call (a 256 MiB write between the calls), as a call meets it inside a
    step whose fine-level passes have just streamed through the cache."""
    flush = torch.empty(2**26, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


# ------------------------------------------------------------------ bounds
#
# Each kernel's least time on the card: the bytes its function must move
# (each input it needs read once, each output written once) over the HBM
# rate, against its operations over the FP32 rate.  ``n`` cells, ``dim``
# axes, ``item`` bytes per value.

def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def cost_block_matvec(n, dim, nc, k, item):
    return (((2 * dim + 1) * nc * k + k + nc) * n * item,
            2 * (2 * dim + 1) * nc * k * n)


def cost_matvec(n, dim, item):
    return (2 * dim + 3) * n * item, 2 * (2 * dim + 1) * n


def cost_chebyshev(n, dim, degree, from_x0, item):
    mv = 2 * (2 * dim + 1) * n
    ops = (mv if from_x0 else 0) + 3 * n + (degree - 1) * (mv + 7 * n) + n
    return (2 * dim + 3 + int(from_x0)) * n * item, ops


def cost_residual(n, dim, item):
    # operations per cell counted from the plain version: ~200 cell-term and
    # ~100 per-face arithmetic operations, 5 + 8·dim transcendentals (pow,
    # exp), each counted as 16 (the SM's FP32 : special-function rate)
    ops = (200 + 100 * dim + 16 * (5 + 8 * dim)) * n
    return (3 + 3 + (2 * dim + 7) + 3) * n * item, ops


def cost_rbgs(n, dim, nc, item):
    # the output needs the off-diagonal blocks of the black cells only (half
    # the cells), D^-1 and b everywhere
    return ((n // 2) * 2 * dim * nc * nc + (nc * nc + 2 * nc) * n) * item, \
        (n // 2) * 2 * dim * 2 * nc * nc + 4 * nc * nc * n


def cost_deep(shapes, degree, cycle_type, kmin, item):
    """Bytes: every level's stencil, the dense inverse, rc and the output,
    once.  Operations: the recursion's passes, walked as the kernel walks
    them."""
    sizes = [math.prod(s) for s in shapes]
    last = len(shapes) - 1
    mv = [2 * (2 * len(s) + 1) * m for s, m in zip(shapes, sizes)]

    def smooth(ell, zero):
        n = sizes[ell]
        return (0 if zero else mv[ell] + n) + 3 * n + (degree - 1) * (mv[ell] + 7 * n) + n

    def cycle(ell):
        if ell == last:
            return 2 * sizes[ell] ** 2
        n = sizes[ell]
        return smooth(ell, True) + mv[ell] + 2 * n + corr(ell + 1) + n + smooth(ell, False)

    def corr(ell):
        ops = cycle(ell)
        if cycle_type == "k" and ell < last and sizes[ell] >= kmin:
            ops += cycle(ell) + 2 * mv[ell] + 16 * sizes[ell]
        return ops

    nbytes = (sum((2 * len(s) + 1) * m for s, m in zip(shapes, sizes))
              + sizes[-1] ** 2 + 2 * sizes[0]) * item
    return nbytes, corr(0)


# ------------------------------------------------------- library yardsticks

def block_csr(coef: torch.Tensor) -> torch.Tensor:
    """The block stencil as a CSR matrix over the (nc, *grid) layout."""
    nco, nc = coef.shape[0], coef.shape[1]
    grid = tuple(coef.shape[3:])
    n = math.prod(grid)
    dev = coef.device
    cell = torch.arange(n, device=dev).reshape(grid)
    rows, cols, vals = [], [], []
    strides = [math.prod(grid[a + 1:]) for a in range(len(grid))]
    for o in range(nco):
        if o == 0:
            valid, nb = torch.ones(grid, dtype=torch.bool, device=dev), cell
        else:
            a, up = (o - 1) // 2, (o - 1) % 2 == 0
            idx = torch.arange(grid[a], device=dev).reshape(
                [-1 if i == a else 1 for i in range(len(grid))])
            valid = (idx < grid[a] - 1 if up else idx > 0).expand(grid)
            nb = cell + (strides[a] if up else -strides[a])
        c, m = cell[valid], nb[valid]
        for i in range(nc):
            for j in range(nc):
                rows.append(i * n + c)
                cols.append(j * n + m)
                vals.append(coef[o, i, j][valid])
    a = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                torch.cat(vals), (nc * n, nc * n)).coalesce()
    return a.to_sparse_csr()


def spmv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sparse.mm(a, v.reshape(-1, 1))


# ------------------------------------------------------------------ cases

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


def with_fuse(pc, fuse_below: int, **gmg_overrides):
    """``pc`` with ``fuse_below`` (and other overrides) on both hierarchies."""
    return dataclasses.replace(
        pc, gmg=dataclasses.replace(pc.gmg, fuse_below=fuse_below, **gmg_overrides),
        gmg_t=dataclasses.replace(pc.gmg_t, fuse_below=fuse_below,
                                  **{k: v for k, v in gmg_overrides.items()
                                     if k != "kcycle_min_cells"}))


def perturbed_state(model, data, seed: int = 5):
    u0 = model.initial_state(data)
    rng = np.random.default_rng(seed)
    amp = np.array([1e5, 5.0, 0.1]).reshape((3,) + (1,) * (u0.dim() - 1))
    du = torch.as_tensor(amp * rng.standard_normal(tuple(u0.shape)),
                         dtype=u0.dtype, device=u0.device)
    return u0, (u0 + du).contiguous()


def kernel_cases(model, data, st, state, u0, u, tol_st, tol_res, dev):
    """(label, kernel name, kernel call, plain call, tolerance, (bytes, ops),
    library call or None) of the four step kernels at the shapes the step
    gives each of them on this problem."""
    from thermalporous_torch.kernels import residual as kres
    from thermalporous_torch.kernels import stencil as kst

    fine, coarse = state.gmg_p.stencils[0], state.gmg_p.stencils[-1]
    lam = state.gmg_p.lam_max[0]
    grid, dtype = st.grid_shape, st.coef.dtype
    n, dim, item = math.prod(grid), len(grid), st.coef.element_size()
    g = torch.Generator(device=dev).manual_seed(3)
    rand = lambda shape: torch.randn(shape, generator=g, dtype=dtype, device=dev)
    v, b, x0, vc = rand((3,) + grid), rand(grid), rand(grid), rand(coarse.grid_shape)
    gs = "x".join(map(str, grid))
    cases = []
    for k in (3, 2):
        vk = v[:k].contiguous()
        cases.append((f"block_matvec k={k} {gs}", "block_matvec",
                      lambda vk=vk, k=k: kst.block_matvec(st.coef, vk, k),
                      lambda vk=vk: kst.block_matvec_plain(st.coef, vk), tol_st,
                      cost_block_matvec(n, dim, 3, k, item),
                      ("block", v) if k == 3 else None))
    for s, vv in ((fine, b), (coarse, vc)):
        label = "x".join(map(str, s.grid_shape))
        cases.append((f"matvec {label}", "matvec",
                      lambda s=s, vv=vv: kst.matvec(s.packed, vv),
                      lambda s=s, vv=vv: kst.matvec_plain(s.packed, vv), tol_st,
                      cost_matvec(math.prod(s.grid_shape), dim, item),
                      ("scalar", s, vv) if s is fine else None))
    for deg in (4, 2):
        for xx, xs in ((x0, "x0"), (None, "zero")):
            args = (fine.packed, b, xx, lam, deg, 0.3)
            cases.append((f"chebyshev deg={deg} {xs} {gs}", "chebyshev_smooth",
                          lambda a=args: kst.chebyshev_smooth(*a),
                          lambda a=args: kst.chebyshev_smooth_plain(*a), tol_st,
                          cost_chebyshev(n, dim, deg, xx is not None, item), None))
    cases.append((f"fused_residual {gs}", "fused_residual",
                  lambda: kres.fused_residual(model, u, u0, 600.0, data),
                  lambda: model.residual(u, u0, 600.0, data), tol_res,
                  cost_residual(n, dim, item), None))
    return cases


def flagship_cases(st, state, pc, dtype, dev):
    """The stage-2 sweep on the flagship Jacobian, and the coarse subtree at
    the entry level that each FUSE_CANDIDATES value picks on each hierarchy
    (phase 6's value first: its cases make the kernel's record)."""
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.gmg import _fusable

    f64 = dtype == torch.float64
    grid = st.grid_shape
    n, item = math.prod(grid), st.coef.element_size()
    g = torch.Generator(device=dev).manual_seed(4)
    r2 = torch.randn((3,) + grid, generator=g, dtype=dtype, device=dev)
    gs = "x".join(map(str, grid))
    cases = [(f"fused_block_rbgs {gs}", "fused_block_rbgs",
              lambda: kst.fused_block_rbgs(st.coef, state.dinv, r2),
              lambda: kst.fused_block_rbgs_plain(st.coef, state.dinv, r2),
              TOL_F64 if f64 else TOL_F32_STENCIL, cost_rbgs(n, len(grid), 3, item), None)]
    fuse_values = (FLAGSHIP_FUSE_BELOW,) + tuple(f for f in FUSE_CANDIDATES
                                                 if f != FLAGSHIP_FUSE_BELOW)
    for fb in fuse_values:
        for hname, hier, hcfg in (("p", state.gmg_p, pc.gmg), ("T", state.gmg_t, pc.gmg_t)):
            cfg = dataclasses.replace(hcfg, fuse_below=fb)
            entry = next(l for l in range(1, len(hier.stencils))
                         if _fusable(hier, l, cfg, dtype))
            cases.append(deep_case(hname, hier, entry, cfg, item, g))
    return cases


def deep_case(hname, hier, entry, cfg, item, g):
    """The fused coarse subtree of ``hier`` from level ``entry`` on a random
    right-hand side, as a case of :func:`run_cases`."""
    from thermalporous_torch.kernels import deep_cycle as kdeep
    from thermalporous_torch.precond.gmg import _fused_correction

    shapes = [s.grid_shape for s in hier.stencils[entry:]]
    packed = [s.packed for s in hier.stencils[entry:]]
    rc = torch.randn(shapes[0], generator=g, dtype=packed[0].dtype, device=packed[0].device)
    kw = dict(degree=cfg.degree, lam_min_frac=cfg.lam_min_frac,
              cycle_type=cfg.cycle_type, kcycle_min_cells=cfg.kcycle_min_cells)
    cycle = cfg.cycle_type if math.prod(shapes[0]) >= cfg.kcycle_min_cells else "v"
    label = " -> ".join(str(math.prod(s)) for s in shapes)
    return (f"deep_correction {hname} {cycle}-cycle {label} cells", "deep_correction",
            lambda: _fused_correction(hier, entry, rc, cfg),
            lambda: kdeep.deep_correction_plain(packed, hier.lam_max[entry:],
                                                hier.coarse_inv, rc, **kw),
            TOL_F64_DEEP if item == 8 else TOL_F32_DEEP,
            cost_deep(shapes, cfg.degree, cfg.cycle_type, cfg.kcycle_min_cells, item), None)


def library_call(lib, st):
    """One PyTorch call computing the same function (torch.sparse.mm on a
    CSR of the operator), or None."""
    if lib is None:
        return None
    if lib[0] == "block":
        a, v = block_csr(st.coef), lib[1]
        return lambda: spmv(a, v)
    s, vv = lib[1], lib[2]
    a = block_csr(s.packed.reshape((s.packed.shape[0], 1, 1) + s.grid_shape))
    return lambda: spmv(a, vv)


def run_cases(tname, cases, st, rec, dtype, record: bool) -> None:
    for label, kname, kern, plain, tol, cost, lib in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        rel, abs_ = rel_err(got, ref, kname in ("block_matvec", "fused_residual",
                                                "fused_block_rbgs"))
        ok = math.isfinite(rel) and rel <= tol and bool(torch.isfinite(got).all())
        ms, plain_ms = time_ms(kern), time_ms(plain)
        # the coarse subtree is latency-bound: also time it on a cold L2
        cold_ms = time_cold_ms(kern) if kname == "deep_correction" else None
        bnd, by = bound_ms(*cost)
        lib_fn = library_call(lib, st) if record and kname not in rec else None
        lib_ms = time_ms(lib_fn) if lib_fn is not None else None
        print(f"  {tname} {label}: max_rel_err {rel:.3e} (tol {tol:.0e}) "
              f"max_abs_err {abs_:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"bound {bnd:.4f} ms ({by})"
              + (f"  cold L2 {cold_ms:.4f} ms" if cold_ms is not None else "")
              + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f"  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"parity breach: {tname} {label}")
        if record and kname not in rec:
            rec[kname] = {"max_abs_err": abs_, "max_rel_err": rel, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                          "library_ms": lib_ms, "cold_ms": cold_ms, "case": label}
        del got, ref


def fuse_apply_times(st, state, pc, dev) -> dict:
    """The CPTR apply on the flagship, unfused and with the subtree fused
    from each FUSE_CANDIDATES entry, in turns (0, a, b, b, a, 0)."""
    from thermalporous_torch.kernels import deep_cycle as kdeep
    from thermalporous_torch.precond.cpr import cpr_apply

    g = torch.Generator(device=dev).manual_seed(6)
    r = torch.randn((3,) + st.grid_shape, generator=g, dtype=st.coef.dtype, device=dev)
    order = (0,) + FUSE_CANDIDATES + FUSE_CANDIDATES[::-1] + (0,)
    times: dict[int, list] = {}
    for fb in order:
        cfg = with_fuse(pc, fb)
        kdeep.deep_correction.launches = 0
        cpr_apply(state, r, cfg)
        per_apply = kdeep.deep_correction.launches
        times.setdefault(fb, []).append(time_ms(lambda c=cfg: cpr_apply(state, r, c), reps=10))
        print(f"  CPTR apply fuse_below={fb}: {times[fb][-1]:.3f} ms "
              f"({per_apply} deep_correction launches per apply)", flush=True)
    return times


def kernel_parity(dev) -> dict:
    """Phase 2: each kernel against its plain version, at the benchmark's
    2D shapes and on the flagship; returns the flagship f32 record per
    kernel."""
    from thermalporous_torch.precond.cpr import cpr_setup, resolve_adaptive_coarsening
    from thermalporous_torch.presets import get_case

    _, bench_pc = bench_configs()
    rec: dict = {}
    fuse_times = None
    for dtype in (torch.float64, torch.float32):
        tname = "f64" if dtype == torch.float64 else "f32"
        tol_st = TOL_F64 if dtype == torch.float64 else TOL_F32_STENCIL
        tol_res = TOL_F64 if dtype == torch.float64 else TOL_F32_RESIDUAL
        # the benchmark's 2D case
        model, data = bench_case(N_MAIN, dtype, dev)
        u0, u = perturbed_state(model, data)
        st = model.assemble_stencil(u, u0, 600.0, data)
        state = cpr_setup(st, bench_pc)
        run_cases(tname, kernel_cases(model, data, st, state, u0, u, tol_st, tol_res, dev),
                  st, rec, dtype, record=False)
        del model, data, st, state, u0, u
        torch.cuda.empty_cache()
        # the flagship, with its baked coarsening schedule and the subtree
        # fused as in phase 6
        case = get_case("tp_spe10_full", device=dev, dtype=dtype)
        model, data = case.model, case.data
        u0, u = perturbed_state(model, data)
        pc = resolve_adaptive_coarsening(
            model.assemble_stencil(u0, u0, case.time_cfg.dt_init, data),
            with_fuse(case.pc_cfg, FLAGSHIP_FUSE_BELOW))
        st = model.assemble_stencil(u, u0, 600.0, data)
        state = cpr_setup(st, pc)
        for hname, hier in (("p", state.gmg_p), ("T", state.gmg_t)):
            print(f"  {tname} flagship {hname} hierarchy: "
                  + " -> ".join(str(math.prod(s.grid_shape)) for s in hier.stencils)
                  + " cells", flush=True)
        cases = (kernel_cases(model, data, st, state, u0, u, tol_st, tol_res, dev)
                 + flagship_cases(st, state, pc, dtype, dev))
        run_cases(tname, cases, st, rec, dtype, record=dtype == torch.float32)
        if dtype == torch.float32:
            fuse_times = fuse_apply_times(st, state, pc, dev)
        del case, model, data, st, state, u0, u
        torch.cuda.empty_cache()
    return rec, fuse_times


# -------------------------------------------------------------- main paths

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


def check_physical(u, shape, label: str) -> None:
    s, t = u[2], u[1]
    print(f"  S in [{float(s.min()):.4f}, {float(s.max()):.4f}], "
          f"T in [{float(t.min()):.2f}, {float(t.max()):.2f}] K")
    sane = (tuple(u.shape) == (3,) + tuple(shape) and bool(torch.isfinite(u).all())
            and float(s.min()) >= -1e-3 and float(s.max()) <= 1.0 + 1e-3
            and float(t.min()) >= 300.0 - 1.0 and float(t.max()) <= 420.0 + 1.0)
    if not sane:
        raise SystemExit(f"{label}: state out of physical bounds or not finite")


def flagship_parity() -> dict:
    """Phase 5: the flagship configuration at FLAGSHIP_SMALL, f64, through
    the Simulator on each device; the (dt, Newton, FGMRES, retries) records."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.presets import get_case

    out = {}
    for d in ("cpu", "cuda"):
        case = get_case("tp_spe10_full", device=d, dtype=torch.float64,
                        shape=FLAGSHIP_SMALL)
        sim = case.simulator(pc_cfg=with_fuse(case.pc_cfg, **SMALL_GMG))
        reset_launch_counts()
        res = sim.run(case.t_end, max_steps=3)
        out[d] = [(r.dt, r.newton_iters, r.ksp_iters, r.retries) for r in res.records]
        if d == "cuda":
            launches = launch_counts()
            print(f"  cuda launches {launches}")
            if launches["deep_correction"] <= 0:
                raise SystemExit("flagship parity: the fused subtree never ran")
    return out


def flagship_run(dev):
    """Phase 6: tp_spe10_full at full size, f32, the first FLAGSHIP_STEPS
    controller steps; returns (records, launches, Newton over all attempts,
    cell-updates/s, peak GiB)."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.presets import get_case

    case = get_case("tp_spe10_full", device=dev)
    sim = case.simulator(pc_cfg=with_fuse(case.pc_cfg, FLAGSHIP_FUSE_BELOW))
    for hname, g in (("p", sim.pc_cfg.gmg), ("T", sim.pc_cfg.gmg_t)):
        print(f"  schedule {hname}: {g.level_factors}")
    attempts = {"newton": 0, "attempts": 0}
    advance = sim._advance

    def counted(*args):
        u, st = advance(*args)
        attempts["newton"] += st.iters
        attempts["attempts"] += 1
        return u, st

    sim._advance = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res = sim.run(case.t_end, max_steps=FLAGSHIP_STEPS)
    torch.cuda.synchronize()
    launches = launch_counts()
    for r in res.records:
        print(f"  step {r.step} dt {r.dt:.1f} s: newton {r.newton_iters} "
              f"fgmres {r.ksp_iters} retries {r.retries} wall {r.wall_s:.3f} s "
              f"next dt {r.next_dt:.1f} s cap {r.dt_cap}")
    if res.steps < FLAGSHIP_STEPS:
        raise SystemExit(f"flagship: {res.steps} steps < {FLAGSHIP_STEPS}")
    later = res.records[1:]
    cu_s = (math.prod(case.model.grid.shape) * sum(r.newton_iters for r in later)
            / sum(r.wall_s for r in later))
    print(f"  launches {launches}; Newton iterations over all attempts "
          f"{attempts['newton']} in {attempts['attempts']} solves")
    check_physical(res.u, case.model.grid.shape, "flagship")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise SystemExit(f"flagship launched no {missing}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    return res.records, launches, attempts, cu_s, peak


def flagship_layers(dev) -> dict:
    """Phase 7: the phase-6 run again with a
    ``torch.cuda.synchronize()`` before and after each layer's call, so that
    host timers give each layer's wall; then one more step of the same Δt
    from the last state, timed plainly and under the profiler, whose CUDA
    kernel events give the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    from thermalporous_torch.presets import get_case
    from thermalporous_torch.solve import newton as tnewton
    from thermalporous_torch.solve import timeloop as ttimeloop

    wall: dict[str, float] = {}
    calls: dict[str, int] = {}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            wall[name] = wall.get(name, 0.0) + time.perf_counter() - t
            calls[name] = calls.get(name, 0) + 1
            return out
        return call

    real_solve, real_fgmres = ttimeloop.newton_solve, tnewton.fgmres

    def solve(*, residual, assemble, pc_setup, pc_apply, **kw):
        return real_solve(residual=timed("residual", residual),
                          assemble=timed("assembly", assemble),
                          pc_setup=timed("CPTR setup", pc_setup),
                          pc_apply=timed("CPTR apply", pc_apply), **kw)

    case = get_case("tp_spe10_full", device=dev)
    sim = case.simulator(pc_cfg=with_fuse(case.pc_cfg, FLAGSHIP_FUSE_BELOW))
    ttimeloop.newton_solve, tnewton.fgmres = solve, timed("FGMRES", real_fgmres)
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = sim.run(case.t_end, max_steps=FLAGSHIP_STEPS)
        total = time.perf_counter() - t
    finally:
        ttimeloop.newton_solve, tnewton.fgmres = real_solve, real_fgmres
    newton = sum(r.newton_iters for r in res.records)
    for name in ("assembly", "CPTR setup", "FGMRES", "CPTR apply", "residual"):
        print(f"  {name}: {wall.get(name, 0.0):.3f} s of {total:.3f} s "
              f"({100 * wall.get(name, 0.0) / total:.1f}%) in {calls.get(name, 0)} calls")

    dt = res.records[-1].dt
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, st = sim.step(res.u, dt)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.step(res.u, dt)
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"  one more step at dt {dt:.1f} s: newton {st.iters} fgmres {st.ksp_iters} "
          f"wall {step_s:.3f} s; CUDA kernel time under the profiler "
          f"{busy_us / 1e6:.3f} s = {100 * busy_us / 1e6 / step_s:.1f}% of that wall")
    return {"total_s": total, "newton": newton, "layer_s": wall, "layer_calls": calls,
            "step_s": step_s, "step_newton": st.iters, "step_fgmres": st.ksp_iters,
            "device_busy_s": busy_us / 1e6}


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
        if line.startswith("==") or "Used" in line or "error" in line.lower():
            print("  " + line.strip())
    phase("1 build", t0, f"nvcc {secs:.1f} s -> {path}")

    # (2) kernel parity at the main paths' shapes
    t0 = time.perf_counter()
    krec, fuse_times = kernel_parity(dev)
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

    # (4) main path: the benchmark step
    t0 = time.perf_counter()
    cfg, pc = bench_configs()
    model, data = bench_case(N_MAIN, torch.float32, dev)
    step = make_step_fn(model, "cptr", cfg, pc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    recs, u = run_steps(step, model, data, 600.0, 3, torch.cuda.synchronize)
    bench_launches = launch_counts()
    for r in recs:
        print(f"  step {r['step']} dt {r['dt']:.0f} s: newton {r['newton']} "
              f"fgmres {r['fgmres']} retries {r['retries']} wall {r['wall_s']:.3f} s")
    ncells = N_MAIN * N_MAIN
    doubling = recs[1:]
    cu_s = ncells * sum(r["newton"] for r in doubling) / sum(r["wall_s"] for r in doubling)
    print(f"  launches {bench_launches}")
    check_physical(u, (N_MAIN, N_MAIN), "main path")
    step_kernels = ("block_matvec", "matvec", "chebyshev_smooth", "fused_residual")
    missing = [k for k in step_kernels if bench_launches[k] <= 0]
    if missing:
        raise SystemExit(f"main path launched no {missing}")
    phase("4 main path", t0, f"{N_MAIN}^2 f32: {cu_s:.1f} cell-updates/s over the "
          f"{len(doubling)} doubling steps; peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, data, u, step
    torch.cuda.empty_cache()

    # (5) flagship parity, GPU against CPU
    t0 = time.perf_counter()
    small = flagship_parity()
    if small["cpu"] != small["cuda"]:
        raise SystemExit(f"flagship parity: cpu {small['cpu']} != cuda {small['cuda']}")
    phase("5 flagship parity", t0, f"{'x'.join(map(str, FLAGSHIP_SMALL))} f64 "
          f"(dt, newton, fgmres, retries) per step: cpu {small['cpu']} == cuda "
          f"{small['cuda']}")

    # (6) the flagship
    t0 = time.perf_counter()
    frecs, launches, attempts, fcu_s, peak = flagship_run(dev)
    phase("6 flagship", t0, f"60x220x85 f32: {fcu_s:.1f} cell-updates/s over steps "
          f"2-{len(frecs)}; peak mem {peak:.2f} GiB")

    # (7) where the flagship's time goes
    t0 = time.perf_counter()
    layers = flagship_layers(dev)
    phase("7 flagship layers", t0, "60x220x85 f32, synchronized layer timers")

    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCES[k][0],
                "replaces": KERNEL_SOURCES[k][1], "launches": launches[k],
                "max_abs_err": krec[k]["max_abs_err"], "ms": krec[k]["ms"],
                "plain_ms": krec[k]["plain_ms"], "bound_ms": krec[k]["bound_ms"],
                "bound_by": krec[k]["bound_by"], "library_ms": krec[k]["library_ms"]}
               for k in KERNEL_SOURCES]
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"device": smi, "kernels": kernels, "kernel_cases": krec,
                       "fuse_apply_ms": fuse_times, "slice_counts": counts,
                       "main_steps": recs, "main_launches": bench_launches,
                       "cell_updates_per_s": cu_s, "flagship_small": small,
                       "flagship_steps": [r.as_dict() for r in frecs],
                       "flagship_newton_all_attempts": attempts,
                       "flagship_cell_updates_per_s": fcu_s, "flagship_peak_gib": peak,
                       "flagship_layers": layers,
                       "total_s": time.perf_counter() - t_all}, fh, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
