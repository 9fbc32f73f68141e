"""Drive thermalporous_torch on one NVIDIA GPU, phase by phase.

    python3 chip_smoke.py [--json PATH] [--phases 2,5]

Phases (each prints one line with its wall time; every CPU run that a
GPU-against-CPU check of phases 5 and 8-15 needs is a task of one pool of
3 worker processes started before phase 5, those of phases 10-15
submitted at phase 10, in the order the phases need them, so that no
phase waits for its CPU run):
  0  device: CUDA device name, and name/power limit from nvidia-smi;
  1  build: compile csrc/*.cu with nvcc (one process per source, all
     started together) into thermalporous_torch/_build/; prints ptxas's
     registers and spills per kernel;
  2  kernel parity at the main paths' shapes: each hand-written kernel
     against its plain PyTorch version on the card, f32 and f64, with the
     max relative error and the median time of each, on the benchmark's
     1024x1024 case and on the flagship (tp_spe10_full, 60x220x85): there
     also the red-black stage 2 on the flagship Jacobian (x1 the CPTR
     state's e_pt, beside the parent commit's route of block_matvec at
     k = 2, a subtraction, the zero-start sweep and an add, which must give
     its bits; no x1; x1 padded to k = 3), its layout floor, the half-sweep
     and 2 and 3 sweeps from zero and from x0, the
     fused coarse subtree at the entry levels of the pressure and
     temperature hierarchies, each kernel's bound, a torch.sparse.mm
     yardstick for the two matvecs and for J(u)v, J(u)v also at a state
     with saturations exactly 0 and 1 (where the clip of Se passes half
     the tangent; on the 1024x1024 case too), and the CPTR apply with
     the subtree fused from the ~145k-cell, the ~36k-cell and the ~5k-cell
     level and unfused; the latency of the card's grid-wide and cluster
     barriers; the Chebyshev smooth and the scalar matvec at every level
     of both flagship hierarchies above the smallest fused entry, and the
     smooth on two awkward shapes (61x219x83, 1023x1021) at degrees 1, 2
     and 4, bitwise against its plain version; the fused subtree of the
     phase-5 hierarchy (smaller than one block); the smooth and the subtree
     run twice on one input (bitwise equal), and the barriers of one subtree
     visit, counted by the kernel; then the single-phase residual and J(u)v on the
     benchmark's 1024x1024 grid with the single-phase model and on
     sp_geothermal_3d (64x64x32), and the block matvec with two unknowns
     at 1024x1024; the smooth's second output (the residual b - A y after
     a pre-smooth, the product A y after a post-smooth) at every flagship
     level that uses it, on 1024x1024 and on the awkward shapes, bitwise
     against the smooth followed by the plain matvec, with the smooth alone
     and the standalone matvec it replaces timed beside it; the standalone
     matvec on the awkward shapes; the residual and J(u)v of both models on
     grids that are no multiple of their kernel's tile (61x219x83,
     1023x1021, 37x5x19, 9x21), two-phase also at saturations 0 and 1;
     the assembly on the card (coloured probing: q*nc J(u)v launches and a
     gather) against the torch.func assembly, both timed, the error relative
     to each block entry, the bound the Jacobian's least work, on
     1024x1024, the flagship and sp_geothermal_3d (64x64x32);
     the stage 2 at every k and the half-sweeps on 61x219x83 and 9x21
     (three unknowns) and 61x219x83 (two), and on 1024x1024 beside the
     parent's route; the stage 2 and the half-sweep bitwise equal to their
     plain versions; every kernel run twice on one input (bitwise equal);
  3  slice parity: the benchmark configuration at 32x32, f64, 3 steps, on the
     GPU and on the CPU: Newton and FGMRES counts per step must agree;
  4  main path: the benchmark workload (two-phase CPTR step, 1024x1024, f32):
     a 600 s step, then 3 dt-doubling steps with the benchmark's cutback
     rule; per-step counts and walls, cell-updates/s, and each kernel's
     launch count in that run (each must be > 0);
  5  flagship parity: tp_spe10_full's configuration on a 12x22x9 synthetic
     SPE10 grid, f64, through the Simulator on the GPU and on the CPU for 2
     controller steps: accepted dt, Newton and FGMRES counts must agree;
     then the same with stage2_sweeps=2 (the half-sweep kernel's path);
  6  flagship: tp_spe10_full at 60x220x85, f32, Simulator.run for the first
     4 controller steps from dt_init = 600 s; per-step counts and walls,
     cell-updates/s, peak memory, S and T bounds, and the launch count of
     every kernel in that run (each must be > 0);
  7  flagship layers: phase 6's first 2 steps again with synchronized timers
     around each layer (assembly, CPTR setup, FGMRES, CPTR apply, residual),
     the smooths, second outputs, scalar matvecs and subtree visits by
     level, the block matvecs and stage 2s by block columns (no block
     matvec at k = 2: the stage 2 is one launch), and the device's busy
     share over one more step from the
     profiler, whose kernel events are held against the wrappers' counters;
  8  single-phase family: sp_hot_injection_2d (40x40, f64) through the
     Simulator on the GPU and on the CPU for 3 controller steps (accepted
     dt, Newton and FGMRES counts must agree), then sp_geothermal_3d at
     64x64x32, f32, for its first 6 controller steps: per-step counts and
     walls, cell-updates/s, T and p bounds, per-well rates, and the launch
     count of each kernel of that path (each must be > 0);
  9  matrix-free Krylov operator (krylov_op="jvp"): the flagship
     configuration at 12x22x9, f64, on the GPU and on the CPU (counts must
     agree); tp_spe10_full at 60x220x85, f32, for its first 2 controller
     steps with the J(u)v operator, beside phase 6's counts with the
     stencil operator; sp_geothermal_3d
     for 2 steps; the J(u)v kernel of each model must launch;
 10  solver options: (a) the W-cycle in the fused subtree on the flagship's
     pressure and temperature hierarchies from the ~145k- and ~36k-cell
     entries, f32 and f64, beside the hierarchy's own cycle and the
     K-cycle, and on the 12x22x9 hierarchies: within tolerance of the plain
     version, bitwise equal to it with the coarsest solve summed in the
     kernel's order (every subtree without a K-cycle level, in phase 2 too),
     bitwise on a rerun, its barrier count equal to barrier_count; (b)
     tp_spe10_inner (two inner FGMRES iterations on the (p, T) system per
     CPTR apply) at 60x220x85, f32, its kernels at that path's shapes, then
     Simulator.run for 2 controller steps: counts, walls, cell-updates/s,
     peak memory, S and T bounds, and every kernel of its path launched
     (block matvec at nc = 3 and at nc = 2, stage 2 at k = 3), beside phase
     6's counts; (c) every solver option of the parity tests on the
     flagship configuration at 12x22x9, f64, 1 controller step on the GPU
     (tasks of a pool of worker processes) and on the CPU, options that act
     on different parts of the solver two to a run (OPTION_PAIRS): the
     counts must agree, and the stage-2 route each took on the card is
     printed;
 11  the run_case path: (a) thermalporous_torch.run_case.main in this
     process on tp_spe10_full at 60x220x85, f32, for 2 steps with a
     checkpoint and a VTK frame every step, JSONL metrics and the balance
     audit: per-step counts and walls, cell-updates/s over step 2, the
     ms of each checkpoint, frame (about 13.5 MB each; the native VTI
     writer must write every frame) and audit call, the balance rows
     (complete, finite), every flagship kernel launched; then --resume from
     the step-1 checkpoint, whose step-2 checkpoint must equal the
     uninterrupted run's bit for bit; then python -m
     thermalporous_torch.run_case on tp_thermal_2d in a subprocess beside
     (b) and (c); (b) the
     flagship configuration at 12x22x9, f64, in blocks of 2 for 4 steps on
     the GPU and the CPU (dt, counts and the state-consistent pattern must
     agree) and the host loop on the GPU (the same records, final state and
     balance audit); (c) tp_thermal_2d at 60x60, f64, under two control
     segments (the producer shut in halfway) on the GPU and the CPU: counts
     must agree, a step must land on the boundary, the balance audit must
     close below 1e-9; the card's host-loop run in a worker process at the
     same time as the rest;
 12  bf16 coefficients and the batched p/T traversal: (a) every kernel that
     reads preconditioner coefficients (block matvec at nc = 3, k = 2 and 3
     and on the (p, T) stencil, the scalar matvec, the smooth from x0 and
     from zero and with both second outputs, the stage 2 at k = 2 and 3,
     the half-sweep, the subtree's p K-cycle and T V-cycle) at the
     flagship's shapes with bf16 coefficients, f32 and f64 vectors, against
     its plain version (bitwise where the f32 form is), beside the same
     cases on f32 coefficients (phases 2 and 10(b)'s rows when they ran);
     (b) tp_spe10_full at 60x220x85, f32, with
     pc_dtype="bf16" for one controller step from 300 s (its 600 s attempt
     fails; it converges; counts beside the f32 run's), one CPTR apply in
     each storage mode in turns (each mode's first step runs at 12x22x9
     among phase 10(c)'s options),
     peak memory, every bf16 kernel of the path launched; (c) bench.py's
     step with pc_dtype="bf16" (the 600 s step and one doubling); (d) the
     flagship with batch_pt: one apply bitwise equal to the sequential
     block-diagonal one with half its smooth and subtree launches, the
     batched smooth and subtree beside their two sequential launches
     (bitwise), then one controller step; (e) the storage modes and batch_pt
     among phase 10(c)'s options, GPU against CPU (run here when phase 10
     is not);
 13  transfers, bgmg, recycling and the adjoint: (a) the GMG set-up and one
     apply on the flagship's decoupled pressure stencil (60x220x85, f32)
     with transfer="constant", "weighted" and "variational" (set-up and
     apply ms, each level's class and widths, the launches of an apply: the
     smooth on the finest level, no fused subtree under a weighted or
     variational transfer), the CPTR set-up and apply with each (the
     flagship's first step with "variational" runs at 12x22x9 among (e)'s
     options);
     (b) the bgmg hierarchy of the flagship Jacobian (levels, set-up, one
     bgmg stage 2 beside the rbgs stage 2 and the CPTR apply with each),
     then tp_spe10_full with stage2="bgmg" for one controller step from
     300 s (its 600 s attempt fails, as the reference's does): counts
     beside phase 6's, walls, cell-updates/s, peak memory, the red-black
     kernels' launches by level (each > 0); (c) ksp_recycle=4 runs at
     12x22x9 among (e)'s options; (d) the adjoint: the
     flagship configuration at 12x22x9, f64, 3 recorded steps, a terminal
     and a running objective, on the CPU and the GPU:
     equal FGMRES counts per backward step, gradients within 1e-8, and a
     central-difference probe on tgeo[0] on the card within 1e-5; then the
     flagship (60x220x85, f32) over its first accepted step with rtol
     1e-5: converged, FGMRES per backward step, the wall per step split into
     assembly, the CPTR set-up on the transpose and FGMRES with the VJP's
     ms per transposed product, peak memory, every CPTR kernel launched on
     the transposed hierarchy; (e) the transfers (also with
     pc_dtype="bf16_gmg"), bgmg (also with bgmg_cycles=2 and
     stage2_sweeps=2, and pc_dtype="bf16_s2") and ksp_recycle=4 among phase
     10(c)'s options, GPU against CPU (run here when phase 10 is not), each
     with the launches its path must show; (f) python -m
     thermalporous_torch.adjoint_study --ascent 1 on the card in a
     subprocess beside the rest of the phase: its FD line's relative error
     below 1e-4;
 14  the ensemble axis and the example drivers: (a) tp_spe10_full at
     12x22x9, f32, a well-control ensemble of 2 members (the preset, the
     injector's BHP x1.05) with the coarsening planned from member
     0, one 600 s step of every member through make_ensemble_step_fn: each
     member's state and counts bitwise its solo step, its launches those of
     its solo run, every flagship kernel launched; the wall of each member,
     cell-updates/s over the ensemble, peak memory (the solo steps run after
     the ensemble's, beside (c) and (d)'s card processes); (b) the ensemble adjoint
     at 12x22x9, f64, the same members, one 600 s step, a terminal and a
     running objective, on the card and on the CPU: equal
     per-member forward and backward counts and lockstep count, gradients
     within 1e-12, each member bitwise its solo sweep on the card; (c) python
     -m thermalporous_torch.iteration_study --steps 1 and (d) python -m
     thermalporous_torch.custom_case --days 0.05, each in a subprocess on
     the card, started after (a)'s ensemble step so that no other process
     holds the card while it is timed, beside (a)'s solo steps and (b), and
     with --device cpu: every line
     of the study's table equal, the custom case's lines equal, and its
     records equal and well rates within 1e-12 in process;
 15  the grid decomposition: (a) the block matvec, scalar matvec, smooth
     (degree 4, second output), stage 2 and half-sweep on a block of the
     flagship grid whose extended origin has an odd index sum, bitwise the
     whole grid's on the owned cells, the red-black kernels with the
     block's colour offset (and not without it), and J(u)v on the same
     block's extended block (two cells deep) in f32 and f64 against its
     plain version, within phase 2's tolerances, timed per call and on the
     card beside torch.sparse.mm on a CSR of the block's operator; the
     bf16 and batched forms there (B1, B2, B3 with bf16 coefficients, B5
     in bf16 at k = 2 with the block's odd parity, B3 batched over p and
     T) in f32 and f64 against their plain versions; then tp_spe10_full at
     60x220x85, f32, fuse_below=150000, its first 600 s step on a one-rank
     NCCL mesh: bitwise the undecomposed step, with the same launches per
     kernel; (b) four gloo ranks sharing cuda:0 (one process each, the
     ghost slices and reduction partials staged through the host), the
     flagship split 2x2, the same step: every rank's (Newton, FGMRES)
     equal to (a)'s, the block matvec, scalar matvec, smooth, residual and
     stage 2 launched on every rank and the fused subtree on none, the
     state gathered, finite and physical, passing the undecomposed Newton
     test (its scaled residual norm on the whole grid under the step's
     tolerance and equal to the ranks' own final norm), its largest gap
     per component to (a)'s printed; exchanges, all-reduces and
     all-gathers per Newton, the ms of a host-staged exchange and each
     rank's wall; then, on the same ranks, two first steps from 300 s
     (150 s when the undecomposed card step fails there) under
     pc_dtype="bf16" with two stage-2 sweeps and under batch_pt with the
     zebra stage 2 along y (its block line solves a pipeline through the
     ranks), each with equal counts on every rank, printed beside the
     undecomposed card step's, its bf16 or batched launches on every rank,
     the gathered state under the undecomposed Newton test, the pipeline
     carries per Newton, and the line solves' share of a zebra apply; (c)
     dryrun_multichip(4, device="cuda", backend="gloo") in f64, both
     scenarios, in a subprocess started with the phase; (d) no longer
     runs: tp_spe10_inner's configuration is one of (e)'s runs; (e) the
     options the stage-2 and Krylov slice lifted (jacobi2 with "cgs1",
     two rbgs sweeps, bgmg with its finest level decomposed, zebra along z
     with "cgs2s", the saturation leg, two inner iterations of each
     method, ksp_recycle=4) and tp_spe10_inner's configuration (the block
     matvec at nc = 2 and the stage 2 at k = 3 launched on every rank)
     over the same ranks after (b), in f64 at
     12x22x9 (phase 10(c)'s configuration, levels above 1000 cells
     decomposed), one 600 s step each against the CPU's undecomposed step:
     equal (Newton, FGMRES, converged) on every rank, the gathered state
     within the reference tests' bands (p 10 Pa, S 1e-8) — ksp_recycle=4
     under the flagship's loose tolerances, whose CPU step moves further
     under a one-ulp change of its input (decomp_sensitivity.py
     --recycle), to the undecomposed Newton test instead, and again under
     the reference check's tolerances to the bands — bgmg's zero-start
     sweep (the stage 2 at k = 0) and half-sweeps launched on every rank;
     (f) after (e) on the same ranks and in the same configuration: a step
     under transfer="weighted", one under "variational" (both hierarchies'
     finest level decomposed) and one under krylov_op="jvp" (J(u)v launched
     on every rank), each with the CPU's (Newton, FGMRES, converged) and
     the gathered state under the undecomposed Newton test; the adjoint
     over two recorded steps (phase 13(d)'s Newton and objectives) with
     the CPU's FGMRES count per backward step and gradients within 1e-8;
     an ensemble of the two members of phase 14 decomposed alike, one
     step, member 0 bitwise the adjoint trajectory's first step and member 1
     its solo decomposed step, and its ensemble adjoint with the CPU's
     lockstep count and gradients within 1e-8; (g) after (f) on the same
     ranks, every option the decomposition ran last, at 14x14x9 f64 (both
     owned origins odd; both hierarchies coarsening z only for two levels,
     so that their two finest levels stay decomposed), 13 runs: the zebra
     stage 2, the saturation leg's zebra and line smoothers and the
     multigrid's line and zebra smoothers along x and along y, stage2_axes,
     stage2_fused with and without axes, the Jacobi and red-black
     smoothers with cycles=2, batch_pt, pc_dtype "bf16", "bf16_gmg" and
     "bf16_s2", precond "jacobi", "rbgs" and "lu", and a two-step run with
     the balance audit, each against the CPU's undecomposed run: equal
     (Newton, FGMRES, converged) on every rank, the gathered state within
     the bands (bf16 storage: the undecomposed Newton test), the audit's
     totals and rows within 1e-10 of the CPU's and the same report on
     every rank, the launches (bf16 and batched ones, pipeline carries)
     its configuration uses on every rank.  (b), (e), (f) and (g) are one
     spawn, so that no other ranks share the card with them.  The kernels
     are built once (phase 1) before any rank starts.

Then the card's name and power limit, a JSON line with one record per
kernel (its f32 case on its path's shapes, and its launches in its path's
run: phase 6 for the flagship's kernels, phase 5's two-sweep run for the
half-sweep, phase 8 for the single-phase residual, phase 9 for the J(u)v
kernels, phase 10(b) for tp_spe10_inner's kernels, the W option's run of
phase 10(c) for the W-cycle, phase 12's runs and options for the bf16
and batched instantiations, phase 13's bgmg run by level and its full-size
adjoint, phase 14(a)'s ensemble step, rank 0's step in phase 15(b),
rank 0's tp_spe10_inner, bgmg and two-sweep runs in phase 15(e),
rank 0's J(u)v run and adjoint sweep in phase 15(f), and rank 0's bf16
and batched launches in phase 15(b)'s full-width runs and in (g)), and
as the last line
{"ok": true, "device": {...}}.  Any failure exits nonzero without
the ok line; without CUDA the script exits nonzero at once.  With
--phases only the named phases run (after 0 and 1), and neither the
kernels' line nor the ok line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent

# Tolerances, as max|kernel - plain| / max|plain| over each output component.
TOL_F64 = 1e-12
# f32 stencils: same op order and rounding (built with --fmad=false), so any
# difference would be a bug; the bound leaves room for nothing but ulps.
TOL_F32_STENCIL = 1e-5
# f32 residual: exp10f/expf in the kernel and the library pow/exp of the
# plain version differ by up to 2 ulp (~2.4e-7 relative in mu_w, mu_o), and
# the residual sums accumulation and flux terms much larger than itself.
TOL_F32_RESIDUAL = 1e-4
# f32 J(u)v: the kernel forms the tangents of mu_w and mu_o from the primal
# values, so the same 1-2 ulp of exp10f/expf carry into J(u)v, and J(u)v sums
# tangents of accumulation, well and flux terms much larger than itself, as
# the residual does; its other operations round as torch's forward-mode
# formulas do.  So it is held to the residual's bound.
TOL_F32_JVP = TOL_F32_RESIDUAL
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
SMALL_STEPS = 2                # phase-5 (and 9) controller steps at FLAGSHIP_SMALL
SPE10_FULL = (60, 220, 85)     # the flagship's grid
# phase 5: coarsest levels of at most 16 cells keep >= 3 levels in both
# hierarchies, K-cycles from 256 cells run at this size, and the subtree
# below 300 cells is fused
SMALL_GMG = dict(max_coarse_cells=16, kcycle_min_cells=256, fuse_below=300)
FLAGSHIP_STEPS = 4
# phase 7: the controller steps of the per-layer split (the first two of
# phase 6's four: the first step and one easy one, 14 Newton)
LAYER_STEPS = 2
# fuse_below candidates on the flagship hierarchies: the ~145k-cell, the
# ~36k-cell and the ~5k-cell levels of the adaptive pressure hierarchy are
# the entries
FUSE_CANDIDATES = (150_000, 40_000, 6_000)
# fuse_below of the phase-6 flagship run, on both hierarchies: the value
# whose CPTR apply was fastest in phase 2's comparison (PERF.md has the
# numbers)
FLAGSHIP_FUSE_BELOW = 150_000
# the one-block subtree kernel this one replaced, on the same card model at
# the same power limit in an earlier run (ms, f32): printed beside
DEEP_MS_ONE_BLOCK = {("p", 36_300, "k"): 1.4854, ("T", 39_600, "v"): 0.5655}
# awkward shapes for the smooth: odd extents, cell counts that are no
# multiple of 4, so quads straddle rows and the channels are not 16-byte
# aligned
AWKWARD_SHAPES = ((61, 219, 83), (1023, 1021))
# grids for the residual and J(u)v kernels that are no multiple of their
# tile in any axis; the last two have extents smaller than a tile
MODEL_SHAPES = ((61, 219, 83), (1023, 1021), (37, 5, 19), (9, 21))
# phase 9: the Krylov operators of the full-size flagship runs, in turns (the
# stencil operator's first steps are phase 6's, which the jvp turn is held
# beside when phase 6 ran)
OPERATOR_TURNS = ("jvp",)
# (kind, blocks, threads) of the barrier probe: grid barriers, then
# cluster barriers (a cluster of 16 is the non-portable size)
BARRIER_PROBES = ((0, 8, 256), (0, 36, 1024), (0, 132, 256), (0, 132, 512),
                  (0, 264, 256), (1, 8, 256), (1, 16, 256), (1, 8, 1024),
                  (1, 16, 1024))
SP_GEO_STEPS = 6       # phase-8 controller steps of sp_geothermal_3d
JVP_STEPS = 2          # phase-9 controller steps of the full-size jvp runs

# the plain versions' timing in phase 2's rows: fewer calls than the
# kernels' (the plain J(u)v takes 100-180 ms a call; 23 calls of every
# plain version were ~85 s of the script)
PLAIN_REPS = 2

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
    "fused_residual_sp": ("thermalporous_torch/csrc/residual.cu",
                          "thermalporous_tpu/kernels/residual_pallas.py:185"),
    "fused_stage2_rbgs": ("thermalporous_torch/csrc/rbgs.cuh",
                          "thermalporous_tpu/kernels/stencil_pallas.py:408"),
    # no Pallas twin: the reference's looped half-sweep (jnp)
    "block_rbgs_half_sweep": ("thermalporous_torch/csrc/rbgs.cuh",
                              "thermalporous_tpu/precond/chebyshev.py:295"),
    "deep_correction": ("thermalporous_torch/csrc/deep_cycle.cu",
                        "thermalporous_tpu/kernels/deep_cycle.py:289"),
    "fused_jvp": ("thermalporous_torch/csrc/residual.cu",
                  "thermalporous_tpu/kernels/residual_pallas.py:196"),
    "fused_jvp_sp": ("thermalporous_torch/csrc/residual.cu",
                     "thermalporous_tpu/kernels/residual_pallas.py:196"),
}
# the kernels each driven path must launch: the flagship with the stencil
# operator (phase 6), its configuration with two stage-2 sweeps (phase 5:
# the half-sweep runs only there), sp_geothermal_3d (phase 8; block-Jacobi
# stage 2, no fused subtree)
FLAGSHIP_KERNELS = ("block_matvec", "matvec", "chebyshev_smooth", "fused_residual",
                    "fused_stage2_rbgs", "deep_correction")
SWEEPS_KERNELS = ("deep_correction", "fused_stage2_rbgs", "block_rbgs_half_sweep")
SP_KERNELS = ("block_matvec", "matvec", "chebyshev_smooth", "fused_residual_sp")
# the stage-2 kernel on shapes that are no multiple of its tile, and with
# two unknowns, and the flagship's two smallest smoothed bgmg levels (a
# 4-plane axis, odd extents): (shape, unknowns)
RBGS_SHAPES = (((61, 219, 83), 3), ((9, 21), 3), ((61, 219, 83), 2), ((8, 28, 11), 3),
               ((4, 14, 6), 3))


def ptxas_summary(log: str) -> list:
    """(kernel, registers, spill stores, spill loads) per entry function of
    the build log (``nvcc -Xptxas -v``), names demangled where the toolkit
    has a demangler."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append([name, int(m.group(1)), *spills])
            name = None
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt, *(r[0] for r in rows)], capture_output=True, text=True)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, nm in zip(rows, names):
                # drop the parameter list: it follows the template arguments
                cut = nm.rfind(">(") + 1 if ">(" in nm else nm.find("(")
                r[0] = (nm[:cut] if cut > 0 else nm).replace("void ", "").replace("tp::", "")
    return [tuple(r) for r in rows]


def over_steps(n: int) -> str:
    """How a rate over a run of ``n`` controller steps is taken: over the
    steps after the first, or over the one step, set-up included."""
    return f"over steps 2-{n}" if n > 1 else "over its one step"


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


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events, after
    ``warm`` calls)."""
    for _ in range(warm):
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


def time_device_ms(fn, reps: int = 20) -> float:
    """Median milliseconds the card spends on ``fn()``: a kernel that only
    spins keeps the card busy while the host enqueues the events and
    ``fn``'s launches, so the host's share of the call drops out."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(3_000_000)
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
# axes, ``item`` bytes per vector value, ``citem`` per stored coefficient
# (2 with bf16 coefficients; None: ``item``).

def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def cost_block_matvec(n, dim, nc, k, item, citem=None):
    return (((2 * dim + 1) * nc * k * (citem or item) + (k + nc) * item) * n,
            2 * (2 * dim + 1) * nc * k * n)


def cost_matvec(n, dim, item, citem=None):
    return ((2 * dim + 1) * (citem or item) + 2 * item) * n, 2 * (2 * dim + 1) * n


def cost_chebyshev(n, dim, degree, from_x0, item, citem=None):
    mv = 2 * (2 * dim + 1) * n
    ops = (mv if from_x0 else 0) + 3 * n + (degree - 1) * (mv + 7 * n) + n
    return ((2 * dim + 1) * (citem or item) + (2 + int(from_x0)) * item) * n, ops


def cost_chebyshev_second(n, dim, degree, from_x0, kind, item, citem=None):
    """The smooth with its second output: one more vector out, one more
    product (and a subtraction for the residual)."""
    nbytes, ops = cost_chebyshev(n, dim, degree, from_x0, item, citem)
    return nbytes + n * item, ops + 2 * (2 * dim + 1) * n + (n if kind == "residual" else 0)


# Operations of one residual evaluation, counted from csrc/residual.cu's
# device physics as the function needs them: each interior face once, each
# upwinded mobility on its upwind side only, the well terms only in cells
# with a well.  Two-phase, per cell: 43 for the densities, the accumulation
# and R = acc - q, 29 for the old accumulation; per well cell 46 more for
# the Peaceman and rate terms; per face 81 (4 densities 28, 2 potentials
# 11, 2 upwind mobilities 24, fluxes 12, added to both cells 6).
# Single-phase: 23, 14 old, 21 per well cell, 35 per face.
OPS_TP = dict(cell=43, old=29, well=46, face=81)
OPS_SP = dict(cell=23, old=14, well=21, face=35)


def model_ops(model, u, data):
    """(arithmetic operations without the old accumulation, those of the
    old accumulation, transcendentals) of one residual evaluation of
    ``model`` at state ``u``.  Transcendentals: two-phase mu_w and mu_o per
    well cell and per face, mu_w(T_inj) more at an injecting BHP well's
    cell, and a pow for k_rw (k_ro) per well cell and per face only where
    its exponent is not 2 (the kernel squares x*x otherwise); single-phase
    mu_w per well cell and per face."""
    grid = model.grid.shape
    dim, n = len(grid), math.prod(grid)
    faces = sum(n - n // e for e in grid)
    wi, pbh, _, has_tinj, qrate = data.fields[2 * dim + 1:2 * dim + 6]
    n_well = int(((wi != 0) | (qrate != 0)).sum())
    if model.nc == 2:
        ops, mus, extra = OPS_SP, 1, 0
    else:
        ops, mus = OPS_TP, 2
        rp = model.relperm
        pows = int(rp.n_w != 2) + int(rp.n_o != 2)
        inflow = int(((wi != 0) & (pbh - u[0] >= 0) & (has_tinj > 0.5)).sum())
        extra = inflow + pows * (n_well + faces)
    arith = ops["cell"] * n + ops["well"] * n_well + ops["face"] * faces
    return arith, ops["old"] * n, mus * (n_well + faces) + extra


def model_bytes(model, item):
    # the state (u and u_old, or u and v) and the fields in, the result out
    dim = len(model.grid.shape)
    return (3 * model.nc + 2 * dim + 7) * math.prod(model.grid.shape) * item


def cost_residual(model, u, data):
    # each transcendental counted as 16 operations (the SM's FP32 :
    # special-function rate)
    arith, old, trans = model_ops(model, u, data)
    return model_bytes(model, u.element_size()), arith + old + 16 * trans


def cost_jvp(model, u, data):
    # u, v and the fields in, J(u)v out: no u_old and none of its
    # operations; a dual-number operation is about three of its primal's, a
    # transcendental one evaluation and two products
    arith, _, trans = model_ops(model, u, data)
    return model_bytes(model, u.element_size()), 3 * arith + 18 * trans


def cost_assembly(model, u, data):
    # the Jacobian's least work, whatever computes it: u and the fields in
    # (no u_old: the old accumulation's derivative is zero), the
    # coefficients out, and one dual pass that carries nc tangents (an
    # operation about 1 + 2·nc of its primal's, a transcendental one
    # evaluation and 2·nc products)
    dim, n, nc = len(model.grid.shape), math.prod(model.grid.shape), model.nc
    arith, _, trans = model_ops(model, u, data)
    item = u.element_size()
    return (model_bytes(model, item) - 2 * nc * n * item + (2 * dim + 1) * nc * nc * n * item,
            (1 + 2 * nc) * arith + (16 + 2 * nc) * trans)


def cost_stage2(n, dim, nc, k, item, citem=None):
    """The stage 2 after x1 = [x1_cols; 0] over k columns: every cell's
    column-0:k coefficients (r2 = r - A x1), the black cells' other
    off-diagonal columns (A x_r; the red cells need none), r, x1, D^-1 and
    the output, each once.  k = 0 is the zero-start sweep alone."""
    nb = n // 2
    coefs = (2 * dim + 1) * nc * k * n + nb * 2 * dim * nc * (nc - k) + nc * nc * n
    ops = (n * (2 * (2 * dim + 1) * nc * k + nc + 2 * nc * nc + k)
           + nb * (2 * 2 * dim * nc * nc + nc))
    return coefs * (citem or item) + (2 * nc + k) * n * item, ops


def floor_stage2_ms(n, dim, nc, k, item, citem=None):
    """The stage-2 kernel's floor on the packed layout: red and black cells
    alternate along the contiguous axis, so the black cells' other
    off-diagonal columns pull every sector of those planes."""
    coefs = ((2 * dim + 1) * nc * k + 2 * dim * nc * (nc - k) + nc * nc) * n
    return (coefs * (citem or item) + (2 * nc + k) * n * item) / PEAK_BYTES_S * 1e3


def cost_half(n, dim, nc, item, citem=None):
    """One half-sweep: the cells of the colour read their stencil rows,
    D^-1 and b; x is read and the output written everywhere."""
    nh = -(-n // 2)
    nbytes = nh * (((2 * dim + 1) * nc * nc + nc * nc) * (citem or item) + nc * item)
    return nbytes + 2 * nc * n * item, nh * (2 * (2 * dim + 1) * nc * nc + 2 * nc * nc + 2 * nc)


def cost_deep(shapes, degree, cycle_type, kmin, item, citem=None, batch=1):
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
        if cycle_type != "v" and ell < last and sizes[ell] >= kmin:
            # K: two products, five dots and the updates; W: b - A e1 and
            # the sum e1 + e2
            extra = (2 * mv[ell] + 16 * sizes[ell] if cycle_type == "k"
                     else mv[ell] + 2 * sizes[ell])
            ops += cycle(ell) + extra
        return ops

    nbytes = (sum((2 * len(s) + 1) * m for s, m in zip(shapes, sizes)) * (citem or item)
              + (sizes[-1] ** 2 + 2 * sizes[0]) * item)
    return batch * nbytes, batch * corr(0)


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

def bench_case(n: int, dtype, device, single_phase: bool = False):
    """The bench.py workload: grid, data and model (with ``single_phase``
    the single-phase model on the same grid and wells: the
    sp_hot_injection_2d preset's 400 m square at 1024x1024 has 0.39 m
    cells, below its wells' Peaceman radius, and is refused)."""
    from thermalporous_torch.core import Grid
    from thermalporous_torch.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
    from thermalporous_torch.physics import PhysicalParams, Well

    pp = PhysicalParams()
    grid = Grid(shape=(n, n), spacing=(5.0, 5.0), thickness=10.0)
    rng = np.random.default_rng(11)
    kx = 2e-13 * np.exp(0.5 * rng.standard_normal(grid.shape))
    wells = [Well(cells=((0, 0),), control="bhp", p_bh=4.0e7, T_inj=420.0),
             Well(cells=((n - 1, n - 1),), control="bhp", p_bh=1.0e7)]
    data = make_problem_data(grid, pp, kx=kx, phi=0.2, wells=wells,
                             dtype=dtype, device=device)
    model = SinglePhaseModel(grid, pp) if single_phase else TwoPhaseModel(grid, pp, s_init=0.2)
    return model, data


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
    """``pc`` with ``fuse_below`` (and other overrides) on both hierarchies
    (on ``gmg`` alone where the T hierarchy takes it, ``gmg_t=None``)."""
    gmg_t = None if pc.gmg_t is None else dataclasses.replace(
        pc.gmg_t, fuse_below=fuse_below,
        **{k: v for k, v in gmg_overrides.items() if k != "kcycle_min_cells"})
    return dataclasses.replace(
        pc, gmg=dataclasses.replace(pc.gmg, fuse_below=fuse_below, **gmg_overrides),
        gmg_t=gmg_t)


def state_amp(u0: torch.Tensor) -> torch.Tensor:
    """Per-component scales of a perturbation or a direction: 1e5 Pa, 5 K,
    0.1 saturation."""
    nc = u0.shape[0]
    return torch.tensor([1e5, 5.0, 0.1][:nc], dtype=u0.dtype,
                        device=u0.device).reshape((nc,) + (1,) * (u0.dim() - 1))


def perturbed_state(model, data, seed: int = 5):
    u0 = model.initial_state(data)
    rng = np.random.default_rng(seed)
    amp = state_amp(u0).cpu().numpy()
    du = torch.as_tensor(amp * rng.standard_normal(tuple(u0.shape)),
                         dtype=u0.dtype, device=u0.device)
    return u0, (u0 + du).contiguous()


def preset_state(name: str, dtype, dev, gmg: dict, **case_kw):
    """Preset ``name`` (keywords ``case_kw``) at a perturbed state: (case,
    u0, u, the configuration with its coarsening schedule baked from the
    initial Jacobian and ``gmg`` (fuse_below and other overrides, both
    hierarchies), the Jacobian at (u, u0) for dt = 600 s, the CPTR state on
    it)."""
    from thermalporous_torch.precond.cpr import cpr_setup, resolve_adaptive_coarsening
    from thermalporous_torch.presets import get_case

    case = get_case(name, device=dev, dtype=dtype, **case_kw)
    model, data = case.model, case.data
    u0, u = perturbed_state(model, data)
    pc = resolve_adaptive_coarsening(
        model.assemble_stencil(u0, u0, case.time_cfg.dt_init, data),
        with_fuse(case.pc_cfg, **gmg))
    st = model.assemble_stencil(u, u0, 600.0, data)
    return case, u0, u, pc, st, cpr_setup(st, pc)


def tie_state(u, data):
    """``u`` with the saturation exactly 0 in every 7th cell, exactly 1 in
    every 11th, and 0 and 1 in turn in the wells' cells: with the models'
    s_wr = s_or = 0 there Se lies on a bound of its clip, where the tangent
    is half."""
    dim = u.dim() - 1
    s = u[2].flatten().clone()
    idx = torch.arange(s.numel(), device=u.device)
    well = data.fields[2 * dim + 1].flatten() != 0
    s[idx % 7 == 0] = 0.0
    s[idx % 11 == 0] = 1.0
    s[well] = (idx[well] % 2).to(s.dtype)
    ut = u.clone()
    ut[2] = s.reshape(u.shape[1:])
    return ut


def jvp_case(model, data, st, u0, u, tol, g, tie: bool = False):
    """J(u)v of ``model`` against its plain version on a direction with the
    state's scales, with torch.sparse.mm on the CSR of the Jacobian ``st``
    at the same state as its library yardstick (with ``tie``, at
    :func:`tie_state` of ``u`` and with no yardstick)."""
    from thermalporous_torch.kernels import residual as kres

    if tie:
        u = tie_state(u, data)
    vj = (state_amp(u) * torch.randn(tuple(u.shape), generator=g, dtype=u.dtype,
                                     device=u.device)).contiguous()
    kname = "fused_jvp" if model.nc == 3 else "fused_jvp_sp"
    label = f"{kname} {'x'.join(map(str, st.grid_shape))}" + (" S at 0 and 1" if tie else "")
    return (label, kname,
            lambda: kres.fused_jvp(model, u, vj, u0, 600.0, data),
            lambda: model.jvp(u, u0, 600.0, data)(vj), tol,
            cost_jvp(model, u, data), None if tie else ("block", vj))


def probe_case(model, data, st, u0, u, tol):
    """The assembly on the card — coloured probing, q·nc J(u)v launches and
    one gather (``models/base.py:probe_stencil``) — against the
    broadcast-tangent assembly ``torch.func`` gives, both timed, at the
    state of the Jacobian ``st``; the error relative to each block entry
    (r, c) over slots and cells, whose units it shares; its bound the
    Jacobian's least work (``cost_assembly``), not the probes'."""
    from thermalporous_torch.kernels import residual as kres
    from thermalporous_torch.models.base import PROBE_COLOURING

    probes = PROBE_COLOURING[st.dim][1] * model.nc
    jvp = lambda v: kres.fused_jvp(model, u, v, u0, 600.0, data)
    # (nc·nc, slots, *grid): rel_err's leading axis the block entry
    by_entry = lambda coef: coef.movedim(0, 2).reshape((-1,) + coef.shape[:1] + coef.shape[3:])
    return (f"assembly probed {'x'.join(map(str, st.grid_shape))} ({probes} J(u)v)",
            "assembly_probe",
            lambda: by_entry(model.assemble_stencil(u, u0, 600.0, data, jvp=jvp).coef),
            lambda: by_entry(model.assemble_stencil(u, u0, 600.0, data).coef), tol,
            cost_assembly(model, u, data), None)


def kernel_cases(model, data, st, state, u0, u, tol_st, tol_res, tol_jvp, dev):
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
    for deg, kind, xx in ((4, "residual", None), (4, "product", x0), (2, "residual", None)):
        cases.append(second_case("fine", fine.packed, lam, b, xx, deg, kind, tol_st, item))
    cases.append(stage2_case("random x1", st, state.dinv, v, rand((2,) + grid), tol_st,
                             route=True))
    cases.append((f"fused_residual {gs}", "fused_residual",
                  lambda: kres.fused_residual(model, u, u0, 600.0, data),
                  lambda: model.residual(u, u0, 600.0, data), tol_res,
                  cost_residual(model, u, data), None))
    cases.append(jvp_case(model, data, st, u0, u, tol_jvp, g))
    cases.append(jvp_case(model, data, st, u0, u, tol_jvp, g, tie=True))
    return cases


def sp_cases(model, data, st, u0, u, tol_st, tol_res, tol_jvp, dev, with_b1: bool):
    """The single-phase residual and J(u)v, and (``with_b1``) the block
    matvec with two unknowns, at this problem's shapes."""
    from thermalporous_torch.kernels import residual as kres
    from thermalporous_torch.kernels import stencil as kst

    grid, dim = st.grid_shape, st.dim
    n, item, gs = math.prod(grid), st.coef.element_size(), "x".join(map(str, grid))
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [(f"fused_residual_sp {gs}", "fused_residual_sp",
              lambda: kres.fused_residual(model, u, u0, 600.0, data),
              lambda: model.residual(u, u0, 600.0, data), tol_res,
              cost_residual(model, u, data), None),
             jvp_case(model, data, st, u0, u, tol_jvp, g)]
    if with_b1:
        v2 = torch.randn((2,) + grid, generator=g, dtype=u.dtype, device=dev)
        cases.append((f"block_matvec nc=2 k=2 {gs}", "block_matvec",
                      lambda: kst.block_matvec(st.coef, v2, 2),
                      lambda: kst.block_matvec_plain(st.coef, v2), tol_st,
                      cost_block_matvec(n, dim, 2, 2, item), ("block", v2)))
    return cases


def flagship_cases(st, state, pc, dtype, dev):
    """The stage 2 on the flagship Jacobian (x1 the CPTR state's e_pt of a
    random residual, with the parent's route beside it; k = 0 and x1 padded
    to k = 3), the half-sweep and 2 and 3 sweeps, and the coarse subtree at
    the entry level that each FUSE_CANDIDATES value picks on each hierarchy
    (phase 6's value first: its cases make the kernel's record)."""
    from thermalporous_torch.core.stencil import apply_blocks
    from thermalporous_torch.precond.cpr import _stage1_pt
    from thermalporous_torch.precond.gmg import _fusable

    tol = TOL_F64 if dtype == torch.float64 else TOL_F32_STENCIL
    grid = st.grid_shape
    item = st.coef.element_size()
    g = torch.Generator(device=dev).manual_seed(4)
    r, x0 = (torch.randn((3,) + grid, generator=g, dtype=dtype, device=dev) for _ in range(2))
    e_pt = _stage1_pt(state, apply_blocks(state.w, r)[0:2], pc)
    x1 = torch.zeros_like(r)
    x1[0:2] = e_pt
    cases = [stage2_case("CPTR e_pt", st, state.dinv, r, e_pt, tol, route=True),
             stage2_case("no x1", st, state.dinv, r, r[:0], tol),
             stage2_case("x1 padded", st, state.dinv, r, x1, tol)]
    cases += half_cases("flagship", st, state.dinv, r, x0, tol)
    fuse_values = (FLAGSHIP_FUSE_BELOW,) + tuple(f for f in FUSE_CANDIDATES
                                                 if f != FLAGSHIP_FUSE_BELOW)
    for fb in fuse_values:
        for hname, hier, hcfg in (("p", state.gmg_p, pc.gmg), ("T", state.gmg_t, pc.gmg_t)):
            cfg = dataclasses.replace(hcfg, fuse_below=fb)
            entry = next(l for l in range(1, len(hier.stencils))
                         if _fusable(hier, l, cfg, dtype))
            cases.append(deep_case(hname, hier, entry, cfg, item, g))
    return cases


def stage2_case(label, st, dinv, r, x1, tol, route: bool = False):
    """The stage-2 kernel with x1 over k = x1.shape[0] columns against its
    plain version; its check prints the kernel's layout floor, and with
    ``route`` runs the parent commit's route beside it (block_matvec over
    the k columns, the subtraction, the k = 0 call, the add), which must
    give the kernel's bits, timed per call and on the card."""
    from thermalporous_torch.kernels import stencil as kst

    k, nc = x1.shape[0], st.nc
    grid, item, citem = st.grid_shape, r.element_size(), st.coef.element_size()
    n, dim = math.prod(grid), len(grid)
    kern = lambda: kst.fused_stage2_rbgs(st.coef, dinv, r, x1)

    def parent():
        x2 = kst.fused_block_rbgs(st.coef, dinv, r - kst.block_matvec(st.coef, x1, k))
        x2[0:k] += x1
        return x2

    def beside():
        floor = floor_stage2_ms(n, dim, nc, k, item, citem)
        extra = {"floor_ms": floor, "k": k}
        text = f"  layout floor {floor:.4f} ms"
        if route:
            if not torch.equal(kern(), parent()):
                raise SystemExit(f"stage 2 {label}: the kernel and the parent's route differ")
            extra.update(route_ms=time_ms(parent, reps=10),
                         route_device_ms=time_device_ms(parent, reps=10))
            text += (f"; the parent's route (block_matvec k={k}, subtraction, k = 0 call, "
                     f"add) {extra['route_ms']:.4f} ms ({extra['route_device_ms']:.4f} on the "
                     f"card), bitwise equal to the kernel")
        return text, extra

    return (f"fused_stage2_rbgs k={k} {label} {'x'.join(map(str, grid))}", "fused_stage2_rbgs",
            kern, lambda: kst.fused_stage2_rbgs_plain(st.coef, dinv, r, x1), tol,
            cost_stage2(n, dim, nc, k, item, citem), None, beside)


def sweeps_plain(coef, dinv, b, x, sweeps):
    """``sweeps`` red-black sweeps from ``x`` (None: zero) on the plain
    versions, as block_red_black_gauss_seidel runs them on the kernels."""
    from thermalporous_torch.kernels import stencil as kst

    if x is None:
        x = kst.fused_block_rbgs_plain(coef, dinv, b)
        sweeps -= 1
    for _ in range(sweeps):
        x = kst.block_rbgs_half_sweep_plain(coef, dinv, b, x, 0)
        x = kst.block_rbgs_half_sweep_plain(coef, dinv, b, x, 1)
    return x


def half_cases(label, st, dinv, b, x0, tol, colours=((0, "red"), (1, "black")),
               sweeps_cases: bool = True):
    """The half-sweep of each colour from x0, then 2 sweeps from zero and 3
    from x0 (the stage-2 kernel's k = 0 sweep and half-sweeps) against the
    plain versions."""
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.chebyshev import block_red_black_gauss_seidel

    grid, item, citem, nc = st.grid_shape, b.element_size(), st.coef.element_size(), st.nc
    n, dim = math.prod(grid), len(grid)
    gs = "x".join(map(str, grid))
    cases = []
    for colour, cname in colours:
        cases.append((f"block_rbgs_half_sweep {cname} {label} {gs}", "block_rbgs_half_sweep",
                      lambda c=colour: kst.block_rbgs_half_sweep(st.coef, dinv, b, x0, c),
                      lambda c=colour: kst.block_rbgs_half_sweep_plain(st.coef, dinv, b, x0, c),
                      tol, cost_half(n, dim, nc, item, citem), None))
    for sweeps, x in ((2, None), (3, x0)) if sweeps_cases else ():
        halves = 2 * sweeps - (2 if x is None else 0)
        hb, ho = cost_half(n, dim, nc, item, citem)
        zb, zo = cost_stage2(n, dim, nc, 0, item, citem) if x is None else (0, 0)
        cases.append((f"rbgs sweeps={sweeps} from {'zero' if x is None else 'x0'} {label} {gs}",
                      "block_rbgs_half_sweep",
                      lambda s=sweeps, x=x: block_red_black_gauss_seidel(st, dinv, b, x, s),
                      lambda s=sweeps, x=x: sweeps_plain(st.coef, dinv, b, x, s), tol,
                      (zb + halves * hb, zo + halves * ho), None))
    return cases


def random_block_stencil(shape, nc, dtype, dev, seed: int):
    """A random block stencil with dominant diagonal blocks, zero beyond the
    boundary."""
    from thermalporous_torch.core import BlockStencil

    g = torch.Generator(device=dev).manual_seed(seed)
    dim = len(shape)
    coef = torch.randn((2 * dim + 1, nc, nc) + shape, generator=g, dtype=dtype, device=dev)
    coef[0] += 4.0 * torch.eye(nc, dtype=dtype, device=dev).reshape((nc, nc) + (1,) * dim)
    for a in range(dim):
        idx = torch.arange(shape[a], device=dev).reshape([-1 if i == a else 1 for i in range(dim)])
        coef[1 + 2 * a] *= idx < shape[a] - 1
        coef[2 + 2 * a] *= idx > 0
    return BlockStencil(coef)


def rbgs_shape_cases(dtype, tol, dev):
    """The stage-2 kernel at every k and the half-sweeps on RBGS_SHAPES with
    a random block stencil."""
    cases = []
    for i, (shape, nc) in enumerate(RBGS_SHAPES):
        st = random_block_stencil(shape, nc, dtype, dev, seed=70 + i)
        dinv = st.diag_inverse()
        g = torch.Generator(device=dev).manual_seed(80 + i)
        r, x0 = (torch.randn((nc,) + shape, generator=g, dtype=dtype, device=dev)
                 for _ in range(2))
        label = f"random nc={nc}"
        for k in range(nc + 1):
            cases.append(stage2_case(label, st, dinv, r, x0[:k].contiguous(), tol))
        cases += half_cases(label, st, dinv, r, x0, tol)
    return cases


def deep_case(hname, hier, entry, cfg, item, g):
    """The fused coarse subtree of ``hier`` from level ``entry`` on a random
    right-hand side, as a case of :func:`run_cases`; its check holds the
    barriers the kernel counted against ``barrier_count`` and, where the
    subtree has no K-cycle level (no dot products), the kernel's result
    bitwise against the plain version with the coarsest solve summed in the
    kernel's order."""
    from thermalporous_torch.kernels import deep_cycle as kdeep
    from thermalporous_torch.precond.gmg import _fused_correction

    shapes = [s.grid_shape for s in hier.stencils[entry:]]
    sizes = [math.prod(s) for s in shapes]
    packed = [s.packed for s in hier.stencils[entry:]]
    citem = packed[0].element_size()
    rc = torch.randn(shapes[0], generator=g, dtype=hier.coarse_inv.dtype,
                     device=packed[0].device)
    kw = dict(degree=cfg.degree, lam_min_frac=cfg.lam_min_frac,
              cycle_type=cfg.cycle_type, kcycle_min_cells=cfg.kcycle_min_cells)
    cycle = cfg.cycle_type if sizes[0] >= cfg.kcycle_min_cells else "v"
    label = " -> ".join(map(str, sizes))

    def check() -> str:
        counted = torch.zeros((), dtype=torch.int32, device=rc.device)
        kdeep.deep_correction(packed, hier.lam_max[entry:], hier.coarse_inv, rc,
                              barriers=counted, **kw)
        kinds = kdeep.cycle_kinds(sizes, cfg.cycle_type, cfg.kcycle_min_cells)
        new = kdeep.barrier_count(kinds, cfg.degree)
        if int(counted) != new:
            raise SystemExit(f"deep_correction {label}: {int(counted)} barriers, "
                             f"expected {new}")
        blocks, threads = kdeep.launch_shape(sizes[0], torch.cuda.get_device_properties(
            rc.device).multi_processor_count)
        text = f"  {blocks} blocks x {threads} threads, {new} grid barriers a visit"
        if kdeep.WCYCLE not in kinds:        # the one-block kernel had no W-cycle
            old = kdeep.barrier_count(kinds, cfg.degree, single_block=True)
            earlier = DEEP_MS_ONE_BLOCK.get((hname, round(sizes[0], -2), cfg.cycle_type))
            text += (f" (one-block kernel: {old} block barriers"
                     + (f", {earlier:.4f} ms in an earlier run" if earlier and item == 4
                        else "") + ")")
        if kdeep.KCYCLE not in kinds:
            got = kdeep.deep_correction(packed, hier.lam_max[entry:], hier.coarse_inv, rc,
                                        **kw)
            ref = kdeep.deep_correction_plain(packed, hier.lam_max[entry:], hier.coarse_inv,
                                              rc, coarse_solve=kdeep.warp_order_mv, **kw)
            if not torch.equal(got, ref):
                raise SystemExit(f"deep_correction {label}: not bitwise equal to the plain "
                                 f"version with the kernel's coarsest summation order "
                                 f"(max |d| {float((got - ref).abs().max()):.3e})")
            text += "; bitwise equal to the plain version with the coarsest solve in the kernel's order"
        return text

    return (f"deep_correction {hname} {cycle}-cycle {label} cells"
            + (" bf16 coefficients" if citem == 2 else ""), "deep_correction",
            lambda: _fused_correction(hier, entry, rc, cfg),
            lambda: kdeep.deep_correction_plain(packed, hier.lam_max[entry:],
                                                hier.coarse_inv, rc, **kw),
            TOL_F64_DEEP if item == 8 else TOL_F32_DEEP,
            cost_deep(shapes, cfg.degree, cfg.cycle_type, cfg.kcycle_min_cells, item, citem),
            None, check)


def spd_stencil(shape, dtype, dev, seed: int) -> torch.Tensor:
    """A random symmetric positive definite scalar stencil, packed
    (2*dim+1, *grid): lognormal face couplings, zero beyond the boundary,
    the diagonal their sum plus 0.3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dim = len(shape)
    packed = torch.zeros((2 * dim + 1,) + shape, dtype=dtype, device=dev)
    total = torch.zeros(shape, dtype=dtype, device=dev)
    for a in range(dim):
        w = torch.exp(torch.randn(shape, generator=g, dtype=dtype, device=dev))
        idx = torch.arange(shape[a], device=dev).reshape(
            [-1 if i == a else 1 for i in range(dim)])
        packed[1 + 2 * a] = -w * (idx < shape[a] - 1)
        packed[2 + 2 * a] = -torch.roll(w, 1, a) * (idx > 0)
        total += packed[1 + 2 * a].abs() + packed[2 + 2 * a].abs()
    packed[0] = total + 0.3
    return packed


def smooth_case(label, packed, lam, b, x, deg, tol, item):
    from thermalporous_torch.kernels import stencil as kst

    args = (packed, b, x, lam, deg, 0.3)
    grid = tuple(b.shape)
    return (f"chebyshev {label} deg={deg} {'zero' if x is None else 'x0'} "
            f"{'x'.join(map(str, grid))}", "chebyshev_smooth",
            lambda: kst.chebyshev_smooth(*args),
            lambda: kst.chebyshev_smooth_plain(*args), tol,
            cost_chebyshev(math.prod(grid), len(grid), deg, x is not None, item,
                           packed.element_size()), None)


def second_case(label, packed, lam, b, x, deg, kind, tol, item):
    """The smooth with its second output (``kind``: "residual" b - A y or
    "product" A y) against the plain smooth followed by the plain matvec;
    its check times the smooth alone and the standalone matvec that the
    second output replaces."""
    from thermalporous_torch.kernels import stencil as kst

    args = (packed, b, x, lam, deg, 0.3)
    grid = tuple(b.shape)

    def beside():
        y = kst.chebyshev_smooth(*args)
        alone = lambda: kst.chebyshev_smooth(*args)
        mv = lambda: kst.matvec(packed, y)
        t = {"smooth_alone_ms": time_ms(alone, reps=10),
             "smooth_alone_device_ms": time_device_ms(alone, reps=10),
             "matvec_ms": time_ms(mv, reps=10),
             "matvec_device_ms": time_device_ms(mv, reps=10)}
        return (f"  the smooth alone {t['smooth_alone_ms']:.4f} ms "
                f"({t['smooth_alone_device_ms']:.4f} on the card); the standalone matvec "
                f"it replaces {t['matvec_ms']:.4f} ms ({t['matvec_device_ms']:.4f} on the "
                f"card)", t)

    return (f"chebyshev+{kind} {label} deg={deg} {'zero' if x is None else 'x0'} "
            f"{'x'.join(map(str, grid))}", "chebyshev_smooth",
            lambda: kst.chebyshev_smooth(*args, second=kind),
            lambda: kst.chebyshev_smooth_plain(*args, second=kind), tol,
            cost_chebyshev_second(math.prod(grid), len(grid), deg, x is not None, kind, item,
                                  packed.element_size()),
            None, beside)


def level_cases(state, pc, tol, dev):
    """The smooth (the hierarchy's degree, from x0 and from zero) and the
    scalar matvec at every level with more cells than the smallest
    FUSE_CANDIDATES entry: the levels some candidate leaves unfused.  The
    pressure hierarchy's finest level is among :func:`kernel_cases`.  With
    them the smooth's second output as the cycle asks for it on that level."""
    from thermalporous_torch.kernels import stencil as kst

    g = torch.Generator(device=dev).manual_seed(8)
    cases = []
    for hname, hier, cfg, first in (("p", state.gmg_p, pc.gmg, 1), ("T", state.gmg_t, pc.gmg_t, 0)):
        for lev in range(first, len(hier.stencils) - 1):
            s = hier.stencils[lev]
            if math.prod(s.grid_shape) <= min(FUSE_CANDIDATES):
                break
            item = s.packed.element_size()
            b, x0 = (torch.randn(s.grid_shape, generator=g, dtype=s.packed.dtype, device=dev)
                     for _ in range(2))
            for xx in (x0, None):
                cases.append(smooth_case(f"{hname} level {lev}", s.packed, hier.lam_max[lev],
                                         b, xx, cfg.degree, tol, item))
            # the pre-smooth's residual at every level, the post-smooth's
            # product where a K-cycle runs on the level
            kinds = [("residual", None)]
            if (cfg.cycle_type == "k" and lev > 0
                    and math.prod(s.grid_shape) >= cfg.kcycle_min_cells):
                kinds.append(("product", x0))
            for kind, xx in kinds:
                cases.append(second_case(f"{hname} level {lev}", s.packed, hier.lam_max[lev],
                                         b, xx, cfg.degree, kind, tol, item))
            cases.append((f"matvec {hname} level {lev} {'x'.join(map(str, s.grid_shape))}",
                          "matvec", lambda s=s, b=b: kst.matvec(s.packed, b),
                          lambda s=s, b=b: kst.matvec_plain(s.packed, b), tol,
                          cost_matvec(math.prod(s.grid_shape), len(s.grid_shape), item), None))
    return cases


def awkward_cases(dtype, tol, dev):
    """The smooth on AWKWARD_SHAPES with a random SPD stencil, degrees 1, 2
    and 4, from x0 and from zero, alone and with each second output; the
    standalone scalar matvec there."""
    from thermalporous_torch.core.stencil import ScalarStencil
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.chebyshev import gershgorin_lambda_max

    cases = []
    for k, shape in enumerate(AWKWARD_SHAPES):
        packed = spd_stencil(shape, dtype, dev, seed=20 + k)
        lam = gershgorin_lambda_max(ScalarStencil(packed))
        g = torch.Generator(device=dev).manual_seed(30 + k)
        b, x0 = (torch.randn(shape, generator=g, dtype=dtype, device=dev) for _ in range(2))
        for deg in (1, 2, 4):
            for xx in (x0, None):
                cases.append(smooth_case("random SPD", packed, lam, b, xx, deg, tol,
                                         packed.element_size()))
                for kind in ("residual", "product"):
                    cases.append(second_case("random SPD", packed, lam, b, xx, deg, kind,
                                             tol, packed.element_size()))
        cases.append((f"matvec random SPD {'x'.join(map(str, shape))}", "matvec",
                      lambda packed=packed, b=b: kst.matvec(packed, b),
                      lambda packed=packed, b=b: kst.matvec_plain(packed, b), tol,
                      cost_matvec(math.prod(shape), len(shape), packed.element_size()), None))
    return cases


def small_deep_cases(dtype, dev, overrides: dict | None = None):
    """The fused subtrees of phase 5's hierarchies (FLAGSHIP_SMALL with
    SMALL_GMG): entry levels smaller than one block; ``overrides`` replace
    fields of both hierarchies' configurations (phase 10: the W-cycle)."""
    from thermalporous_torch.precond.gmg import _fusable

    _, _, _, pc, st, state = preset_state("tp_spe10_full", dtype, dev, SMALL_GMG,
                                          shape=FLAGSHIP_SMALL)
    g = torch.Generator(device=dev).manual_seed(9)
    cases = []
    for hname, hier, hcfg in (("p", state.gmg_p, pc.gmg), ("T", state.gmg_t, pc.gmg_t)):
        hcfg = dataclasses.replace(hcfg, **(overrides or {}))
        entry = next(l for l in range(1, len(hier.stencils)) if _fusable(hier, l, hcfg, dtype))
        cases.append(deep_case(f"{'x'.join(map(str, FLAGSHIP_SMALL))} {hname}", hier, entry,
                               hcfg, st.coef.element_size(), g))
    return st, cases


def barrier_latencies() -> list:
    """Microseconds of one grid-wide barrier (cooperative launch,
    grid.sync()) and of one cluster barrier (cluster.sync()) per
    BARRIER_PROBES entry: a kernel of 2000 barriers against one of none."""
    from thermalporous_torch.kernels import _lib

    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for kind, blocks, threads in BARRIER_PROBES:
        probe = lambda iters: _lib.launch("tp_barrier_probe", kind, blocks, threads, iters,
                                          stream)
        empty_ms = time_device_ms(lambda: probe(0))
        us = (time_device_ms(lambda: probe(2000)) - empty_ms) / 2000 * 1e3
        name = "grid.sync()" if kind == 0 else "cluster.sync()"
        print(f"  barrier {name} {blocks} blocks x {threads} threads: {us:.4f} us "
              f"(a launch of no barriers: {empty_ms * 1e3:.2f} us on the card)", flush=True)
        rows.append({"kind": name, "blocks": blocks, "threads": threads, "us": us,
                     "empty_launch_us": empty_ms * 1e3})
    return rows


def library_call(lib, st, csr: dict):
    """One PyTorch call computing the same function (torch.sparse.mm on a
    CSR of the operator, built once per operator into ``csr``), or None."""
    if lib is None:
        return None
    if lib[0] == "block":
        key, v = "block", lib[1]
        if key not in csr:
            csr[key] = block_csr(st.coef)
        a = csr[key]
        return lambda: spmv(a, v)
    s, vv = lib[1], lib[2]
    a = block_csr(s.packed.reshape((s.packed.shape[0], 1, 1) + s.grid_shape))
    return lambda: spmv(a, vv)


#: every row phase 2 prints, for the --json record
ROWS: list = []


def run_cases(tname, cases, st, rec, dtype, record: bool) -> None:
    """Each case against its plain version, timed; the library yardstick of
    every f32 case that has one, and for J(u)v also the block matvec on the
    same Jacobian.  With ``record``, the first case of each kernel makes its
    record in ``rec``."""
    from thermalporous_torch.kernels import stencil as kst

    csr: dict = {}
    parts = lambda r: r if isinstance(r, tuple) else (r,)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(parts(a), parts(b)))
    for label, kname, kern, plain, tol, cost, lib, *more in cases:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        errs = [rel_err(g, r, g.dim() > st.dim) for g, r in zip(parts(got), parts(ref))]
        rel, abs_ = max(e[0] for e in errs), max(e[1] for e in errs)
        ok = (math.isfinite(rel) and rel <= tol and len(parts(got)) == len(parts(ref))
              and all(bool(torch.isfinite(g).all()) for g in parts(got)))
        # deterministic: a second run on the same input gives the same bits
        ok = ok and same(got, kern())
        note = "  rerun bitwise"
        if kname in ("chebyshev_smooth", "matvec", "fused_stage2_rbgs", "block_rbgs_half_sweep"):
            ok = ok and same(got, ref)
            note += ", bitwise equal to plain"
        ms, device_ms = time_ms(kern), time_device_ms(kern)
        plain_ms = time_ms(plain, reps=PLAIN_REPS, warm=1)
        # the coarse subtree is latency-bound: also time it on a cold L2
        cold_ms = time_cold_ms(kern) if kname == "deep_correction" else None
        bnd, by = bound_ms(*cost)
        lib_fn = library_call(lib, st, csr) if dtype == torch.float32 else None
        lib_ms = time_ms(lib_fn) if lib_fn is not None else None
        b1_ms = None
        if kname.startswith("fused_jvp") and lib is not None:
            vj = lib[1]
            b1_ms = time_ms(lambda: kst.block_matvec(st.coef, vj, st.nc))
        print(f"  {tname} {label}: max_rel_err {rel:.3e} (tol {tol:.0e}) "
              f"max_abs_err {abs_:.3e}  kernel {ms:.4f} ms ({device_ms:.4f} on the card)  "
              f"plain {plain_ms:.4f} ms  bound {bnd:.4f} ms ({by})"
              + (f"  cold L2 {cold_ms:.4f} ms" if cold_ms is not None else "")
              + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else "")
              + (f"  block_matvec on the same Jacobian {b1_ms:.4f} ms"
                 if b1_ms is not None else "")
              + note + f"  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"parity breach: {tname} {label}")
        extra = {}
        if more:
            text = more[0]()
            if isinstance(text, tuple):
                text, extra = text
            print("  " + text, flush=True)
        row = {"max_abs_err": abs_, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms, "cold_ms": cold_ms,
               "device_ms": device_ms, "block_matvec_same_jacobian_ms": b1_ms, "case": label,
               **extra}
        ROWS.append(dict(row, dtype=tname, kernel=kname))
        if record and kname not in rec:
            rec[kname] = row
        del got, ref


def shape_problem(shape, dtype, dev, single_phase: bool, seed: int):
    """A model and its data on a grid of ``shape``: lognormal permeability,
    random porosity, gravity in 3D, a hot BHP injector, a BHP producer, a
    producing rate well and a heater."""
    from thermalporous_torch.core import Grid
    from thermalporous_torch.models import SinglePhaseModel, TwoPhaseModel, make_problem_data
    from thermalporous_torch.physics import Heater, PhysicalParams, Well

    dim = len(shape)
    pp = PhysicalParams()
    grid = Grid(shape=shape, spacing=(5.0, 5.0) + ((2.0,) if dim == 3 else ()),
                thickness=10.0, gravity=9.81 if dim == 3 else 0.0)
    rng = np.random.default_rng(seed)
    kx = 2e-13 * np.exp(0.5 * rng.standard_normal(shape))
    phi = 0.1 + 0.2 * rng.random(shape)
    first, last = (0,) * dim, tuple(m - 1 for m in shape)
    mid = tuple(m // 2 for m in shape)
    wells = [Well(cells=(first,), control="bhp", p_bh=4.0e7, T_inj=420.0, name="inj"),
             Well(cells=(last,), control="bhp", p_bh=1.0e7, name="prod"),
             Well(cells=(mid,), control="rate", rate=-0.5, name="rate")]
    heaters = [Heater(cells=(first[:-1] + (shape[-1] - 1,),), power=1.0e5)]
    data = make_problem_data(grid, pp, kx=kx, phi=phi, wells=wells, heaters=heaters,
                             dtype=dtype, device=dev)
    model = SinglePhaseModel(grid, pp) if single_phase else TwoPhaseModel(grid, pp, s_init=0.2)
    return model, data


def model_shape_checks(dtype, tname, dev) -> None:
    """The residual and J(u)v kernels of both models on MODEL_SHAPES
    against their plain versions (the two-phase model also at saturations
    exactly 0 and 1), each run twice on one input."""
    from thermalporous_torch.kernels import _lib
    from thermalporous_torch.kernels import residual as kres

    f64 = dtype == torch.float64
    tol_res, tol_jvp = (TOL_F64, TOL_F64) if f64 else (TOL_F32_RESIDUAL, TOL_F32_JVP)
    sms = _lib.device_limits(torch.cuda.current_device())[0]
    for k, shape in enumerate(MODEL_SHAPES):
        plan, dual = kres.model_plan(shape, sms), kres.model_plan(shape, sms, jvp=True)
        print(f"  {tname} {'x'.join(map(str, shape))}: tile {plan.ty} x {plan.tz}, "
              f"{plan.threads} threads a block, {plan.lx} planes a block in {plan.blocks} "
              f"blocks (J(u)v: {dual.lx} in {dual.blocks})", flush=True)
        for single_phase in (False, True):
            model, data = shape_problem(shape, dtype, dev, single_phase, seed=40 + k)
            u0, u = perturbed_state(model, data, seed=50 + k)
            states = [("", u)] + ([] if single_phase else [(" S at 0 and 1", tie_state(u, data))])
            g = torch.Generator(device=dev).manual_seed(60 + k)
            for note, uu in states:
                v = (state_amp(uu) * torch.randn(tuple(uu.shape), generator=g, dtype=dtype,
                                                 device=dev)).contiguous()
                for kname, kern, plain, tol in (
                        ("fused_residual", lambda: kres.fused_residual(model, uu, u0, 600.0, data),
                         lambda: model.residual(uu, u0, 600.0, data), tol_res),
                        ("fused_jvp", lambda: kres.fused_jvp(model, uu, v, u0, 600.0, data),
                         lambda: model.jvp(uu, u0, 600.0, data)(v), tol_jvp)):
                    got, ref = kern(), plain()
                    torch.cuda.synchronize()
                    rel, abs_ = rel_err(got, ref, True)
                    ok = (math.isfinite(rel) and rel <= tol and bool(torch.isfinite(got).all())
                          and torch.equal(got, kern()))
                    device_ms = time_device_ms(kern, reps=10)
                    label = (f"{kname}{'_sp' if single_phase else ''} "
                             f"{'x'.join(map(str, shape))}{note}")
                    print(f"  {tname} {label}: max_rel_err {rel:.3e} (tol {tol:.0e}) "
                          f"max_abs_err {abs_:.3e}  {device_ms:.4f} ms on the card  rerun bitwise"
                          f"  {'ok' if ok else 'FAIL'}", flush=True)
                    if not ok:
                        raise SystemExit(f"parity breach: {tname} {label}")
                    ROWS.append({"dtype": tname, "kernel": kname + ("_sp" if single_phase else ""),
                                 "case": label, "max_rel_err": rel, "max_abs_err": abs_,
                                 "device_ms": device_ms})
                    del got, ref
            del model, data, u0, u, states
            torch.cuda.empty_cache()


def fuse_apply_times(st, state, pc, dev) -> dict:
    """The CPTR apply on the flagship, unfused and with the subtree fused
    from each FUSE_CANDIDATES entry, in turns (0, a, b, c, c, b, a, 0)."""
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
    best = min(times, key=lambda fb: statistics.mean(times[fb]))
    print(f"  fastest CPTR apply: fuse_below={best} (the flagship runs use "
          f"{FLAGSHIP_FUSE_BELOW})", flush=True)
    return times


def kernel_parity(dev) -> tuple:
    """Phase 2: the barrier latencies, then each kernel against its plain
    version, at the benchmark's 2D shapes and on the flagship; returns the
    flagship f32 record per kernel, the CPTR apply times per fuse_below and
    the barrier latencies."""
    from thermalporous_torch.precond.cpr import cpr_setup
    from thermalporous_torch.presets import get_case

    _, bench_pc = bench_configs()
    rec: dict = {}
    fuse_times = None
    barriers = barrier_latencies()
    for dtype in (torch.float64, torch.float32):
        tname = "f64" if dtype == torch.float64 else "f32"
        tol_st = TOL_F64 if dtype == torch.float64 else TOL_F32_STENCIL
        tol_res = TOL_F64 if dtype == torch.float64 else TOL_F32_RESIDUAL
        tol_jvp = TOL_F64 if dtype == torch.float64 else TOL_F32_JVP
        # the benchmark's 2D case
        model, data = bench_case(N_MAIN, dtype, dev)
        u0, u = perturbed_state(model, data)
        st = model.assemble_stencil(u, u0, 600.0, data)
        state = cpr_setup(st, bench_pc)
        run_cases(tname, kernel_cases(model, data, st, state, u0, u, tol_st, tol_res,
                                      tol_jvp, dev)
                  + [probe_case(model, data, st, u0, u, tol_jvp)],
                  st, rec, dtype, record=False)
        del model, data, st, state, u0, u
        torch.cuda.empty_cache()
        # the flagship, with its baked coarsening schedule and the subtree
        # fused as in phase 6
        case, u0, u, pc, st, state = preset_state("tp_spe10_full", dtype, dev,
                                                  dict(fuse_below=FLAGSHIP_FUSE_BELOW))
        model, data = case.model, case.data
        for hname, hier in (("p", state.gmg_p), ("T", state.gmg_t)):
            print(f"  {tname} flagship {hname} hierarchy: "
                  + " -> ".join(str(math.prod(s.grid_shape)) for s in hier.stencils)
                  + " cells", flush=True)
        cases = (kernel_cases(model, data, st, state, u0, u, tol_st, tol_res, tol_jvp, dev)
                 + [probe_case(model, data, st, u0, u, tol_jvp)]
                 + flagship_cases(st, state, pc, dtype, dev)
                 + level_cases(state, pc, tol_st, dev) + awkward_cases(dtype, tol_st, dev)
                 + rbgs_shape_cases(dtype, tol_st, dev))
        run_cases(tname, cases, st, rec, dtype, record=dtype == torch.float32)
        if dtype == torch.float32:
            fuse_times = fuse_apply_times(st, state, pc, dev)
        del case, model, data, st, state, u0, u, cases
        torch.cuda.empty_cache()
        st, cases = small_deep_cases(dtype, dev)
        run_cases(tname, cases, st, rec, dtype, record=False)
        del st, cases
        # the single-phase model: the benchmark's grid, then sp_geothermal_3d
        # at its preset size (its f32 cases make the single-phase records)
        for geo in (False, True):
            if geo:
                case = get_case("sp_geothermal_3d", device=dev, dtype=dtype)
                model, data = case.model, case.data
            else:
                model, data = bench_case(N_MAIN, dtype, dev, single_phase=True)
            u0, u = perturbed_state(model, data)
            st = model.assemble_stencil(u, u0, 600.0, data)
            run_cases(tname, sp_cases(model, data, st, u0, u, tol_st, tol_res, tol_jvp, dev,
                                      with_b1=not geo)
                      + ([probe_case(model, data, st, u0, u, tol_jvp)] if geo else []),
                      st, rec, dtype, record=geo and dtype == torch.float32)
            del model, data, st, u0, u
            torch.cuda.empty_cache()
        model_shape_checks(dtype, tname, dev)
    return rec, fuse_times, barriers


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


def with_krylov_op(case, krylov_op: str):
    return dataclasses.replace(case.newton_cfg, krylov_op=krylov_op)


# phases 5, 8 and 9: the GPU-against-CPU count checks by name: (preset,
# controller steps, Krylov operator, GMG overrides, stage-2 sweeps, the
# preset's size keywords), each in f64
COUNT_CASES = {
    "flagship": ("tp_spe10_full", SMALL_STEPS, "stencil", SMALL_GMG, None,
                 dict(shape=FLAGSHIP_SMALL)),
    "flagship sweeps=2": ("tp_spe10_full", SMALL_STEPS, "stencil", SMALL_GMG, 2,
                          dict(shape=FLAGSHIP_SMALL)),
    "sp_hot_injection_2d": ("sp_hot_injection_2d", 3, "stencil", None, None, {}),
    "flagship jvp": ("tp_spe10_full", SMALL_STEPS, "jvp", SMALL_GMG, None,
                     dict(shape=FLAGSHIP_SMALL)),
}


def counts_run(key: str, device: str) -> tuple:
    """COUNT_CASES entry ``key`` through the Simulator on ``device``: the
    (dt, Newton, FGMRES, retries) records and, on the card, the launches."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.presets import get_case

    name, steps, krylov_op, pc_overrides, stage2_sweeps, case_kw = COUNT_CASES[key]
    case = get_case(name, device=device, dtype=torch.float64, **case_kw)
    pc = case.pc_cfg if pc_overrides is None else with_fuse(case.pc_cfg, **pc_overrides)
    if stage2_sweeps is not None:
        pc = dataclasses.replace(pc, stage2_sweeps=stage2_sweeps)
    sim = case.simulator(newton_cfg=with_krylov_op(case, krylov_op), pc_cfg=pc)
    reset_launch_counts()
    res = sim.run(case.t_end, max_steps=steps)
    return ([(r.dt, r.newton_iters, r.ksp_iters, r.retries) for r in res.records],
            launch_counts() if device == "cuda" else None)


def _counts_cpu_task(key: str) -> list:
    """The CPU's records of COUNT_CASES entry ``key`` (a task of the
    references' pool)."""
    torch.set_num_threads(1)
    return counts_run(key, "cpu")[0]


def gpu_cpu_counts(key: str, kernels: tuple, refs: dict | None) -> dict:
    """COUNT_CASES entry ``key`` on the card and on the CPU (from the
    references' pool ``refs``, else run here): the records per device, and
    the card's launches under "launches".  On the card each of ``kernels``
    must launch, and the records must agree."""
    cuda, launches = counts_run(key, "cuda")
    out = {"cpu": (refs[("counts", key)].get(timeout=1200) if refs is not None
                   else counts_run(key, "cpu")[0]), "cuda": cuda, "launches": launches}
    print(f"  cuda launches {out['launches']}")
    missing = [k for k in kernels if out["launches"][k] <= 0]
    if missing:
        raise SystemExit(f"{key}: launched no {missing}")
    if out["cpu"] != out["cuda"]:
        raise SystemExit(f"{key}: cpu {out['cpu']} != cuda {out['cuda']}")
    return out


def flagship_parity(refs: dict | None, krylov_op: str = "stencil",
                    stage2_sweeps: int | None = None) -> dict:
    """Phase 5 (and 9): the flagship configuration at FLAGSHIP_SMALL, f64,
    through the Simulator on each device (with ``stage2_sweeps`` stage-2
    sweeps: the half-sweep kernel's path)."""
    kernels = (SWEEPS_KERNELS if stage2_sweeps else ("deep_correction", "fused_stage2_rbgs")
               ) + (("fused_jvp",) if krylov_op == "jvp" else ())
    key = ("flagship jvp" if krylov_op == "jvp" else
           "flagship sweeps=2" if stage2_sweeps else "flagship")
    return gpu_cpu_counts(key, kernels, refs)


def flagship_run(dev, steps: int = FLAGSHIP_STEPS, krylov_op: str = "stencil",
                 name: str = "tp_spe10_full", by_cols: dict | None = None,
                 pc_overrides: dict | None = None, variants: dict | None = None,
                 kernels: tuple = FLAGSHIP_KERNELS, gmg_overrides: dict | None = None,
                 newton_overrides: dict | None = None, counting=None,
                 dt_init: float | None = None):
    """Phase 6 (and 9, 10, 12, 13): preset ``name`` (the flagship or its
    inner-iteration form) at full size, f32, with the CPRConfig
    ``pc_overrides``, the GMG overrides ``gmg_overrides`` (both
    hierarchies) and the NewtonConfig overrides ``newton_overrides``, the
    first ``steps`` controller steps (block matvecs by (nc, k) and stage 2s
    by k counted into ``by_cols`` when given, the bf16 and batched launches
    into ``variants``, inside the context manager ``counting`` when given);
    returns (records, launches, Newton over all attempts, cell-updates/s
    over the steps after the first (over the one step when there is one),
    peak GiB)."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from thermalporous_torch.presets import get_case

    case = get_case(name, device=dev)
    pc = dataclasses.replace(with_fuse(case.pc_cfg, FLAGSHIP_FUSE_BELOW), **(pc_overrides or {}))
    pc = option_config(pc, {}, gmg_overrides or {})
    newton = dataclasses.replace(with_krylov_op(case, krylov_op), **(newton_overrides or {}))
    time_cfg = case.time_cfg if dt_init is None else dataclasses.replace(case.time_cfg,
                                                                         dt_init=dt_init)
    sim = case.simulator(pc_cfg=pc, newton_cfg=newton, time_cfg=time_cfg)
    for hname, g in (("p", sim.pc_cfg.gmg), ("T", sim.pc_cfg.gmg_t or sim.pc_cfg.gmg)):
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
    with (contextlib.nullcontext() if by_cols is None else count_by_columns(by_cols)), \
            (contextlib.nullcontext() if counting is None else counting):
        res = sim.run(case.t_end, max_steps=steps)
        torch.cuda.synchronize()
    launches = launch_counts()
    if variants is not None:
        variants.update(variant_counts())
    for r in res.records:
        print(f"  step {r.step} dt {r.dt:.1f} s: newton {r.newton_iters} "
              f"fgmres {r.ksp_iters} retries {r.retries} wall {r.wall_s:.3f} s "
              f"next dt {r.next_dt:.1f} s cap {r.dt_cap}")
    if res.steps < steps:
        raise SystemExit(f"{name}: {res.steps} steps < {steps}")
    later = res.records[1:] or res.records
    cu_s = (math.prod(case.model.grid.shape) * sum(r.newton_iters for r in later)
            / sum(r.wall_s for r in later))
    print(f"  launches {launches}; Newton iterations over all attempts "
          f"{attempts['newton']} in {attempts['attempts']} solves")
    check_physical(res.u, case.model.grid.shape, name)
    # with the J(u)v operator no block matvec is left on the path: the
    # stage-2 residual is inside the stage-2 kernel
    if krylov_op != "stencil":
        kernels = tuple(k for k in kernels if k != "block_matvec") + ("fused_jvp",)
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise SystemExit(f"{name} ({krylov_op}) launched no {missing}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    return res.records, launches, attempts, cu_s, peak


def flagship_layers(dev) -> dict:
    """Phase 7: phase 6's first LAYER_STEPS steps again with a
    ``torch.cuda.synchronize()`` before and after each layer's call, so that
    host timers give each layer's wall; then one more step of the same Δt
    from the last state, timed plainly and under the profiler, whose CUDA
    kernel events give the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    from thermalporous_torch.kernels import deep_cycle as kdeep
    from thermalporous_torch.kernels import (
        launch_counts,
        reset_launch_counts,
        second_output_counts,
    )
    from thermalporous_torch.kernels import stencil as kst
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

    # launches by level: each wrapper called through a forwarder that counts
    # by the grid shape of its vector argument
    by_level: dict[tuple, int] = {}

    def by_shape(name, fn, arg):
        def call(*args, **kw):
            if kw.get("second"):
                extra = (f"{name}+{kw['second']}", tuple(args[arg].shape))
                by_level[extra] = by_level.get(extra, 0) + 1
            key = (name, tuple(args[arg].shape))
            by_level[key] = by_level.get(key, 0) + 1
            return fn(*args, **kw)
        call.launches = 0      # the wrapper counts on the name it is called by
        return call

    # the block matvec and the stage 2 by the block columns they take
    by_k: dict[str, int] = {}
    real_kernels = (kst.chebyshev_smooth, kst.matvec, kdeep.deep_correction)
    case = get_case("tp_spe10_full", device=dev)
    sim = case.simulator(pc_cfg=with_fuse(case.pc_cfg, FLAGSHIP_FUSE_BELOW))
    ttimeloop.newton_solve, tnewton.fgmres = solve, timed("FGMRES", real_fgmres)
    kst.chebyshev_smooth = by_shape("chebyshev_smooth", real_kernels[0], 1)
    kst.matvec = by_shape("matvec", real_kernels[1], 1)
    kdeep.deep_correction = by_shape("deep_correction", real_kernels[2], 3)
    try:
        with count_by_columns(by_k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = sim.run(case.t_end, max_steps=LAYER_STEPS)
            total = time.perf_counter() - t
    finally:
        ttimeloop.newton_solve, tnewton.fgmres = real_solve, real_fgmres
        kst.chebyshev_smooth, kst.matvec, kdeep.deep_correction = real_kernels
    newton = sum(r.newton_iters for r in res.records)
    for (name, shape), count in sorted(by_level.items(), key=lambda kv: (kv[0][0], -math.prod(kv[0][1]))):
        print(f"  {name} {'x'.join(map(str, shape))} ({math.prod(shape)} cells): {count} "
              f"launches, {count / newton:.1f} per Newton")
    per_newton = {k: sum(c for (nm, _), c in by_level.items() if nm == k) / newton
                  for k in ("chebyshev_smooth", "chebyshev_smooth+residual",
                            "chebyshev_smooth+product", "matvec", "deep_correction")}
    print("  per Newton: " + ", ".join(f"{k} {v:.1f}" for k, v in per_newton.items()))
    k_per_newton = {key: c / newton for key, c in sorted(by_k.items())}
    print("  per Newton by block columns: " + ", ".join(
        f"{key} {v:.2f}" for key, v in k_per_newton.items())
        + " (the FGMRES operator is block_matvec k=3; the stage-2 residual, k=2 before "
        "the stage-2 kernel, is inside fused_stage2_rbgs k=2)")
    if by_k.get("block_matvec nc=3 k=2", 0):
        raise SystemExit("flagship: block_matvec k=2 launched; the stage 2 should be one launch")
    for name in ("assembly", "CPTR setup", "FGMRES", "CPTR apply", "residual"):
        print(f"  {name}: {wall.get(name, 0.0):.3f} s of {total:.3f} s "
              f"({100 * wall.get(name, 0.0) / total:.1f}%) in {calls.get(name, 0)} calls")
    apply_ms = 1e3 * wall.get("CPTR apply", 0.0) / max(calls.get("CPTR apply", 0), 1)
    print(f"  CPTR apply: {apply_ms:.3f} ms an apply, {calls.get('CPTR apply', 0) / newton:.2f} "
          f"applies per Newton")

    dt = res.records[-1].dt
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, st = sim.step(res.u, dt)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    reset_launch_counts()
    # the device's activity only: the host's thousands of operator events of
    # an assembly would take the profiler a minute to gather
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.step(res.u, dt)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    # one device kernel per smooth, per standalone scalar matvec, per subtree
    # visit, per stage 2 and per block matvec: the profiler's kernel events
    # against the wrappers' counters over the same step
    counted = launch_counts()
    for wrapper, kernel in (("chebyshev_smooth", "cheb_smooth_kernel"),
                            ("matvec", "scalar_matvec_kernel"),
                            ("deep_correction", "deep_kernel"),
                            ("fused_stage2_rbgs", "stage2_kernel"),
                            ("block_matvec", "block_matvec_kernel")):
        seen = [e for e in events if kernel in e.key]
        on_card = sum(e.count for e in seen)
        print(f"  {wrapper}: {counted[wrapper]} wrapper launches, {on_card} {kernel} "
              f"events on the card, {sum(e.self_device_time_total for e in seen) / 1e3:.3f} ms"
              + ("" if seen else " (the profiler named no such kernel)"))
        if seen and on_card != counted[wrapper]:
            raise SystemExit(f"{wrapper}: {counted[wrapper]} launches but {on_card} kernels")
    seconds = second_output_counts()
    print(f"  second outputs of the smooth in that step: {seconds} (each a scalar matvec "
          f"that did not launch)")
    print(f"  one more step at dt {dt:.1f} s: newton {st.iters} fgmres {st.ksp_iters} "
          f"wall {step_s:.3f} s; CUDA kernel time under the profiler "
          f"{busy_us / 1e6:.3f} s = {100 * busy_us / 1e6 / step_s:.1f}% of that wall")
    return {"total_s": total, "newton": newton, "layer_s": wall, "layer_calls": calls,
            "launches_by_level": {f"{k} {'x'.join(map(str, sh))}": c
                                  for (k, sh), c in by_level.items()},
            "launches_per_newton": per_newton, "launches_per_newton_by_k": k_per_newton,
            "cptr_apply_ms": apply_ms,
            "step_second_outputs": seconds,
            "step_s": step_s, "step_newton": st.iters, "step_fgmres": st.ksp_iters,
            "device_busy_s": busy_us / 1e6}


def sp_geothermal_run(dev, steps: int, krylov_op: str = "stencil"):
    """Phase 8 (and 9): sp_geothermal_3d at its preset size, f32, the first
    ``steps`` controller steps; checks the state (finite, no undershoot below
    T_init - 1 K) and that each kernel of the path launched; returns
    (records, launches, cell-updates/s, well rates)."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.physics import well_rates
    from thermalporous_torch.presets import get_case

    case = get_case("sp_geothermal_3d", device=dev)
    sim = case.simulator(newton_cfg=with_krylov_op(case, krylov_op))
    torch.cuda.synchronize()
    reset_launch_counts()
    res = sim.run(case.t_end, max_steps=steps)
    torch.cuda.synchronize()
    launches = launch_counts()
    for r in res.records:
        print(f"  step {r.step} dt {r.dt:.1f} s: newton {r.newton_iters} "
              f"fgmres {r.ksp_iters} retries {r.retries} wall {r.wall_s:.3f} s")
    if res.steps < steps:
        raise SystemExit(f"sp_geothermal_3d: {res.steps} steps < {steps}")
    later = res.records[1:]
    cu_s = (math.prod(case.model.grid.shape) * sum(r.newton_iters for r in later)
            / sum(r.wall_s for r in later))
    u, t_init = res.u, case.model.pp.T_init
    p, t = u[0], u[1]
    print(f"  T in [{float(t.min()):.3f}, {float(t.max()):.3f}] K (T_init {t_init}), "
          f"p in [{float(p.min()):.6e}, {float(p.max()):.6e}] Pa")
    rates = well_rates(case.model, u, case.data, case.well_masks)
    for name, rec in rates.items():
        print(f"  well {name}: " + ", ".join(f"{k} {v:.6e}" for k, v in rec.items()))
    print(f"  launches {launches}")
    if (tuple(u.shape) != (2,) + case.model.grid.shape or not bool(torch.isfinite(u).all())
            or float(t.min()) < t_init - 1.0):
        raise SystemExit("sp_geothermal_3d: state not finite or T below T_init - 1 K")
    kernels = ("fused_jvp_sp",) if krylov_op == "jvp" else SP_KERNELS
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise SystemExit(f"sp_geothermal_3d ({krylov_op}) launched no {missing}")
    return res.records, launches, cu_s, rates


# ------------------------------------------------------ phase 10: solver options

# the options of the parity tests (tests/test_torch_cpr_variants.py,
# tests/test_torch_krylov_options.py), each run on the flagship
# configuration at FLAGSHIP_SMALL (f64, GPU against CPU): (label, CPRConfig
# overrides, overrides of both GMG configurations, NewtonConfig overrides,
# preconditioner name, preset and its keywords where another case is run)
_OPTIONS = (
    ("decoupling=timpes", dict(decoupling="timpes"), {}, {}, "cptr", None),
    ("decoupling=abf", dict(decoupling="abf"), {}, {}, "cptr", None),
    ("variant=cpr", dict(variant="cpr"), {}, {}, "cptr", None),
    ("triangular=False", dict(triangular=False), {}, {}, "cptr", None),
    ("inner fgmres", dict(inner_iters=2), {}, {}, "cptr", None),
    ("inner richardson", dict(inner_iters=2, inner_method="richardson"), {}, {}, "cptr", None),
    ("s_stage=rbgs", dict(s_stage="rbgs"), {}, {}, "cptr", None),
    ("s_stage=jacobi", dict(s_stage="jacobi"), {}, {}, "cptr", None),
    ("s_stage=zebra", dict(s_stage="zebra", s_axis=1), {}, {}, "cptr", None),
    ("s_stage=line", dict(s_stage="line", s_axis=2), {}, {}, "cptr", None),
    # no stage 2 leaves the saturation unpreconditioned (x1 has no S
    # component): that option runs on the single-phase box, as in the tests
    ("stage2=none", dict(stage2="none"), {}, {}, "cptr",
     ("sp_geothermal_3d", dict(nx=8, ny=8, nz=6))),
    ("stage2=block_jacobi", dict(stage2="block_jacobi"), {}, {}, "cptr", None),
    ("stage2=jacobi2", dict(stage2="jacobi2"), {}, {}, "cptr", None),
    ("stage2=rbgs sweeps=2", dict(stage2_sweeps=2), {}, {}, "cptr", None),
    ("stage2=zebra", dict(stage2="zebra"), {}, {}, "cptr", None),
    ("stage2_fused", dict(stage2_fused=True), {}, {}, "cptr", None),
    ("stage2_fused axes=(2,) sweeps=2", dict(stage2_fused=True, stage2_axes=(2,),
                                              stage2_sweeps=2), {}, {}, "cptr", None),
    ("stage2_axes=(0, 2)", dict(stage2_axes=(0, 2)), {}, {}, "cptr", None),
    ("smoother=jacobi", {}, dict(smoother="jacobi"), {}, "cptr", None),
    ("smoother=rbgs", {}, dict(smoother="rbgs"), {}, "cptr", None),
    ("smoother=line", {}, dict(smoother="line", line_axis=2), {}, "cptr", None),
    ("smoother=zebra", {}, dict(smoother="zebra"), {}, "cptr", None),
    ("semicoarsen_z", {}, dict(semicoarsen_z=True, coarsen="geometric", level_factors=None),
     {}, "cptr", None),
    ("cycles=2", {}, dict(cycles=2), {}, "cptr", None),
    ("W unfused", {}, dict(cycle_type="w", fuse_below=0), {}, "cptr", None),
    ("W fused", {}, dict(cycle_type="w"), {}, "cptr", None),
    ("ksp_orth=cgs1", {}, {}, dict(ksp_orth="cgs1"), "cptr", None),
    ("ksp_orth=cgs2s", {}, {}, dict(ksp_orth="cgs2s"), "cptr", None),
    ("ksp_orth=cgs2g", {}, {}, dict(ksp_orth="cgs2g"), "cptr", None),
    ("ksp_orth=cgs2g2", {}, {}, dict(ksp_orth="cgs2g2"), "cptr", None),
    ("ksp_restart=8", {}, {}, dict(ksp_restart=8), "cptr", None),
    ("pc_lag=step", {}, {}, dict(pc_lag="step"), "cptr", None),
    ("precond=cpr", {}, {}, {}, "cpr", None),
    ("precond=rbgs", {}, {}, {}, "rbgs", None),
    # the dense inverse is refused above 20,000 unknowns: 6x8x4x3 = 576
    ("precond=lu", {}, {}, {}, "lu", ("tp_spe10_full", dict(shape=(6, 8, 4)))),
    # bf16 coefficient storage (each mode; with jacobi2 the stage-2 block
    # matvecs read bf16, with two sweeps the half-sweeps) and the batched
    # p/T traversal (the T hierarchy takes the pressure configuration)
    ("pc_dtype=bf16", dict(pc_dtype="bf16"), {}, {}, "cptr", None),
    ("pc_dtype=bf16 stage2=jacobi2", dict(pc_dtype="bf16", stage2="jacobi2"), {}, {}, "cptr",
     None),
    ("pc_dtype=bf16_gmg", dict(pc_dtype="bf16_gmg"), {}, {}, "cptr", None),
    ("pc_dtype=bf16_s2 sweeps=2", dict(pc_dtype="bf16_s2", stage2_sweeps=2), {}, {}, "cptr",
     None),
    ("batch_pt", dict(batch_pt=True, triangular=False, gmg_t=None), {}, {}, "cptr", None),
    ("batch_pt pc_dtype=bf16 inner", dict(batch_pt=True, triangular=False, gmg_t=None,
                                          pc_dtype="bf16", inner_iters=2), {}, {}, "cptr", None),
    # the operator-weighted and variational transfers (wide coarse levels:
    # no fused subtree), the bgmg stage 2 and Krylov recycling
    ("transfer=weighted", {}, dict(transfer="weighted"), {}, "cptr", None),
    ("transfer=variational", {}, dict(transfer="variational"), {}, "cptr", None),
    ("transfer=variational pc_dtype=bf16_gmg", dict(pc_dtype="bf16_gmg"),
     dict(transfer="variational"), {}, "cptr", None),
    ("stage2=bgmg", dict(stage2="bgmg"), {}, {}, "cptr", None),
    ("stage2=bgmg cycles=2 sweeps=2", dict(stage2="bgmg", bgmg_cycles=2, stage2_sweeps=2),
     {}, {}, "cptr", None),
    ("stage2=bgmg pc_dtype=bf16_s2", dict(stage2="bgmg", pc_dtype="bf16_s2"), {}, {}, "cptr",
     None),
    ("ksp_recycle=4", {}, {}, dict(ksp_recycle=4), "cptr", None),
)
#: phase 10(c): options that act on different parts of the solver share a
#: run (the decoupling, the stage-1 variant or its saturation leg or inner
#: iterations, the stage 2, the multigrid's smoother or cycle, the Krylov
#: method), each pair one configuration on the card and the CPU; the options
#: phases 12 and 13 report, "W fused" and the other presets run alone
OPTION_PAIRS = (
    ("decoupling=timpes", "smoother=jacobi"), ("decoupling=abf", "smoother=rbgs"),
    ("variant=cpr", "ksp_orth=cgs1"), ("triangular=False", "smoother=line"),
    ("inner fgmres", "ksp_orth=cgs2s"), ("inner richardson", "ksp_orth=cgs2g"),
    ("s_stage=rbgs", "stage2=jacobi2"), ("s_stage=jacobi", "stage2=block_jacobi"),
    ("s_stage=zebra", "cycles=2"), ("s_stage=line", "ksp_orth=cgs2g2"),
    ("stage2=rbgs sweeps=2", "smoother=zebra"), ("stage2=zebra", "semicoarsen_z"),
    ("stage2_fused", "ksp_restart=8"), ("stage2_fused axes=(2,) sweeps=2", "pc_lag=step"),
    ("stage2_axes=(0, 2)", "W unfused"),
)


def _paired_options() -> tuple:
    """SOLVER_OPTIONS: each OPTION_PAIRS pair merged into one entry (label
    "a + b", the overrides of both), the other _OPTIONS entries alone."""
    by = {o[0]: o for o in _OPTIONS}
    paired = {label for pair in OPTION_PAIRS for label in pair}
    out = []
    for a, b in OPTION_PAIRS:
        oa, ob = by[a], by[b]
        if oa[4:] != ob[4:]:
            raise AssertionError(f"options {a!r} and {b!r} run different cases")
        out.append((f"{a} + {b}", dict(oa[1], **ob[1]), dict(oa[2], **ob[2]),
                    dict(oa[3], **ob[3])) + oa[4:])
    return tuple(out) + tuple(o for o in _OPTIONS if o[0] not in paired)


SOLVER_OPTIONS = _paired_options()
#: phase 12(e): the options of SOLVER_OPTIONS that phase 12 reports
PC12_OPTIONS = ("pc_dtype=bf16", "pc_dtype=bf16 stage2=jacobi2", "pc_dtype=bf16_gmg",
                "pc_dtype=bf16_s2 sweeps=2", "batch_pt", "batch_pt pc_dtype=bf16 inner")
#: phase 13(e): the options of SOLVER_OPTIONS that phase 13 reports, and the
#: launches each must show on the card: (counter, kind) with kind "wrapper"
#: (> 0), "none" (== 0) or "variant" (a bf16 instantiation, > 0)
P13_CHECKS = {
    "transfer=weighted": (("chebyshev_smooth", "wrapper"), ("deep_correction", "none")),
    "transfer=variational": (("chebyshev_smooth", "wrapper"), ("deep_correction", "none")),
    "transfer=variational pc_dtype=bf16_gmg": (("chebyshev_smooth bf16", "variant"),
                                                ("deep_correction", "none")),
    "stage2=bgmg": (("fused_stage2_rbgs", "wrapper"), ("block_rbgs_half_sweep", "wrapper")),
    "stage2=bgmg cycles=2 sweeps=2": (("fused_stage2_rbgs", "wrapper"),
                                      ("block_rbgs_half_sweep", "wrapper")),
    "stage2=bgmg pc_dtype=bf16_s2": (("fused_stage2_rbgs bf16", "variant"),
                                     ("block_rbgs_half_sweep bf16", "variant")),
    "ksp_recycle=4": (("deep_correction", "wrapper"), ("fused_stage2_rbgs", "wrapper")),
}
P13_OPTIONS = tuple(P13_CHECKS)
OPTION_STEPS = 1
# phase 10(c): worker processes (the chip machine's host has 8 cores)
OPTION_WORKERS = 8
# phase 10(b): controller steps of tp_spe10_inner at full size
INNER_STEPS = 2
# phase 10(a): the W-cycle from these fuse_below entries of both flagship
# hierarchies (the 145.2k- and 36.3k-cell pressure levels)
W_FUSE_ENTRIES = (150_000, 40_000)


def option_config(pc, pc_kw: dict, gmg_kw: dict):
    """``pc`` with the option's CPRConfig and GMG overrides (both
    hierarchies)."""
    pc = dataclasses.replace(pc, **pc_kw)
    gmg_t = None if pc.gmg_t is None else dataclasses.replace(pc.gmg_t, **gmg_kw)
    return dataclasses.replace(pc, gmg=dataclasses.replace(pc.gmg, **gmg_kw), gmg_t=gmg_t)


def w_cycle_cases(dtype, dev):
    """Phase 10(a): the subtree on the flagship's hierarchies from each
    W_FUSE_ENTRIES entry, with the W-cycle beside the hierarchy's own cycle
    (K on p, V on T) and the K-cycle on T; then the W-cycle on the
    12x22x9 hierarchies.  Returns (stencil, cases) twice."""
    from thermalporous_torch.precond.gmg import _fusable

    _, _, _, pc, st, state = preset_state("tp_spe10_full", dtype, dev,
                                          dict(fuse_below=FLAGSHIP_FUSE_BELOW))
    item = st.coef.element_size()
    g = torch.Generator(device=dev).manual_seed(12)
    cases = []
    for fb in W_FUSE_ENTRIES:
        for hname, hier, hcfg, forms in (("p", state.gmg_p, pc.gmg, ("w", "k")),
                                         ("T", state.gmg_t, pc.gmg_t, ("w", "v", "k"))):
            base = dataclasses.replace(hcfg, fuse_below=fb)
            entry = next(l for l in range(1, len(hier.stencils)) if _fusable(hier, l, base, dtype))
            for form in forms:
                cases.append(deep_case(hname, hier, entry,
                                       dataclasses.replace(base, cycle_type=form), item, g))
    if dtype == torch.float32:
        line_smoother_times(st, state, dev)
    # W from 32 cells: the entry levels below fuse_below=300 run it
    small_st, small = small_deep_cases(dtype, dev, dict(cycle_type="w", kcycle_min_cells=32))
    return (st, cases), (small_st, small)


#: phase 10(a)'s line-smoother times on the flagship, for the --json record
LINE_TIMES: dict = {}


def line_smoother_times(st, state, dev) -> None:
    """The line smoothers' host loops on the card, one sweep on the
    flagship's grid (plain PyTorch: a loop over the line axis of batched
    small operations): scalar zebra and line Jacobi along z on the
    decoupled pressure block, the block-tridiagonal factor of the zebra
    stage 2 along y (its set-up) and one zebra stage-2 sweep."""
    import importlib

    # precond/__init__ exports a function named chebyshev: take the module
    tch = importlib.import_module("thermalporous_torch.precond.chebyshev")
    g = torch.Generator(device=dev).manual_seed(14)
    pst = state.gmg_p.stencils[0]
    b = torch.randn(pst.grid_shape, generator=g, dtype=pst.packed.dtype, device=dev)
    r = torch.randn((st.nc,) + st.grid_shape, generator=g, dtype=st.coef.dtype, device=dev)
    fac = tch.block_tridiag_factor(1, st.lower[1], st.diag, st.upper[1])
    calls = {
        "zebra_line_gs z, 1 sweep": lambda: tch.zebra_line_gs(pst, b, axis=2, sweeps=1),
        "line_jacobi z, 1 sweep": lambda: tch.line_jacobi(pst, b, axis=2, sweeps=1),
        "block_tridiag_factor y (zebra stage-2 set-up)":
            lambda: tch.block_tridiag_factor(1, st.lower[1], st.diag, st.upper[1]),
        "block_zebra_line_gs y, 1 sweep":
            lambda: tch.block_zebra_line_gs(st, r, axis=1, sweeps=1, factor=fac),
    }
    for label, fn in calls.items():
        LINE_TIMES[label] = time_ms(fn, reps=3)
        print(f"  f32 {label} {'x'.join(map(str, st.grid_shape))}: "
              f"{LINE_TIMES[label]:.3f} ms (host loop, plain PyTorch on the card)", flush=True)


def inner_cases(dtype, dev):
    """Phase 10(b)'s kernels at the shapes tp_spe10_inner gives them: the
    inner FGMRES operator (the decoupled (p, T) stencil, two unknowns), the
    stage 2 over all three columns, and the subtree (K-cycle) of both
    hierarchies (the T hierarchy takes the pressure configuration,
    gmg_t=None).  Returns the Jacobian, the (p, T) stencil, the cases on the
    Jacobian and the case on the (p, T) stencil."""
    from thermalporous_torch.core.stencil import apply_blocks
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.cpr import _stage1
    from thermalporous_torch.precond.gmg import _fusable

    tol = TOL_F64 if dtype == torch.float64 else TOL_F32_STENCIL
    _, _, _, pc, st, state = preset_state("tp_spe10_inner", dtype, dev,
                                          dict(fuse_below=FLAGSHIP_FUSE_BELOW))
    grid, item = st.grid_shape, st.coef.element_size()
    n, dim = math.prod(grid), len(grid)
    g = torch.Generator(device=dev).manual_seed(13)
    r = torch.randn((3,) + grid, generator=g, dtype=dtype, device=dev)
    v2 = torch.randn((2,) + grid, generator=g, dtype=dtype, device=dev)
    pt = state.pt
    pt_cases = [(f"block_matvec nc=2 k=2 (p, T) {'x'.join(map(str, grid))}", "block_matvec",
                 lambda: kst.block_matvec(pt.coef, v2, 2),
                 lambda: kst.block_matvec_plain(pt.coef, v2), tol,
                 cost_block_matvec(n, dim, 2, 2, item), ("block", v2))]
    x1 = _stage1(state, apply_blocks(state.w, r), pc)
    x1 = torch.cat([x1, torch.zeros_like(r[2:])])
    cases = [stage2_case("tp_spe10_inner x1", st, state.dinv, r, x1, tol)]
    for hname, hier in (("p", state.gmg_p), ("T", state.gmg_t)):
        entry = next(l for l in range(1, len(hier.stencils)) if _fusable(hier, l, pc.gmg, dtype))
        cases.append(deep_case(f"inner {hname}", hier, entry, pc.gmg, item, g))
    return st, pt, cases, pt_cases


def inner_apply_times(dev) -> dict:
    """Phase 10(b): the CPTR apply of tp_spe10_inner (two inner FGMRES
    iterations at most, the stage 2 at k = 3) against tp_spe10_full's on
    their own Jacobians at the same perturbed state, f32, in turns (full,
    inner, inner, full), with the subtree launches of one apply."""
    from thermalporous_torch.kernels import deep_cycle as kdeep
    from thermalporous_torch.precond.cpr import cpr_apply

    runs = {}
    for name in ("tp_spe10_full", "tp_spe10_inner"):
        _, _, _, pc, st, state = preset_state(name, torch.float32, dev,
                                              dict(fuse_below=FLAGSHIP_FUSE_BELOW))
        g = torch.Generator(device=dev).manual_seed(15)
        r = torch.randn((3,) + st.grid_shape, generator=g, dtype=torch.float32, device=dev)
        runs[name] = (lambda state=state, r=r, pc=pc: cpr_apply(state, r, pc))
    times: dict = {}
    for name in ("tp_spe10_full", "tp_spe10_inner", "tp_spe10_inner", "tp_spe10_full"):
        kdeep.deep_correction.launches = 0
        runs[name]()
        per_apply = kdeep.deep_correction.launches
        times.setdefault(name, []).append(time_ms(runs[name], reps=10))
        print(f"  CPTR apply {name}: {times[name][-1]:.3f} ms ({per_apply} deep_correction "
              f"launches an apply)", flush=True)
    return times


@contextlib.contextmanager
def count_by_columns(by: dict):
    """Count block matvecs by (nc, k) and stage 2s by k in ``by`` while the
    block runs (forwarders to the wrappers; the wrappers' own counters are
    read after the block)."""
    from thermalporous_torch.kernels import stencil as kst

    real = kst.block_matvec, kst.fused_stage2_rbgs

    def bm(coef, v, k):
        key = f"block_matvec nc={coef.shape[1]} k={k}"
        by[key] = by.get(key, 0) + 1
        return real[0](coef, v, k)

    def s2(coef, dinv, r, x1, *args, **kw):
        key = f"fused_stage2_rbgs k={x1.shape[0]}"
        by[key] = by.get(key, 0) + 1
        return real[1](coef, dinv, r, x1, *args, **kw)

    # a wrapper counts its launches on the name it is called by: the
    # forwarder's, added to the wrapper's own counter afterwards
    bm.launches = s2.launches = 0
    kst.block_matvec, kst.fused_stage2_rbgs = bm, s2
    try:
        yield by
    finally:
        kst.block_matvec, kst.fused_stage2_rbgs = real
        real[0].launches += bm.launches
        real[1].launches += s2.launches


def _option_task(task):
    """One SOLVER_OPTIONS entry (by index) on one device, in a worker
    process of :func:`option_runs`: the (dt, Newton, FGMRES, retries)
    records, the launches on the card, the stage 2 of the configuration
    that ran, the seconds."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from thermalporous_torch.presets import get_case

    index, device = task
    torch.set_num_threads(1)
    t = time.perf_counter()
    label, pc_kw, gmg_kw, newton_kw, precond, other = SOLVER_OPTIONS[index]
    name, kw = other or ("tp_spe10_full", dict(shape=FLAGSHIP_SMALL))
    case = get_case(name, device=device, dtype=torch.float64, **kw)
    pc = case.pc_cfg if name != "tp_spe10_full" else with_fuse(case.pc_cfg, **SMALL_GMG)
    pc = option_config(pc, pc_kw, gmg_kw)
    sim = case.simulator(newton_cfg=dataclasses.replace(case.newton_cfg, **newton_kw),
                         pc_cfg=pc, precond=precond)
    reset_launch_counts()
    res = sim.run(case.t_end, max_steps=OPTION_STEPS)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"records": [(r.dt, r.newton_iters, r.ksp_iters, r.retries) for r in res.records],
            "launches": launch_counts() if device == "cuda" else None,
            "variants": variant_counts() if device == "cuda" else None,
            "stage2": sim.pc_cfg.stage2, "s": time.perf_counter() - t}


def option_runs(refs: dict, workers: int = OPTION_WORKERS, labels: tuple | None = None) -> dict:
    """Phase 10(c): every SOLVER_OPTIONS entry through the Simulator on the
    GPU and on the CPU, OPTION_STEPS controller steps, f64: the card's runs
    as tasks of a pool of ``workers`` processes (each run is bound by the
    host's launches, so they overlap on the host's cores; every worker
    loads the library phase 1 built), the CPU's from the references' pool
    ``refs``.  The counts must agree; prints the stage-2 route each took on
    the card, by the wrappers' counters."""
    import multiprocessing

    chosen = [i for i, o in enumerate(SOLVER_OPTIONS) if labels is None or o[0] in labels]
    tasks = [(i, "cuda") for i in chosen]
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        done = dict(zip(tasks, pool.map(_option_task, tasks, chunksize=1)))
        pool.close()
        pool.join()
    done.update({(i, "cpu"): refs[("option", i)].get(timeout=1200) for i in chosen})
    out = {}
    for i in chosen:
        label, pc_kw, gmg_kw, newton_kw, precond, other = SOLVER_OPTIONS[i]
        gpu, cpu = done[(i, "cuda")], done[(i, "cpu")]
        lc = gpu["launches"]
        if precond in ("cpr", "cptr") and gpu["stage2"] == "bgmg":
            route = "kernels (bgmg: each level's zero-start sweep and half-sweeps)"
        elif precond == "rbgs" or (precond in ("cpr", "cptr") and gpu["stage2"] == "rbgs"):
            # with stage2_axes the sweeps are the plain sparsified form; the
            # premasked first sweep with axes is plain, the sweeps after it
            # half-sweep launches
            route = ("kernel" if lc["fused_stage2_rbgs"] > 0 else
                     "plain first sweep, kernel half-sweeps" if lc["block_rbgs_half_sweep"] > 0
                     else "plain")
        else:
            route = ("plain torch (" + (precond if precond not in ("cpr", "cptr")
                                         else f"stage2={gpu['stage2']}") + ")")
        print(f"  option {label}: cpu {cpu['records']} {'==' if cpu['records'] == gpu['records'] else '!='} "
              f"cuda {gpu['records']}; stage-2 route {route} (fused_stage2_rbgs "
              f"{lc['fused_stage2_rbgs']}, half-sweep {lc['block_rbgs_half_sweep']}, "
              f"deep_correction {lc['deep_correction']}, block_matvec {lc['block_matvec']}, "
              f"matvec {lc['matvec']})"
              + (f"; bf16/batched {gpu['variants']}" if gpu["variants"] else "")
              + f"; {gpu['s']:.1f} s on the card's process, {cpu['s']:.1f} s on the CPU's",
              flush=True)
        if cpu["records"] != gpu["records"]:
            raise SystemExit(f"option {label}: cpu {cpu['records']} != cuda {gpu['records']}")
        out[label] = {"cpu": cpu["records"], "cuda": gpu["records"], "launches": lc,
                      "variants": gpu["variants"], "route": route, "cuda_s": gpu["s"],
                      "cpu_s": cpu["s"]}
    return out


# phase 11: the run_case path
CLI_STEPS = 2          # controller steps of the flagship CLI run
BLOCK_STEPS = 2        # phase 11(b): steps per block
BLOCK_RUN_STEPS = 4    # phase 11(b): controller steps
SCHED_T_END = 6 * 3600.0   # phase 11(c): the producer is shut in at half of it
SCHED_NEWTON = dict(rtol=1e-10, max_iters=20)   # tests/test_schedule.py's tolerance
CLOSURE_TOL = 1e-9     # the audit's relative closure at that tolerance (f64)


def cli_flagship(out_dir) -> dict:
    """Phase 11(a): ``run_case.main`` in this process on tp_spe10_full
    (60x220x85, f32) for CLI_STEPS steps with a checkpoint and a VTK frame
    every step, JSONL metrics and the balance audit; the writes timed (the
    checkpoint's save, the frame's device-to-host copy and write, the
    audit's call), the native VTI writer required; every flagship kernel launched; then a
    resume from the checkpoint of the step before the last, whose last
    checkpoint must equal the uninterrupted run's bit for bit."""
    from unittest import mock

    import thermalporous_torch.io as tio
    from thermalporous_torch import run_case
    from thermalporous_torch.io import checkpoint as tckpt
    from thermalporous_torch.io import native
    from thermalporous_torch.io import vti as tvti
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts

    shutil.rmtree(out_dir, ignore_errors=True)
    ck, ck2 = out_dir / "ck", out_dir / "ck2"
    metrics, metrics2 = out_dir / "m.jsonl", out_dir / "m2.jsonl"
    times = {"checkpoint_ms": [], "vtk_copy_ms": [], "vtk_write_ms": [], "audit_ms": []}
    native_writes = [0]
    auditors = []

    def timed(fn, key):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            times[key].append((time.perf_counter() - t0) * 1e3)
            return res
        return call

    def raw(*args):
        wrote = real_raw(*args)
        native_writes[0] += int(wrote)
        return wrote

    class Auditor(tio.BalanceAuditor):
        def __init__(self, *args):
            super().__init__(*args)
            auditors.append(self)

        def __call__(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().__call__(*args)
            times["audit_ms"].append((time.perf_counter() - t0) * 1e3)

    real_raw = native.write_vti_raw
    flags = ["--case", "tp_spe10_full", "--f32", "--max-steps", str(CLI_STEPS),
             "--fuse-below", str(FLAGSHIP_FUSE_BELOW), "--quiet"]
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            tckpt, "save_checkpoint", timed(tckpt.save_checkpoint, "checkpoint_ms")))
        stack.enter_context(mock.patch.object(
            tio, "state_fields", timed(tio.state_fields, "vtk_copy_ms")))
        stack.enter_context(mock.patch.object(
            tvti, "write_vti", timed(tvti.write_vti, "vtk_write_ms")))
        stack.enter_context(mock.patch.object(native, "write_vti_raw", raw))
        stack.enter_context(mock.patch.object(tio, "BalanceAuditor", Auditor))
        torch.cuda.synchronize()
        reset_launch_counts()
        run_case.main(flags + ["--ckpt-dir", str(ck), "--ckpt-every", "1",
                               "--metrics", str(metrics), "--vtk", str(out_dir / "vtk"),
                               "--vtk-every", "1", "--balance"])
        torch.cuda.synchronize()
        launches = launch_counts()
    recs = [json.loads(line) for line in open(metrics)]
    for r in recs:
        print(f"  step {r['step']} dt {r['dt']:.1f} s: newton {r['newton_iters']} fgmres "
              f"{r['ksp_iters']} retries {r['retries']} wall {r['wall_s']:.3f} s")
    if len(recs) != CLI_STEPS:
        raise SystemExit(f"cli: {len(recs)} steps, want {CLI_STEPS}")
    later = recs[1:]
    cu_s = (math.prod(SPE10_FULL) * sum(r["newton_iters"] for r in later)
            / sum(r["wall_s"] for r in later))
    print(f"  launches {launches}")
    missing = [k for k in FLAGSHIP_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"cli: launched no {missing}")
    n_frames = CLI_STEPS + 1
    frame_bytes = (out_dir / "vtk" / "tp_spe10_full_00001.vti").stat().st_size
    ckpt_bytes = (ck / "ckpt_0000001.npz").stat().st_size
    print(f"  native VTI writer available {native.available()}, wrote "
          f"{native_writes[0]} of {n_frames} frames; frame {frame_bytes} B, checkpoint "
          f"{ckpt_bytes} B")
    if not native.available() or native_writes[0] != n_frames:
        raise SystemExit("cli: the native VTI writer did not write every frame")
    for key, vals in times.items():
        print(f"  {key}: " + ", ".join(f"{v:.3f}" for v in vals))
    if (len(times["checkpoint_ms"]) != CLI_STEPS or len(times["audit_ms"]) != CLI_STEPS
            or len(times["vtk_write_ms"]) != n_frames):
        raise SystemExit(f"cli: writes {times}")
    rep = auditors[0].report()
    rel = {lab: row["rel_error"] for lab, row in rep["rows"].items()}
    print(f"  balance: complete {rep['complete']}, {rep['steps']} steps, rel_error {rel}")
    if not (rep["complete"] and rep["steps"] == CLI_STEPS
            and all(math.isfinite(v) for v in rel.values())):
        raise SystemExit(f"cli: balance report {rep}")
    final = np.load(ck / f"ckpt_{CLI_STEPS:07d}.npz")
    check_physical(torch.as_tensor(final["u"]), SPE10_FULL, "cli")

    print(f"  resumed from the step-{CLI_STEPS - 1} checkpoint:", flush=True)
    run_case.main(flags + ["--resume", str(ck / f"ckpt_{CLI_STEPS - 1:07d}.npz"),
                           "--ckpt-dir", str(ck2),
                           "--ckpt-every", "1", "--metrics", str(metrics2)])
    again = np.load(ck2 / f"ckpt_{CLI_STEPS:07d}.npz")
    same = {k: bool(np.array_equal(final[k], again[k])) for k in ("u", "t", "dt", "step")}
    rec2 = [json.loads(line) for line in open(metrics2)]
    key = lambda r: (r["step"], r["t"], r["dt"], r["newton_iters"], r["ksp_iters"])
    print(f"  resumed step: {[key(r) for r in rec2]} | uninterrupted {key(recs[-1])}; "
          f"bitwise {same}")
    if not all(same.values()) or [key(r) for r in rec2] != [key(recs[-1])]:
        raise SystemExit("cli: the resumed run is not the uninterrupted run's bits")

    shutil.rmtree(out_dir, ignore_errors=True)
    return {"steps": recs, "cell_updates_per_s": cu_s, "launches": launches,
            "write_ms": times, "frame_bytes": frame_bytes, "checkpoint_bytes": ckpt_bytes,
            "balance": rep, "resumed_bitwise": same}


def cli_entry_start():
    """Phase 11(a): ``python -m thermalporous_torch.run_case`` on
    tp_thermal_2d (f32, on the card), started in a subprocess that runs
    beside (b) and (c)."""
    return subprocess.Popen([sys.executable, "-m", "thermalporous_torch.run_case", "--case",
                             "tp_thermal_2d", "--f32", "--t-end-days", "0.05", "--quiet"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_entry_finish(proc) -> None:
    """Phase 11(a): the module entry point must exit 0 with its done line."""
    out, err = proc.communicate(timeout=600)
    done = [line for line in out.splitlines() if line.startswith("# done:")]
    print(f"  (a) python -m thermalporous_torch.run_case: rc {proc.returncode}; {done}")
    if proc.returncode != 0 or not done:
        raise SystemExit(f"cli module entry point failed:\n{out}\n{err}")


def blocked_run(device: str, block_steps: int):
    """One run of phase 11(b): the flagship configuration at FLAGSHIP_SMALL,
    f64, in blocks of ``block_steps`` for BLOCK_RUN_STEPS steps with the
    balance audit; returns ((dt, Newton, FGMRES, retries, state-consistent)
    per record, the audit's rel_error per row, the auditor, the final state,
    the launches)."""
    from thermalporous_torch.io import BalanceAuditor
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.presets import get_case

    case = get_case("tp_spe10_full", device=device, dtype=torch.float64, shape=FLAGSHIP_SMALL)
    sim = case.simulator(pc_cfg=with_fuse(case.pc_cfg, **SMALL_GMG),
                         time_cfg=dataclasses.replace(case.time_cfg, block_steps=block_steps))
    aud = BalanceAuditor(case.model, case.data, case.model.initial_state(case.data))
    reset_launch_counts()
    res = sim.run(case.t_end, max_steps=BLOCK_RUN_STEPS, callback=aud)
    recs = [(r.dt, r.newton_iters, r.ksp_iters, r.retries, r.state_consistent)
            for r in res.records]
    rel = {k: v["rel_error"] for k, v in aud.report()["rows"].items()}
    return recs, rel, aud, res.u, launch_counts()


def schedule_run(device: str) -> dict:
    """One run of phase 11(c): tp_thermal_2d at its preset size (60x60),
    f64, at SCHED_NEWTON, under two control segments (the producer shut in
    at SCHED_T_END / 2) with the balance audit."""
    from thermalporous_torch.io import BalanceAuditor
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.physics import WellFields
    from thermalporous_torch.presets import get_case

    t_switch = SCHED_T_END / 2
    case = get_case("tp_thermal_2d", device=device, dtype=torch.float64)
    sim = case.simulator(newton_cfg=dataclasses.replace(case.newton_cfg, **SCHED_NEWTON))
    wells = case.data.wells
    prod = torch.as_tensor(case.well_masks["PROD"], device=wells.wi.device)
    shut = WellFields(**{f.name: torch.where(prod, 0.0, getattr(wells, f.name))
                         for f in dataclasses.fields(WellFields)})
    u0 = case.model.initial_state(case.data)
    aud = BalanceAuditor(case.model, case.data, u0)
    reset_launch_counts()
    res = sim.run_schedule([(0.0, wells), (t_switch, shut)], t_end=SCHED_T_END, u0=u0,
                           callback=aud)
    rep = aud.report()
    return {"records": [(r.dt, r.newton_iters, r.ksp_iters, r.retries) for r in res.records],
            "on_boundary": any(r.t == t_switch for r in res.records), "t": res.t,
            "rel_error": {lab: row["rel_error"] for lab, row in rep["rows"].items()},
            "complete": rep["complete"], "launches": launch_counts()}


def _phase11_task(kind: str, threads: int) -> dict:
    """One run of phase 11(b) or (c) in a worker process of
    :func:`phase11_parity`: "blocked cpu", "host cuda" (the host loop, with
    the caller's ``threads``, so that any host-side reduction sums as the
    caller's does) or "schedule cpu"; returns plain data (the caller checks
    it)."""
    torch.set_num_threads(threads if kind == "host cuda" else 1)
    t = time.perf_counter()
    if kind == "schedule cpu":
        out = schedule_run("cpu")
    else:
        device = kind.split()[1]
        recs, rel, aud, u, _ = blocked_run(device, BLOCK_STEPS if kind == "blocked cpu" else 1)
        out = {"records": recs, "rel_error": rel, "steps": aud.steps, "cum": aud.cum,
               "m_last": aud.m_last, "u": u.cpu().numpy()}
    out["s"] = time.perf_counter() - t
    return out


def phase11_parity(refs: dict) -> tuple[dict, dict]:
    """Phase 11(b) and (c): the card's blocked run and schedule here, the
    card's host-loop run in a worker process at the same time, the CPU's
    runs from the references' pool ``refs``.  (b): (dt, Newton, FGMRES, retries, state-consistent) per
    record equal on the GPU and the CPU, and the blocked run's records, final
    state and audit equal to the host loop's on the card (the audit's
    closure at the flagship's Newton tolerance printed).  (c): (dt, Newton,
    FGMRES, retries) equal, a step on the boundary and the audit closed below
    CLOSURE_TOL on each device."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        pending = {"host cuda": pool.apply_async(_phase11_task,
                                                 ("host cuda", torch.get_num_threads()))}
        pending.update({k: refs[k] for k in ("blocked cpu", "schedule cpu")})
        t = time.perf_counter()
        recs, rel, aud, u, launches = blocked_run("cuda", BLOCK_STEPS)
        blocked_s = time.perf_counter() - t
        t = time.perf_counter()
        sched = {"cuda": schedule_run("cuda")}
        sched["cuda"]["s"] = time.perf_counter() - t
        done = {k: p.get(timeout=900) for k, p in pending.items()}
        pool.close()
        pool.join()
    cpu, host = done["blocked cpu"], done["host cuda"]
    blocked = {"cpu": cpu["records"], "cuda": recs, "host cuda": host["records"],
               "rel_error cpu": cpu["rel_error"], "rel_error cuda": rel,
               "rel_error host cuda": host["rel_error"], "launches": launches,
               "cpu_s": cpu["s"], "cuda_s": blocked_s, "host_cuda_s": host["s"]}
    for label in ("cpu", "cuda", "host cuda"):
        print(f"  (b) {label}: audit rel_error {blocked['rel_error ' + label]}; "
              f"{blocked[label.replace(' ', '_') + '_s']:.1f} s")
    print(f"  (b) launches (blocked, cuda) {launches}")
    consistent = [r[4] for r in recs]
    if (cpu["records"] != recs or len(recs) != BLOCK_RUN_STEPS
            or consistent != [(i + 1) % BLOCK_STEPS == 0 for i in range(BLOCK_RUN_STEPS)]):
        raise SystemExit(f"blocked: cpu {cpu['records']} != cuda {recs}")
    if ([r[:4] for r in host["records"]] != [r[:4] for r in recs]
            or not np.array_equal(u.cpu().numpy(), host["u"])):
        raise SystemExit(f"blocked: blocked {recs} != host loop {host['records']} "
                         "(or their states)")
    if not (aud.steps == host["steps"] and aud.report()["complete"]
            and np.allclose(aud.cum, host["cum"], rtol=1e-12, atol=0)
            and np.array_equal(aud.m_last, host["m_last"])):
        raise SystemExit(f"blocked: audit {aud.report()} != the host loop's")
    sched["cpu"] = done["schedule cpu"]
    for d in ("cpu", "cuda"):
        r = sched[d]
        print(f"  (c) {d}: {len(r['records'])} steps to t={r['t']:.1f} s, a step on "
              f"{SCHED_T_END / 2:.0f} s {r['on_boundary']}, rel_error {r['rel_error']}; "
              f"{r['s']:.1f} s")
        if not (r["on_boundary"] and r["complete"] and r["t"] == SCHED_T_END
                and all(v < CLOSURE_TOL for v in r["rel_error"].values())):
            raise SystemExit(f"schedule ({d}): {r}")
    print(f"  (c) launches (cuda) {sched['cuda']['launches']}")
    if sched["cpu"]["records"] != sched["cuda"]["records"]:
        raise SystemExit(f"schedule: cpu {sched['cpu']['records']} != cuda "
                         f"{sched['cuda']['records']}")
    return blocked, sched


# ------------------------------------------ phase 12: pc_dtype and batch_pt

#: the CPTR apply's coefficient storage modes, timed in turns in phase 12(b)
PC_DTYPE_MODES = ("f32", "bf16", "bf16_gmg", "bf16_s2")
BF16_STEPS = 1          # phase 12(b): controller steps of the bf16 flagship
BATCH_STEPS = 1         # phase 12(d): controller steps with batch_pt
# phase 12(d): the flagship configuration with the batched traversal and the
# sequential form it is held to (the T hierarchy takes the pressure
# configuration and schedule: the two must be congruent)
SEQ_PT = dict(triangular=False, gmg_t=None)
BATCH_PT = dict(SEQ_PT, batch_pt=True)


def _rows_since(start: int) -> dict:
    """The rows run_cases appended to ROWS from index ``start``, by case."""
    return {r["case"]: r for r in ROWS[start:]}


def bf16_kernel_cases(dtype, dev, with_f32: bool = True):
    """Phase 12(a): each kernel that reads preconditioner coefficients, at
    the flagship's shapes (60x220x85, the CPTR state of its Jacobian with
    two inner iterations, so that the (p, T) stencil exists), with every
    coefficient group cast to bf16 (cast_coefficients) and, for f32
    vectors, the same cases on the f32 coefficients beside: B1 (nc = 3 at
    k = 2 and 3, the (p, T) stencil at nc = k = 2), B2 (the T<-p
    coupling), B3 (the finest pressure level, degree 4 from x0 and from
    zero, both second outputs), B5 (k = 2, 3), the red half-sweep and B6
    (the pressure K-cycle and the temperature V-cycle from their fused
    entries).  Without ``with_f32`` (phase 2 has run the f32 form of every
    case on the same shapes) the f32 coefficients are left out.  Returns
    (the Jacobian, {"bf16": cases[, "f32": cases]})."""
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.cpr import cast_coefficients, cpr_setup
    from thermalporous_torch.precond.gmg import _fusable

    tol = TOL_F64 if dtype == torch.float64 else TOL_F32_STENCIL
    _, _, _, pc, st, _ = preset_state("tp_spe10_full", dtype, dev,
                                      dict(fuse_below=FLAGSHIP_FUSE_BELOW))
    full = cpr_setup(st, dataclasses.replace(pc, inner_iters=2))
    sets = {"bf16": cast_coefficients(full, "bf16")}
    if dtype == torch.float32 and with_f32:
        sets["f32"] = full
    grid = st.grid_shape
    n, dim, item = math.prod(grid), len(grid), st.coef.element_size()
    g = torch.Generator(device=dev).manual_seed(16)
    rand = lambda shape: torch.randn(shape, generator=g, dtype=dtype, device=dev)
    v3, r, x0, b = rand((3,) + grid), rand((3,) + grid), rand((3,) + grid), rand(grid)
    gs = "x".join(map(str, grid))
    out = {}
    for cname, S in sets.items():
        cst, citem, note = S.stencil, S.stencil.coef.element_size(), f"{cname} coefficients"
        cases = []
        for label, coef, nc, k in (("nc=3 k=2", cst.coef, 3, 2), ("nc=k=3", cst.coef, 3, 3),
                                   ("nc=k=2 (p, T)", S.pt.coef, 2, 2)):
            vk = v3[:k].contiguous()
            cases.append((f"block_matvec {label} {note} {gs}", "block_matvec",
                          lambda c=coef, vk=vk, k=k: kst.block_matvec(c, vk, k),
                          lambda c=coef, vk=vk: kst.block_matvec_plain(c, vk), tol,
                          cost_block_matvec(n, dim, nc, k, item, citem), None))
        atp = S.a_tp.packed
        cases.append((f"matvec T<-p {note} {gs}", "matvec",
                      lambda p=atp: kst.matvec(p, b), lambda p=atp: kst.matvec_plain(p, b),
                      tol, cost_matvec(n, dim, item, citem), None))
        fine, lam = S.gmg_p.stencils[0].packed, S.gmg_p.lam_max[0]
        for xx in (x0[0], None):
            cases.append(smooth_case(f"fine {note}", fine, lam, b, xx, 4, tol, item))
        for kind, xx in (("residual", None), ("product", x0[0])):
            cases.append(second_case(f"fine {note}", fine, lam, b, xx, 4, kind, tol, item))
        for k in (2, 3):
            cases.append(stage2_case(note, cst, S.dinv, r, x0[:k].contiguous(), tol))
        cases += half_cases(note, cst, S.dinv, r, x0, tol, colours=((0, "red"),),
                            sweeps_cases=False)
        for hname, hier, hcfg in (("p", S.gmg_p, pc.gmg), ("T", S.gmg_t, pc.gmg_t)):
            entry = next(l for l in range(1, len(hier.stencils))
                         if _fusable(hier, l, hcfg, dtype))
            cases.append(deep_case(hname, hier, entry, hcfg, item, g))
        out[cname] = cases
    return st, out


def pc_dtype_apply_times(dev) -> dict:
    """Phase 12(b): one CPTR apply of the flagship (f32, the subtree fused
    from 145.2k cells) in each storage mode, on the same Jacobian and
    residual, in turns (f32, bf16, bf16_gmg, bf16_s2 and back): ms per call
    and on the card."""
    from thermalporous_torch.precond.cpr import cpr_apply, cpr_setup

    _, _, _, pc, st, _ = preset_state("tp_spe10_full", torch.float32, dev,
                                      dict(fuse_below=FLAGSHIP_FUSE_BELOW))
    g = torch.Generator(device=dev).manual_seed(17)
    r = torch.randn((3,) + st.grid_shape, generator=g, dtype=torch.float32, device=dev)
    cfgs = {m: dataclasses.replace(pc, pc_dtype=m) for m in PC_DTYPE_MODES}
    states = {m: cpr_setup(st, cfgs[m]) for m in PC_DTYPE_MODES}
    times: dict = {}
    for m in PC_DTYPE_MODES + PC_DTYPE_MODES[::-1]:
        fn = lambda m=m: cpr_apply(states[m], r, cfgs[m])
        t = times.setdefault(m, {"ms": [], "device_ms": []})
        t["ms"].append(time_ms(fn, reps=10))
        t["device_ms"].append(time_device_ms(fn, reps=10))
        print(f"  CPTR apply pc_dtype={m}: {t['ms'][-1]:.3f} ms ({t['device_ms'][-1]:.3f} on "
              f"the card)", flush=True)
    return times


def bench_bf16_steps(dev) -> dict:
    """Phase 12(c): bench.py's step (1024x1024, f32, block-Jacobi stage 2:
    the stage-2 residual is a bf16 block matvec over x1's columns) with
    pc_dtype="bf16": the 600 s step and one doubling."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from thermalporous_torch.solve import make_step_fn

    cfg, pc = bench_configs()
    pc = dataclasses.replace(pc, pc_dtype="bf16")
    model, data = bench_case(N_MAIN, torch.float32, dev)
    step = make_step_fn(model, "cptr", cfg, pc, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    recs, u = run_steps(step, model, data, 600.0, 1, torch.cuda.synchronize)
    launches, variants = launch_counts(), variant_counts()
    for rr in recs:
        print(f"  bench bf16 step {rr['step']} dt {rr['dt']:.0f} s: newton {rr['newton']} "
              f"fgmres {rr['fgmres']} retries {rr['retries']} wall {rr['wall_s']:.3f} s",
              flush=True)
    check_physical(u, (N_MAIN, N_MAIN), "bench step, pc_dtype=bf16")
    print(f"  launches {launches}; bf16 {variants}")
    if variants.get("block_matvec bf16", 0) <= 0:
        raise SystemExit("bench step, pc_dtype=bf16: no bf16 block matvec launched")
    return {"steps": recs, "launches": launches, "variants": variants}


def batched_cases(st, bat, pc_bat, dev):
    """Phase 12(d): the batched smooth (the finest level, degree 4 from
    zero) and the batched subtree (from the fused entry) of the stacked
    (p, T) hierarchy against their plain versions, each beside its two
    sequential launches, which must give its bits."""
    from thermalporous_torch.kernels import deep_cycle as kdeep
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.gmg import _fusable

    h, cfg = bat.gmg_p, pc_bat.gmg
    dtype, item = st.coef.dtype, st.coef.element_size()
    g = torch.Generator(device=dev).manual_seed(18)
    grid = h.shape(0)
    n, dim = math.prod(grid), len(grid)
    b2 = torch.randn((2,) + grid, generator=g, dtype=dtype, device=dev)
    packed, lam = h.stencils[0].packed, h.lam_max[0]
    args = (cfg.degree, cfg.lam_min_frac)
    smooth = lambda: kst.chebyshev_smooth(packed, b2, None, lam, *args)
    smooth_seq = lambda: [kst.chebyshev_smooth(packed[m], b2[m], None, lam[m], *args)
                          for m in range(2)]
    entry = next(l for l in range(1, len(h.stencils)) if _fusable(h, l, cfg, dtype))
    shapes = [h.shape(l) for l in range(entry, len(h.stencils))]
    sub = [s.packed for s in h.stencils[entry:]]
    rc = torch.randn((2,) + shapes[0], generator=g, dtype=dtype, device=dev)
    kw = dict(degree=cfg.degree, lam_min_frac=cfg.lam_min_frac, cycle_type=cfg.cycle_type,
              kcycle_min_cells=cfg.kcycle_min_cells)
    deep = lambda: kdeep.deep_correction(sub, h.lam_max[entry:], h.coarse_inv, rc, **kw)
    deep_seq = lambda: [kdeep.deep_correction([p[m] for p in sub],
                                              [x[m] for x in h.lam_max[entry:]],
                                              h.coarse_inv[m], rc[m], **kw) for m in range(2)]

    def beside(kern, seq, label):
        def check():
            if not torch.equal(kern(), torch.stack(seq())):
                raise SystemExit(f"{label}: the batched launch and the two sequential "
                                 "launches differ")
            t = {"sequential_ms": time_ms(seq, reps=10),
                 "sequential_device_ms": time_device_ms(seq, reps=10)}
            return (f"  the two sequential launches {t['sequential_ms']:.4f} ms "
                    f"({t['sequential_device_ms']:.4f} on the card), bitwise equal to the "
                    f"batched launch", t)
        return check

    sizes = " -> ".join(str(math.prod(s)) for s in shapes)
    sb, so = cost_chebyshev(n, dim, cfg.degree, False, item)
    label_s = f"chebyshev batch_pt (p, T) fine deg={cfg.degree} zero {'x'.join(map(str, grid))}"
    label_d = f"deep_correction batch_pt (p, T) {cfg.cycle_type}-cycle {sizes} cells"
    return [(label_s, "chebyshev_smooth", smooth,
             lambda: kst.chebyshev_smooth_plain(packed, b2, None, lam, *args),
             TOL_F64 if item == 8 else TOL_F32_STENCIL, (2 * sb, 2 * so), None,
             beside(smooth, smooth_seq, label_s)),
            (label_d, "deep_correction", deep,
             lambda: kdeep.deep_correction_plain(sub, h.lam_max[entry:], h.coarse_inv, rc, **kw),
             TOL_F64_DEEP if item == 8 else TOL_F32_DEEP,
             cost_deep(shapes, cfg.degree, cfg.cycle_type, cfg.kcycle_min_cells, item, batch=2),
             None, beside(deep, deep_seq, label_d))]


def batch_pt_apply(dev) -> tuple:
    """Phase 12(d): the flagship's CPTR apply (f32) with the batched p/T
    traversal against the sequential block-diagonal form on the same
    Jacobian: bitwise equal, half the smooth and subtree launches, timed in
    turns; then the batched kernels' cases.  Returns (the record, the
    Jacobian, the cases)."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.precond.cpr import cpr_apply, cpr_setup

    _, _, _, pc, st, _ = preset_state("tp_spe10_full", torch.float32, dev,
                                      dict(fuse_below=FLAGSHIP_FUSE_BELOW))
    pc_seq = dataclasses.replace(pc, **SEQ_PT)
    pc_bat = dataclasses.replace(pc, **BATCH_PT)
    seq, bat = cpr_setup(st, pc_seq), cpr_setup(st, pc_bat)
    g = torch.Generator(device=dev).manual_seed(19)
    r = torch.randn((3,) + st.grid_shape, generator=g, dtype=torch.float32, device=dev)
    counts, outs = {}, {}
    for name, state, cfg in (("sequential", seq, pc_seq), ("batched", bat, pc_bat)):
        reset_launch_counts()
        outs[name] = cpr_apply(state, r, cfg)
        torch.cuda.synchronize()
        counts[name] = launch_counts()
    if not torch.equal(outs["sequential"], outs["batched"]):
        d = float((outs["sequential"] - outs["batched"]).abs().max())
        raise SystemExit(f"batch_pt apply: not bitwise equal to the sequential one ({d:.3e})")
    for k in ("chebyshev_smooth", "deep_correction"):
        if 2 * counts["batched"][k] != counts["sequential"][k] or counts["batched"][k] <= 0:
            raise SystemExit(f"batch_pt apply: {counts['batched'][k]} {k} launches against "
                             f"{counts['sequential'][k]} sequential")
    times: dict = {}
    for name in ("sequential", "batched", "batched", "sequential"):
        state, cfg = (seq, pc_seq) if name == "sequential" else (bat, pc_bat)
        fn = lambda state=state, cfg=cfg: cpr_apply(state, r, cfg)
        t = times.setdefault(name, {"ms": [], "device_ms": []})
        t["ms"].append(time_ms(fn, reps=10))
        t["device_ms"].append(time_device_ms(fn, reps=10))
    print(f"  batch_pt apply bitwise equal to the sequential one; launches an apply: "
          f"smooth {counts['batched']['chebyshev_smooth']} against "
          f"{counts['sequential']['chebyshev_smooth']}, subtree "
          f"{counts['batched']['deep_correction']} against "
          f"{counts['sequential']['deep_correction']}; apply "
          + ", ".join(f"{k} {statistics.mean(v['ms']):.3f} ms ({statistics.mean(v['device_ms']):.3f}"
                      f" on the card)" for k, v in times.items()), flush=True)
    rec = {"launches_per_apply": counts, "apply": times}
    return rec, st, batched_cases(st, bat, pc_bat, dev)


# ------------------------------ phase 13: transfers, bgmg, recycling, adjoint

TRANSFERS = ("constant", "weighted", "variational")
# phases 12(b) and 13(b): the flagship's first controller step under bf16
# coefficients and the bgmg run at the 300 s its controller falls back to:
# their 600 s attempt fails (the first step per storage mode at 600 s is in
# phase 12(b); the failure at 600 s under bgmg is an earlier finding, as the
# reference's run)
RETRY_DT = 300.0
BGMG_STEPS = 1          # phase 13(b): controller steps with stage2="bgmg"
BGMG_COARSE = 256       # phase 13(b): bgmg_coarse_cells (the reference's default)
ADJ_SMALL_STEPS = 3     # phase 13(d): recorded steps at FLAGSHIP_SMALL
ADJ_FULL_STEPS = 1      # phase 13(d): recorded steps at full size
ADJ_RTOL_FULL = 1e-5
ADJ_MAXITER = 200
# phase 13(d) at FLAGSHIP_SMALL, f64: the recorded trajectory's Newton (no
# absolute floor, no bf16 basis, no forcing: the central difference needs
# states converged to the f64 floor), the adjoint's FGMRES tolerance, the
# relative perturbation of the FD probe
ADJ_NEWTON = dict(rtol=1e-12, atol=0.0, ksp_rtol=1e-10, ksp_basis="same", ksp_ew=False,
                  max_iters=30, ksp_maxiter=120)
ADJ_RTOL_SMALL = 1e-11
ADJ_FD_EPS = 1e-4
ADJ_GRAD_TOL = 1e-8
ADJ_FD_TOL = 1e-5
CLI_FD_TOL = 1e-4       # phase 13(f): the adjoint_study CLI's FD line


def adj_objectives():
    """Phase 13(d)'s objectives on a flagship-shaped state (3, nx, ny, nz):
    the mean pressure [MPa] of the block of a corner producer (terminal) and
    the Δt-weighted mean temperature around the central injector (running,
    scaled to MPa-like size)."""
    def terminal(u, d):
        nx, ny, _ = u.shape[1:]
        return 1e-6 * torch.mean(u[0, : max(nx // 4, 1), : max(ny // 4, 1)])

    def running(u, dt, d):
        nx, ny, _ = u.shape[1:]
        cx, cy = nx // 2, ny // 2
        return 1e-6 * dt * torch.mean(u[1, max(cx - 1, 0):cx + 2, max(cy - 1, 0):cy + 2])

    return terminal, running


def _level_desc(st) -> str:
    grid = "x".join(map(str, st.grid_shape))
    if hasattr(st, "packed"):
        return f"{grid} scalar 7-point"
    widths = tuple(st.coef.shape[: st.dim])
    return f"{grid} {type(st).__name__} {'x'.join(map(str, widths))}"


def wall_ms(fn, reps: int = 2) -> float:
    """Median milliseconds of ``fn()`` by the host's clock around a
    synchronized call, after one warm-up call (for calls of tenths of a
    second, whose host time is the time)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def transfer_cases(dev, flagship) -> dict:
    """Phase 13(a): the GMG set-up and one apply on the flagship's decoupled
    pressure stencil (60x220x85, f32, phase 6's configuration) under each
    transfer, then the CPTR set-up and apply with it on both hierarchies:
    set-up and apply ms, the levels with their class and widths, and the
    launches of one apply (the smooth on the finest level, no fused subtree
    under a weighted or variational transfer, the scalar matvec in the CPTR
    apply's T<-p product).  ``flagship`` is :func:`preset_state`'s tuple."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.precond.chebyshev import chebyshev
    from thermalporous_torch.precond.cpr import _decoupling_weights, cpr_apply, cpr_setup
    from thermalporous_torch.precond.gmg import gmg_apply, gmg_setup

    case, u0, u, pc, st, _ = flagship
    app = st.scale_rows(_decoupling_weights(st, pc)).scalar(0, 0)
    g = torch.Generator(device=dev).manual_seed(13)
    b = torch.randn(app.grid_shape, generator=g, dtype=torch.float32, device=dev)
    r = torch.randn((3,) + app.grid_shape, generator=g, dtype=torch.float32, device=dev)
    out = {}
    for tr in TRANSFERS:
        cfg = dataclasses.replace(pc.gmg, transfer=tr)
        setup_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = gmg_setup(app, cfg)
            torch.cuda.synchronize()
            setup_s.append(time.perf_counter() - t0)
        reset_launch_counts()
        x = gmg_apply(state, b, cfg)
        torch.cuda.synchronize()
        lc = launch_counts()
        if not bool(torch.isfinite(x).all()):
            raise SystemExit(f"transfer={tr}: the GMG apply is not finite")
        apply_ms = (time_ms(lambda: gmg_apply(state, b, cfg), reps=10) if tr == "constant"
                    else wall_ms(lambda: gmg_apply(state, b, cfg)))
        levels = [_level_desc(s) for s in state.stencils]
        lams = [float(v) for v in state.lam_max]
        # the first coarse level's matvec and smooth: kernels (B2, B3) on a
        # scalar level, plain torch on a wide one; the matvec's byte bound
        # reads each coefficient once, v once and writes y once
        lvl = state.stencils[1]
        v1 = torch.randn(lvl.grid_shape, generator=g, dtype=torch.float32, device=dev)
        mv = lambda: lvl.matvec(v1)
        sm = lambda: chebyshev(lvl, v1, None, degree=cfg.degree, lam_max=state.lam_max[1],
                               lam_min_frac=cfg.lam_min_frac)
        timer = (lambda f: time_ms(f, reps=10)) if tr == "constant" else wall_ms
        n1 = math.prod(lvl.grid_shape)
        offsets = (2 * len(lvl.grid_shape) + 1 if tr == "constant"
                   else math.prod(lvl.coef.shape[:lvl.dim]))
        level1 = {"matvec_ms": timer(mv), "smooth_ms": timer(sm),
                  "matvec_bound_ms": bound_ms((offsets + 2) * n1 * 4, 2 * offsets * n1)[0],
                  "offsets": offsets, "degree": cfg.degree}
        pcx = option_config(pc, {}, dict(transfer=tr))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cst = cpr_setup(st, pcx)
        torch.cuda.synchronize()
        cpr_setup_s = time.perf_counter() - t0
        reset_launch_counts()
        y = cpr_apply(cst, r, pcx)
        torch.cuda.synchronize()
        clc = launch_counts()
        if not bool(torch.isfinite(y).all()):
            raise SystemExit(f"transfer={tr}: the CPTR apply is not finite")
        cpr_ms = (time_ms(lambda: cpr_apply(cst, r, pcx), reps=10) if tr == "constant"
                  else wall_ms(lambda: cpr_apply(cst, r, pcx)))
        print(f"  transfer={tr}: p levels " + " -> ".join(levels), flush=True)
        print(f"    lam {['%.4g' % v for v in lams]}; GMG set-up {setup_s[0]:.3f} / "
              f"{setup_s[1]:.3f} s (first / second), apply {apply_ms:.3f} ms; launches of "
              f"one apply: chebyshev_smooth {lc['chebyshev_smooth']}, matvec {lc['matvec']}, "
              f"deep_correction {lc['deep_correction']}; CPTR set-up {cpr_setup_s:.3f} s, "
              f"apply {cpr_ms:.3f} ms (chebyshev_smooth {clc['chebyshev_smooth']}, matvec "
              f"{clc['matvec']}, deep_correction {clc['deep_correction']}, "
              f"fused_stage2_rbgs {clc['fused_stage2_rbgs']}); level 1 ({offsets} offsets): "
              f"matvec {level1['matvec_ms']:.4f} ms (bound {level1['matvec_bound_ms']:.4f}), "
              f"smooth (degree {cfg.degree}) {level1['smooth_ms']:.4f} ms", flush=True)
        if lc["chebyshev_smooth"] <= 0 or clc["matvec"] <= 0:
            raise SystemExit(f"transfer={tr}: no smooth or no T<-p matvec launched")
        if (lc["deep_correction"] == 0) != (tr != "constant"):
            raise SystemExit(f"transfer={tr}: deep_correction launched "
                             f"{lc['deep_correction']} times")
        out[tr] = {"levels": levels, "lam_max": lams, "gmg_setup_s": setup_s, "level1": level1,
                   "gmg_apply_ms": apply_ms, "gmg_launches": lc, "cpr_setup_s": cpr_setup_s,
                   "cpr_apply_ms": cpr_ms, "cpr_launches": clc}
        del state, cst, x, y
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def count_by_level(by: dict, names=("fused_stage2_rbgs", "block_rbgs_half_sweep",
                                    "block_matvec")):
    """Count the calls of the red-black wrappers and the block matvec by the
    grid of their stencil in ``by`` while the block runs (forwarders, as
    :func:`count_by_columns`)."""
    from thermalporous_torch.kernels import stencil as kst

    real = {n: getattr(kst, n) for n in names}
    fwds = {}
    for n in names:
        def fwd(coef, *a, _n=n, **k):
            key = f"{_n} {'x'.join(map(str, coef.shape[3:]))}"
            by[key] = by.get(key, 0) + 1
            return real[_n](coef, *a, **k)

        fwd.launches = 0
        fwds[n] = fwd
        setattr(kst, n, fwd)
    try:
        yield by
    finally:
        for n in names:
            setattr(kst, n, real[n])
            real[n].launches += fwds[n].launches


def bgmg_apply_times(dev, flagship) -> dict:
    """Phase 13(b): the bgmg hierarchy of the flagship Jacobian (60x220x85,
    f32): its levels and set-up time, one bgmg stage 2 (one V-cycle, one
    sweep a smooth) beside the rbgs stage 2 (one zero-start sweep) on the
    same residual, per call and on the card, and the whole CPTR apply with
    each.  ``flagship`` is :func:`preset_state`'s tuple."""
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.block_gmg import block_gmg_apply, block_gmg_setup
    from thermalporous_torch.precond.cpr import cpr_apply, cpr_setup

    case, u0, u, pc, st, state = flagship
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = block_gmg_setup(st, pc.gmg, max_coarse_cells=BGMG_COARSE)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    g = torch.Generator(device=dev).manual_seed(14)
    r = torch.randn((3,) + st.grid_shape, generator=g, dtype=torch.float32, device=dev)
    bg = lambda: block_gmg_apply(bst, r, pc.gmg, sweeps=1, cycles=1)
    rb = lambda: kst.fused_block_rbgs(st.coef, state.dinv, r)
    if not bool(torch.isfinite(bg()).all()):
        raise SystemExit("bgmg apply not finite")
    pcb = dataclasses.replace(pc, stage2="bgmg", bgmg_coarse_cells=BGMG_COARSE)
    sb = cpr_setup(st, pcb)
    out = {"levels": ["x".join(map(str, s.grid_shape)) for s in bst.stencils],
           "coarse_unknowns": int(bst.coarse_inv.shape[0]), "setup_s": times,
           "bgmg_ms": time_ms(bg, reps=10), "bgmg_device_ms": time_device_ms(bg, reps=10),
           "rbgs_ms": time_ms(rb, reps=10), "rbgs_device_ms": time_device_ms(rb, reps=10),
           "cptr_bgmg_ms": time_ms(lambda: cpr_apply(sb, r, pcb), reps=5),
           "cptr_rbgs_ms": time_ms(lambda: cpr_apply(state, r, pc), reps=5)}
    print(f"  bgmg levels {' -> '.join(out['levels'])} (dense coarsest: "
          f"{out['coarse_unknowns']} unknowns); set-up {times[0]:.3f} / {times[1]:.3f} s; "
          f"one bgmg stage 2 {out['bgmg_ms']:.3f} ms ({out['bgmg_device_ms']:.3f} on the card) "
          f"against the rbgs stage 2 {out['rbgs_ms']:.4f} ms ({out['rbgs_device_ms']:.4f}); "
          f"CPTR apply with bgmg {out['cptr_bgmg_ms']:.3f} ms, with rbgs "
          f"{out['cptr_rbgs_ms']:.3f} ms", flush=True)
    del bst, sb
    torch.cuda.empty_cache()
    return out


def _adjoint_small_task(task) -> dict:
    """Phase 13(d), small, on one device (a worker process for the CPU): the
    flagship configuration at FLAGSHIP_SMALL, f64, with ADJ_NEWTON; ``dts``
    None takes the first ADJ_SMALL_STEPS controller steps' Δt; the
    trajectory recorded over them, then adjoint_gradients with both
    objectives.  Returns plain values (numpy gradients), and with ``fd`` the
    central-difference probe along a relative perturbation of tgeo[0]."""
    from thermalporous_torch.interop import problem_data_to_numpy
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.models.base import ProblemData
    from thermalporous_torch.presets import get_case
    from thermalporous_torch.solve import adjoint_gradients, record_trajectory

    device, dts, fd = task
    if device == "cpu":
        torch.set_num_threads(2)
    terminal, running = adj_objectives()
    t0 = time.perf_counter()
    case = get_case("tp_spe10_full", device=device, dtype=torch.float64, shape=FLAGSHIP_SMALL)
    newton = dataclasses.replace(case.newton_cfg, **ADJ_NEWTON)
    sim = case.simulator(pc_cfg=with_fuse(case.pc_cfg, **SMALL_GMG), newton_cfg=newton)
    data = case.data
    if dts is None:
        dts = [r.dt for r in sim.run(case.t_end, max_steps=ADJ_SMALL_STEPS).records]
    states = record_trajectory(sim, case.model.initial_state(data), dts)
    reset_launch_counts()
    res = adjoint_gradients(case.model, data, states, dts, terminal=terminal, running=running,
                            pc_cfg=sim.pc_cfg, rtol=ADJ_RTOL_SMALL, maxiter=ADJ_MAXITER)
    out = {"dts": dts, "value": float(res.value), "step_iters": res.step_iters,
           "converged": res.converged, "grad": problem_data_to_numpy(res.grad_data),
           "grad_u0": res.grad_u0.cpu().numpy(), "s": time.perf_counter() - t0,
           "launches": launch_counts() if device == "cuda" else None}
    if fd:
        g = np.random.default_rng(17).standard_normal(FLAGSHIP_SMALL)
        delta = data.tgeo[0] * torch.as_tensor(g, dtype=torch.float64, device=device)

        def j_of(sign):
            f = data.fields.clone()
            f[0] = f[0] + sign * ADJ_FD_EPS * delta
            sim.data = ProblemData(f)
            try:
                sts = record_trajectory(sim, case.model.initial_state(sim.data), dts)
                return float(terminal(sts[-1], sim.data)) + sum(
                    float(running(sts[k], dts[k - 1], sim.data)) for k in range(1, len(sts)))
            finally:
                sim.data = data

        out["fd"] = (j_of(1.0) - j_of(-1.0)) / (2 * ADJ_FD_EPS)
        out["adjoint_fd"] = float(torch.sum(res.grad_data.tgeo[0] * delta))
        out["fd_rel"] = abs(out["adjoint_fd"] - out["fd"]) / abs(out["fd"])
    return out


def _grad_gap(a: dict, b: dict) -> float:
    """Largest relative difference of two gradients as
    ``problem_data_to_numpy`` gives them, leaf by leaf against the leaf's
    largest value (a leaf zero in both counts 0)."""
    worst = 0.0
    for name in a:
        pairs = zip(a[name], b[name]) if isinstance(a[name], tuple) else [(a[name], b[name])]
        for x, y in pairs:
            scale = float(np.abs(y).max())
            diff = float(np.abs(x - y).max())
            worst = max(worst, diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf))
    return worst


def adjoint_small(pending) -> dict:
    """Phase 13(d), small: the CPU's run (``pending``, from the references'
    pool) and the card's on the CPU's Δt schedule:
    the FGMRES counts per backward step must be equal, J, every gradient
    leaf and grad_u0 within ADJ_GRAD_TOL; the card's central-difference
    probe within ADJ_FD_TOL."""
    cpu = pending.get(timeout=1200)
    gpu = _adjoint_small_task(("cuda", cpu["dts"], True))
    gap = _grad_gap(gpu["grad"], cpu["grad"])
    u0_gap = float(np.abs(gpu["grad_u0"] - cpu["grad_u0"]).max() / np.abs(cpu["grad_u0"]).max())
    j_gap = abs(gpu["value"] - cpu["value"]) / abs(cpu["value"])
    print(f"  {'x'.join(map(str, FLAGSHIP_SMALL))} f64, dts {cpu['dts']}: J cpu "
          f"{cpu['value']:.12e} cuda {gpu['value']:.12e}; adjoint FGMRES per step cpu "
          f"{cpu['step_iters']} cuda {gpu['step_iters']}; gradient gaps: leaves {gap:.2e}, "
          f"grad_u0 {u0_gap:.2e}, J {j_gap:.2e}; {cpu['s']:.1f} s on the CPU, {gpu['s']:.1f} s "
          f"on the card; card launches {gpu['launches']}", flush=True)
    print(f"  FD probe on tgeo[0] (card): adjoint {gpu['adjoint_fd']:.10e} vs central "
          f"difference {gpu['fd']:.10e}, rel err {gpu['fd_rel']:.2e}", flush=True)
    if not (cpu["converged"] and gpu["converged"]) or cpu["step_iters"] != gpu["step_iters"]:
        raise SystemExit("adjoint 12x22x9: not converged, or the counts differ")
    if max(gap, u0_gap, j_gap) > ADJ_GRAD_TOL:
        raise SystemExit(f"adjoint 12x22x9: GPU against CPU {max(gap, u0_gap, j_gap):.2e}")
    if not gpu["fd_rel"] <= ADJ_FD_TOL:
        raise SystemExit(f"adjoint FD probe: rel err {gpu['fd_rel']:.2e} > {ADJ_FD_TOL}")
    for k in ("chebyshev_smooth", "matvec", "deep_correction", "fused_stage2_rbgs"):
        if gpu["launches"][k] <= 0:
            raise SystemExit(f"adjoint 12x22x9: no {k} launched")
    return {"dts": cpu["dts"], "ksp_cpu": cpu["step_iters"], "ksp_cuda": gpu["step_iters"],
            "J": [cpu["value"], gpu["value"]], "grad_gap": gap, "grad_u0_gap": u0_gap,
            "J_gap": j_gap, "cpu_s": cpu["s"], "cuda_s": gpu["s"], "fd": gpu["fd"],
            "adjoint_fd": gpu["adjoint_fd"], "fd_rel": gpu["fd_rel"],
            "launches": gpu["launches"]}


@contextlib.contextmanager
def adjoint_timers(model, prof: dict):
    """Time the parts of ``adjoint_gradients`` into ``prof`` while the block
    runs, each synchronized with the card: the assemblies, the CPTR set-ups
    on the transposes, the FGMRES solves and, inside them, every transposed
    product (forwarders in the adjoint module and on ``model``)."""
    from thermalporous_torch.solve import adjoint

    def timed(fn, key):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            prof[key] = prof.get(key, 0.0) + time.perf_counter() - t0
            prof[key + "_calls"] = prof.get(key + "_calls", 0) + 1
            return out
        return call

    real_pc, real_fgmres = adjoint.make_preconditioner, adjoint.fgmres

    def make_pc(*a, **k):
        setup, apply = real_pc(*a, **k)
        return timed(setup, "pc_setup_s"), apply

    adjoint.make_preconditioner = make_pc
    adjoint.fgmres = lambda matvec, *a, **k: timed(real_fgmres, "fgmres_s")(
        timed(matvec, "vjp_s"), *a, **k)
    model.assemble_stencil = timed(model.assemble_stencil, "assemble_s")
    try:
        yield prof
    finally:
        adjoint.make_preconditioner, adjoint.fgmres = real_pc, real_fgmres
        del model.assemble_stencil


def adjoint_full(dev, dts) -> dict:
    """Phase 13(d), full size: the flagship (60x220x85, f32) recorded over
    the accepted steps ``dts``, then adjoint_gradients at ADJ_RTOL_FULL with
    the CPTR set up on each transposed Jacobian: converged, FGMRES per
    backward step, the wall per step split into assembly, CPTR set-up,
    FGMRES and the transposed products (the VJP ms per product beside phase
    2's J(u)v kernel), peak memory, and every CPTR kernel launched."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.presets import get_case
    from thermalporous_torch.solve import adjoint_gradients, record_trajectory

    terminal, running = adj_objectives()
    case = get_case("tp_spe10_full", device=dev)
    sim = case.simulator(pc_cfg=with_fuse(case.pc_cfg, FLAGSHIP_FUSE_BELOW))
    t0 = time.perf_counter()
    states = record_trajectory(sim, case.model.initial_state(case.data), dts)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    prof: dict = {}
    t0 = time.perf_counter()
    with adjoint_timers(case.model, prof):
        res = adjoint_gradients(case.model, case.data, states, dts, terminal=terminal,
                                running=running, pc_cfg=sim.pc_cfg, rtol=ADJ_RTOL_FULL,
                                maxiter=ADJ_MAXITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lc = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    nstep = len(dts)
    vjp_ms = 1e3 * prof["vjp_s"] / prof["vjp_s_calls"]
    finite = (bool(torch.isfinite(res.grad_data.fields).all())
              and bool(torch.isfinite(res.grad_u0).all()))
    out = {"dts": dts, "record_s": record_s, "converged": res.converged,
           "ksp_per_step": res.step_iters, "wall_s": wall, "wall_per_step_s": wall / nstep,
           "assemble_per_step_s": prof["assemble_s"] / nstep,
           "pc_setup_per_step_s": prof["pc_setup_s"] / nstep,
           "fgmres_per_step_s": prof["fgmres_s"] / nstep, "vjp_ms_per_product": vjp_ms,
           "products": prof["vjp_s_calls"], "profile": prof, "peak_gib": peak, "launches": lc,
           "J": float(res.value)}
    print(f"  60x220x85 f32, dts {dts} (recorded in {record_s:.1f} s): converged "
          f"{res.converged}, FGMRES per backward step {res.step_iters}; per step {wall / nstep:.3f} "
          f"s = assembly {out['assemble_per_step_s']:.3f} + CPTR set-up on the transpose "
          f"{out['pc_setup_per_step_s']:.3f} + FGMRES {out['fgmres_per_step_s']:.3f} (the VJP "
          f"{vjp_ms:.3f} ms a product, {prof['vjp_s_calls']} products) + the rest; peak "
          f"{peak:.2f} GiB; launches {lc}", flush=True)
    if not (res.converged and finite):
        raise SystemExit("adjoint at full size: not converged or not finite")
    missing = [k for k in ("chebyshev_smooth", "matvec", "deep_correction", "fused_stage2_rbgs")
               if lc[k] <= 0]
    if missing:
        raise SystemExit(f"adjoint at full size: no {missing} on the transposed hierarchy")
    del states, res
    torch.cuda.empty_cache()
    return out


def adjoint_cli_start():
    """Phase 13(f): ``python -m thermalporous_torch.adjoint_study --ascent 1``
    (on the card, f64) started in a subprocess that runs beside the rest of
    the phase."""
    return subprocess.Popen([sys.executable, "-m", "thermalporous_torch.adjoint_study",
                             "--ascent", "1"], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def adjoint_cli_finish(proc) -> dict:
    out, err = proc.communicate(timeout=900)
    print("\n".join("  | " + line for line in out.splitlines()), flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"adjoint_study exited {proc.returncode}: {err[-2000:]}")
    fd_line = next(line for line in out.splitlines() if line.startswith("FD probe"))
    rel = float(fd_line.split("rel err ")[1].rstrip(")"))
    if not rel < CLI_FD_TOL:
        raise SystemExit(f"adjoint_study: FD rel err {rel:.2e} >= {CLI_FD_TOL}")
    return {"stdout": out, "fd_rel": rel}


# ------------------------------ phase 14: the ensemble axis and the examples

ENS_BHP = (1.0, 1.05)           # phase 14: the injector BHP factor of each member
ENS_DT = 600.0                  # phase 14(a): the members' one step
ENS_ADJ_DTS = (600.0,)          # phase 14(b): the fixed schedule at FLAGSHIP_SMALL
ENS_GRAD_TOL = 1e-12            # phase 14(b): card against CPU, per member
STUDY_STEPS = 1                 # phase 14(c): iteration_study --steps
CUSTOM_DAYS = 0.05              # phase 14(d): custom_case --days
# phase 14: torch threads of each CPU worker and subprocess, which run beside
# the card's work on the host's 8 cores
P14_THREADS = 2


def ensemble_members(case) -> list:
    """Phase 14: the well-control ensemble of a flagship case: the preset,
    then the injector's BHP scaled by each further ENS_BHP factor (through
    ProblemData.with_wells)."""
    data = case.data
    inj = torch.as_tensor(case.well_masks["INJ"], device=data.fields.device)
    w = data.wells
    return [data if f == 1.0 else data.with_wells(dataclasses.replace(
        w, pbh=torch.where(inj, w.pbh * f, w.pbh))) for f in ENS_BHP]


@contextlib.contextmanager
def per_member_launches(out: list):
    """Phase 14(a): each call of the ensemble step's ``advance`` appends its
    launches and its synchronized wall to ``out`` (the counters are read
    around the call, not reset)."""
    import thermalporous_torch.dist.ensemble as ens
    from thermalporous_torch.kernels import launch_counts

    make = ens.make_step_fn

    def counting_make(*a, **k):
        advance = make(*a, **k)

        def counted(*args):
            torch.cuda.synchronize()
            before, t = launch_counts(), time.perf_counter()
            res = advance(*args)
            torch.cuda.synchronize()
            after = launch_counts()
            out.append({"launches": {n: after[n] - before[n] for n in after},
                        "wall_s": time.perf_counter() - t})
            return res

        return counted

    ens.make_step_fn = counting_make
    try:
        yield
    finally:
        ens.make_step_fn = make


def ensemble_small(dev, after_ensemble=None) -> dict:
    """Phase 14(a): tp_spe10_full at FLAGSHIP_SMALL, f32, phase 5's
    multigrid (SMALL_GMG), the ENS_BHP well-control ensemble, level_factors
    planned from member 0 (the Simulator's baking), one ENS_DT step of every
    member through make_ensemble_step_fn, then ``after_ensemble()`` (when
    given) and each member's solo ``advance``: each member's state and
    counts bitwise its solo step, its launches those of its solo run; every
    flagship kernel launched in the ensemble's run."""
    from thermalporous_torch.dist import make_ensemble_step_fn, stack_ensemble
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.presets import get_case
    from thermalporous_torch.solve import make_step_fn

    case = get_case("tp_spe10_full", device=dev, shape=FLAGSHIP_SMALL)
    pc = case.simulator(pc_cfg=with_fuse(case.pc_cfg, **SMALL_GMG)).pc_cfg
    model, newton = case.model, case.newton_cfg
    datas = ensemble_members(case)
    data_e = stack_ensemble(datas)
    u0_e = torch.stack([model.initial_state(d) for d in datas])
    dt_e = torch.full((len(datas),), ENS_DT, dtype=u0_e.dtype)
    calls: list = []
    with per_member_launches(calls):
        step_e = make_ensemble_step_fn(model, "cptr", newton, pc, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t = time.perf_counter()
    u_e, st_e = step_e(u0_e, dt_e, data_e)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ncells = math.prod(model.grid.shape)
    cu_s = ncells * int(st_e.iters.sum()) / wall
    if after_ensemble is not None:
        after_ensemble()
    solo_step = make_step_fn(model, "cptr", newton, pc, device=dev)
    solos = []
    for d in datas:
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        u, st = solo_step(model.initial_state(d), ENS_DT, d)
        torch.cuda.synchronize()
        solos.append((u, st, launch_counts(), time.perf_counter() - t))
    out = {"members": [], "wall_s": wall, "cell_updates_per_s": cu_s, "peak_gib": peak,
           "launches": launches}
    for i, ((u, st, solo_l, solo_wall), call) in enumerate(zip(solos, calls)):
        gap = float((u_e[i].double() - u.double()).abs().max())
        counts = (int(st_e.iters[i]), int(st_e.ksp_iters[i]), float(st_e.norm[i]))
        print(f"  member {i} (injector BHP x{ENS_BHP[i]}): (newton, fgmres) "
              f"({counts[0]}, {counts[1]}), norm {counts[2]:.6e}, converged "
              f"{bool(st_e.converged[i])}; wall {call['wall_s']:.3f} s in the ensemble, "
              f"{solo_wall:.3f} s solo; largest gap to the solo state {gap:.3e}; launches "
              f"{call['launches']}", flush=True)
        if not (torch.equal(u_e[i], u) and counts == (st.iters, st.ksp_iters, st.norm)):
            raise SystemExit(f"ensemble member {i}: not bitwise its solo step (state gap "
                             f"{gap:.3e}, counts {counts} against "
                             f"{(st.iters, st.ksp_iters, st.norm)})")
        if call["launches"] != solo_l:
            raise SystemExit(f"ensemble member {i}: launches {call['launches']} != solo {solo_l}")
        check_physical(u_e[i], FLAGSHIP_SMALL, f"ensemble member {i}")
        out["members"].append({"bhp_factor": ENS_BHP[i], "newton": counts[0],
                               "fgmres": counts[1], "norm": counts[2],
                               "converged": bool(st_e.converged[i]),
                               "wall_s": call["wall_s"], "solo_wall_s": solo_wall,
                               "launches": call["launches"]})
    missing = [k for k in FLAGSHIP_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"ensemble step launched no {missing}")
    if not bool(st_e.converged.all()):
        raise SystemExit(f"ensemble step: members {st_e.converged.tolist()} converged")
    return out


def _ensemble_adjoint_task(task) -> dict:
    """Phase 14(b) on one device (a worker process for the CPU): the flagship
    configuration at FLAGSHIP_SMALL, f64, ADJ_NEWTON, the ENS_BHP members,
    level_factors planned from member 0; the ensemble trajectory over
    ENS_ADJ_DTS (per-member forward counts), the ensemble sweep with a
    terminal and a running objective, and each member's solo sweep on its
    recorded states (per-member counts; on the card its bits must be the
    ensemble's).  Returns plain values."""
    from thermalporous_torch.dist import make_ensemble_step_fn, stack_ensemble
    from thermalporous_torch.interop import problem_data_to_numpy
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.presets import get_case
    from thermalporous_torch.solve import (
        adjoint_gradients,
        ensemble_adjoint_gradients,
        record_ensemble_trajectory,
    )

    device = task
    if device == "cpu":
        torch.set_num_threads(P14_THREADS)
    terminal, running = adj_objectives()
    t0 = time.perf_counter()
    case = get_case("tp_spe10_full", device=device, dtype=torch.float64, shape=FLAGSHIP_SMALL)
    newton = dataclasses.replace(case.newton_cfg, **ADJ_NEWTON)
    pc = case.simulator(pc_cfg=with_fuse(case.pc_cfg, **SMALL_GMG), newton_cfg=newton).pc_cfg
    model = case.model
    datas = ensemble_members(case)
    data_e = stack_ensemble(datas)
    step = make_ensemble_step_fn(model, "cptr", newton, pc, device=device)
    forward = []

    def logged(u, dt_e, d):
        u2, st = step(u, dt_e, d)
        forward.append(list(zip(st.iters.tolist(), st.ksp_iters.tolist())))
        return u2, st

    u0_e = torch.stack([model.initial_state(d) for d in datas])
    states = record_ensemble_trajectory(logged, u0_e, list(ENS_ADJ_DTS), data_e)
    reset_launch_counts()
    kw = dict(terminal=terminal, running=running, pc_cfg=pc, rtol=ADJ_RTOL_SMALL,
              maxiter=ADJ_MAXITER)
    res = ensemble_adjoint_gradients(model, data_e, states, list(ENS_ADJ_DTS), **kw)
    launches = launch_counts() if device == "cuda" else None
    members, bitwise = [], True
    for i in range(len(datas)):
        solo = adjoint_gradients(model, data_e.member(i), [s[i] for s in states],
                                 list(ENS_ADJ_DTS), **kw)
        bitwise = bitwise and (torch.equal(solo.grad_data.fields, res.grad_data.fields[i])
                               and torch.equal(solo.grad_u0, res.grad_u0[i])
                               and torch.equal(solo.value, res.value[i]))
        members.append({"value": float(res.value[i]), "step_iters": solo.step_iters,
                        "converged": solo.converged,
                        "grad": problem_data_to_numpy(res.grad_data.member(i)),
                        "grad_u0": res.grad_u0[i].cpu().numpy()})
    return {"forward": forward, "ksp_iters": res.ksp_iters, "step_iters": res.step_iters,
            "converged": res.converged, "members": members, "bitwise": bitwise,
            "launches": launches, "s": time.perf_counter() - t0}


def ensemble_adjoint(pending) -> dict:
    """Phase 14(b): the card's run against the CPU's (``pending``, from the
    references' pool): the
    per-member forward and backward counts and the lockstep count equal,
    every member's J, gradient leaves and grad_u0 within ENS_GRAD_TOL; on
    the card each member bitwise its solo sweep and every CPTR kernel
    launched."""
    gpu = _ensemble_adjoint_task("cuda")
    cpu = pending.get(timeout=1200)
    gaps = []
    for g, c in zip(gpu["members"], cpu["members"]):
        gaps.append(max(_grad_gap(g["grad"], c["grad"]),
                        float(np.abs(g["grad_u0"] - c["grad_u0"]).max()
                              / np.abs(c["grad_u0"]).max()),
                        abs(g["value"] - c["value"]) / abs(c["value"])))
    per_member = lambda r: [m["step_iters"] for m in r["members"]]
    print(f"  {'x'.join(map(str, FLAGSHIP_SMALL))} f64, {len(ENS_BHP)} members, dts "
          f"{list(ENS_ADJ_DTS)}: forward (newton, fgmres) per step and member cpu "
          f"{cpu['forward']} cuda {gpu['forward']}; backward FGMRES per member cpu "
          f"{per_member(cpu)} cuda {per_member(gpu)}; lockstep cpu {cpu['ksp_iters']} "
          f"{cpu['step_iters']} cuda {gpu['ksp_iters']} {gpu['step_iters']}; gaps per member "
          f"{['%.2e' % x for x in gaps]}; each member bitwise its solo sweep on the card "
          f"{gpu['bitwise']}; {cpu['s']:.1f} s on the CPU, {gpu['s']:.1f} s on the card; "
          f"card launches {gpu['launches']}", flush=True)
    if not (gpu["converged"] and cpu["converged"]):
        raise SystemExit("ensemble adjoint: not converged")
    if (cpu["forward"], per_member(cpu), cpu["ksp_iters"], cpu["step_iters"]) != \
            (gpu["forward"], per_member(gpu), gpu["ksp_iters"], gpu["step_iters"]):
        raise SystemExit("ensemble adjoint: the counts differ between the card and the CPU")
    if max(gaps) > ENS_GRAD_TOL:
        raise SystemExit(f"ensemble adjoint: GPU against CPU {max(gaps):.2e}")
    if not gpu["bitwise"]:
        raise SystemExit("ensemble adjoint: a member differs from its solo sweep on the card")
    for k in ("chebyshev_smooth", "matvec", "deep_correction", "fused_stage2_rbgs"):
        if gpu["launches"][k] <= 0:
            raise SystemExit(f"ensemble adjoint: no {k} launched")
    return {"forward": gpu["forward"], "backward_per_member": per_member(gpu),
            "ksp_iters": gpu["ksp_iters"], "step_iters": gpu["step_iters"], "gaps": gaps,
            "cpu_s": cpu["s"], "cuda_s": gpu["s"], "launches": gpu["launches"]}


def _custom_case_task(device: str) -> dict:
    """Phase 14(d) in process (a worker for the CPU): the custom case for
    CUSTOM_DAYS, its records and unrounded well rates."""
    from thermalporous_torch import custom_case
    from thermalporous_torch.physics import per_well_masks, well_rates

    if device == "cpu":
        torch.set_num_threads(P14_THREADS)
    model, data, wells, heaters, sim = custom_case.build(device)
    res = sim.run(t_end=CUSTOM_DAYS * 86400.0)
    return {"records": [(r.t, r.dt, r.newton_iters, r.ksp_iters, r.retries)
                        for r in res.records],
            "rates": well_rates(model, res.u, data, per_well_masks(model.grid, wells, heaters))}


def examples_start() -> dict:
    """Phase 14(c) and (d): ``python -m thermalporous_torch.iteration_study``
    and ``.custom_case`` on the card, two subprocesses started after (a)'s
    ensemble step, whose walls they would disturb, to run beside (a)'s solo
    steps and (b) (their ``--device cpu`` runs are the references'
    pool's)."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS=str(P14_THREADS))
    return {name: subprocess.Popen(
        [sys.executable, "-m", f"thermalporous_torch.{name}", *args, "--device", "cuda"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, args in EXAMPLE_CLIS}


def examples_stop(procs: dict) -> None:
    """Phase 14: end whatever :func:`examples_start` started that still runs
    (after a failure)."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def examples_finish(procs: dict, refs: dict) -> dict:
    """Phase 14(c) and (d): every line of the study's table equal on the card
    and the CPU; the custom case's lines equal, and its in-process
    records equal and well rates within 1e-12 relative, card against CPU
    (the CPU's runs from the references' pool ``refs``)."""
    out = {}
    for name, proc in procs.items():
        stdout, err = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            raise SystemExit(f"{name} --device cuda exited {proc.returncode}: {err[-2000:]}")
        out[(name, "cuda")] = stdout.splitlines()
        rc, stdout, err = refs[("example", name)].get(timeout=1200)
        if rc != 0:
            raise SystemExit(f"{name} --device cpu exited {rc}: {err[-2000:]}")
        out[(name, "cpu")] = stdout.splitlines()
    study = out[("iteration_study", "cuda")]
    print("\n".join("  | " + line for line in study), flush=True)
    if study != out[("iteration_study", "cpu")] or len(study) != 6:
        raise SystemExit(f"iteration_study: cuda {study} != cpu "
                         f"{out[('iteration_study', 'cpu')]}")
    cli = out[("custom_case", "cuda")]
    print("\n".join("  | " + line for line in cli), flush=True)
    if cli != out[("custom_case", "cpu")]:
        raise SystemExit(f"custom_case CLI: cuda {cli} != cpu {out[('custom_case', 'cpu')]}")
    cpu = refs["custom"].get(timeout=1200)
    gpu = _custom_case_task("cuda")
    gap = max(abs(gpu["rates"][w][k] - v) / abs(v) if v else abs(gpu["rates"][w][k])
              for w, rec in cpu["rates"].items() for k, v in rec.items())
    print(f"  custom_case {CUSTOM_DAYS} days in process: (dt, newton, fgmres) cpu "
          f"{[r[1:4] for r in cpu['records']]} == cuda {[r[1:4] for r in gpu['records']]}; "
          f"well rates' largest relative gap {gap:.2e}", flush=True)
    if cpu["records"] != gpu["records"] or gap > ENS_GRAD_TOL:
        raise SystemExit("custom_case: card against CPU differs")
    return {"study": study, "custom_case_cli": cli, "custom_records": gpu["records"],
            "custom_rate_gap": gap}


# phase 15: the grid decomposition.  The card holds one GPU and NCCL
# refuses two ranks on one device, so (a) runs a one-rank NCCL mesh, (b)
# four gloo ranks sharing cuda:0 (their ghost slices and reduction
# partials staged through the host: a correctness path, not a speed
# claim), (c) the dry run over four such ranks, in a subprocess started
# first, beside (a) and (b).
DECOMP_RANKS = 4
DECOMP_DT = 600.0
# (b): the 2x2 step differs from the one-rank step only in the rounding of
# the global reductions, and the flagship's f32 first step amplifies such a
# difference chaotically (decomp_sensitivity.py: a one-ulp change of one
# cell's initial pressure moves it by up to 1.3e5 Pa), so its state is held
# to the undecomposed Newton test, not to a band on the gap; (c) holds the
# dry run's f64 states to the reference's bands
# the whole-grid Newton norm of the gathered state against the ranks' own
# final norm (the same cells' residuals, summed in another order)
DECOMP_NORM_RTOL = 1e-6
# the kernels every rank of (b) must launch, and the one it must not
DECOMP_KERNELS = ("block_matvec", "matvec", "chebyshev_smooth", "fused_residual",
                  "fused_stage2_rbgs")
DECOMP_REFUSED = ("deep_correction",)
# (e): the launches by block columns every rank of the 2x2 run of
# tp_spe10_inner's configuration must show: the inner operator's B1 at
# nc = 2 and the stage 2 over all three columns
DECOMP_INNER_COLUMNS = ("block_matvec nc=2 k=2", "fused_stage2_rbgs k=3")
# (e): the options the stage-2 and Krylov slice lifted over the
# decomposition, each over the 2x2 ranks on the card in f64 at
# FLAGSHIP_SMALL (phase 10(c)'s configuration), one 600 s step against the
# CPU's undecomposed step: (label, CPRConfig overrides, overrides of both
# GMG configurations, NewtonConfig overrides, gate).  The gate "bands"
# holds the gathered state to DECOMP_OPTION_P_PA and DECOMP_OPTION_S of the
# CPU's; "newton" holds it to the undecomposed Newton test, as (b) does,
# for a configuration whose converged state moves further than the bands
# under a one-ulp change of its input (decomp_sensitivity.py --recycle:
# recycling's harvest under the flagship's loose Krylov tolerance, EW
# forcing and bf16 basis), and the same option under the reference check's
# tolerances (tests/test_sharding.py::test_sharded_ksp_recycle_match)
# takes the bands.  The options share runs where they act on different
# parts of the apply: the orthogonalisations (FGMRES's reductions), the
# stage-1 options (the saturation leg, the inner iterations) and the
# stage-2 ones.
DECOMP_OPTIONS = (
    ("stage2=jacobi2 ksp_orth=cgs1", dict(stage2="jacobi2"), {}, dict(ksp_orth="cgs1"),
     "bands"),
    ("stage2=rbgs sweeps=2 s_stage=rbgs", dict(stage2_sweeps=2, s_stage="rbgs"), {}, {},
     "bands"),
    ("stage2=bgmg inner richardson",
     dict(stage2="bgmg", inner_iters=2, inner_method="richardson"), {}, {}, "bands"),
    ("stage2=zebra axis=2 ksp_orth=cgs2s inner fgmres",
     dict(stage2="zebra", stage2_axis=2, inner_iters=2), {}, dict(ksp_orth="cgs2s"), "bands"),
    ("ksp_recycle=4", {}, {}, dict(ksp_recycle=4), "newton"),
    ("ksp_recycle=4 tight", {}, {},
     dict(ksp_recycle=4, rtol=1e-8, atol=0.0, ksp_rtol=1e-6, ksp_maxiter=80, ksp_ew=False,
          ksp_basis="same"), "bands"),
    # tp_spe10_inner's configuration (two inner FGMRES iterations, the T
    # hierarchy on the pressure configuration, the stage-2 residual over all
    # columns): B1 at nc = 2 and B5 at k = 3 on the extended blocks
    ("tp_spe10_inner", dict(inner_iters=2, gmg_t=None, stage2_cols=False), {}, {}, "bands"),
)
# (f): the options this slice lifted, over the same ranks after (e), as
# (e)'s: the weighted and variational transfers (their finest level
# decomposed, its coarse rows and weights from the block) and the J(u)v
# operator (B7 on the extended block); each held to the undecomposed
# Newton test, as the flagship's loose Krylov tolerances and bf16 basis
# amplify the decomposition's rounding (the reference checks' bands hold
# in tests/test_torch_sharding_adjoint.py); the launches each must show on
# every rank: (counter, kind), kind "wrapper" (> 0) or "none" (== 0)
DECOMP_FAMILY = (
    ("transfer=weighted", {}, dict(transfer="weighted"), {}, "newton"),
    ("transfer=variational", {}, dict(transfer="variational"), {}, "newton"),
    ("krylov_op=jvp", {}, {}, dict(krylov_op="jvp"), "newton"),
)
DECOMP_FAMILY_CHECKS = {
    "transfer=weighted": (("chebyshev_smooth", "wrapper"), ("deep_correction", "none")),
    "transfer=variational": (("chebyshev_smooth", "wrapper"), ("deep_correction", "none")),
    "krylov_op=jvp": (("fused_jvp", "wrapper"), ("fused_residual", "wrapper")),
}
# (f): the adjoint over two steps and the ensemble of decomposed members
# (ENS_BHP) over one, at FLAGSHIP_SMALL, f64, with phase 13(d)'s Newton
# (ADJ_NEWTON) and sweep tolerance, against the CPU's undecomposed sweeps
DECOMP_ADJ_DTS = (600.0, 1200.0)
DECOMP_ENS_DTS = (600.0,)
# (b), PR 15: the full-width 2x2 runs of the modes the decomposition ran
# last, each one first step of the flagship from DECOMP_WIDE_DT (the Δt
# phases 12 and 13 start these modes at; DECOMP_WIDE_DT / 2 for both runs
# when the undecomposed card step fails there): (label, CPRConfig
# overrides, the variant launches every rank must show).  bf16 storage
# with two stage-2 sweeps, so that the bf16 B1 (the stage-2 residual), B5
# (the zero-start sweep) and half-sweep launch beside B2 and B3; batch_pt
# (the T hierarchy on the pressure configuration) with the zebra stage 2
# along the decomposed y, its block line solves a pipeline through the
# ranks at full length
DECOMP_WIDE_DT = 300.0
DECOMP_WIDE = (
    ("pc_dtype=bf16 stage2_sweeps=2", dict(pc_dtype="bf16", stage2_sweeps=2),
     ("block_matvec bf16", "matvec bf16", "chebyshev_smooth bf16", "fused_stage2_rbgs bf16",
      "block_rbgs_half_sweep bf16")),
    ("batch_pt stage2=zebra axis=1", dict(BATCH_PT, stage2="zebra", stage2_axis=1),
     ("chebyshev_smooth batched",)),
)
# (g), PR 15: every option the decomposition ran last, one step each over
# the 2x2 ranks on the card in f64 against the CPU's undecomposed step, at
# DECOMP_REST_SHAPE (split_ranges(14, 2) = (0, 7, 14): both owned origins
# odd along x and y), both hierarchies coarsening z only for two levels
# (DECOMP_REST_FACTORS; their boundaries then stay aligned) and
# decomposed above DECOMP_REST_REPLICATE cells, so that the smoothers run
# on decomposed levels in an odd colour offset.  Options that act on
# different parts of the apply share a run: (label, precond, CPRConfig
# overrides, GMG overrides (both hierarchies), NewtonConfig overrides, gate,
# launch checks).  The
# gate "bands" holds the gathered state to DECOMP_OPTION_P_PA and
# DECOMP_OPTION_S of the CPU's, "newton" (bf16 storage) to the
# undecomposed Newton test; "audit" also holds a two-step run's balance
# audit rows to DECOMP_AUDIT_RTOL of the CPU's.  A check (name, kind): kind
# "wrapper" a launch counter > 0, "none" == 0, "variant" a bf16 or batched
# launch count > 0, "carries" the line solves' pipeline carries > 0.
DECOMP_REST_SHAPE = (14, 14, 9)
DECOMP_REST_FACTORS = ((1, 1, 2), (1, 1, 2))
DECOMP_REST_REPLICATE = 500
DECOMP_AUDIT_RTOL = 1e-10
DECOMP_REST_PC_NEWTON = dict(ksp_ew=False, ksp_rtol=1e-4, ksp_basis="same")
_LINE_RUN = (("carries", "carries"), ("matvec", "wrapper"), ("chebyshev_smooth", "none"))
DECOMP_REST = (
    ("stage2=zebra axis=0 s_stage=zebra axis=1 smoother=line axis=0", "cptr",
     dict(stage2="zebra", stage2_axis=0, s_stage="zebra", s_axis=1),
     dict(smoother="line", line_axis=0), {}, "bands", _LINE_RUN),
    ("stage2=zebra axis=1 s_stage=line axis=0 smoother=zebra axis=1", "cptr",
     dict(stage2="zebra", stage2_axis=1, s_stage="line", s_axis=0),
     dict(smoother="zebra", line_axis=1), {}, "bands", _LINE_RUN),
    ("stage2_axes=(0,) s_stage=zebra axis=0 smoother=jacobi cycles=2", "cptr",
     dict(stage2_axes=(0,), s_stage="zebra", s_axis=0), dict(smoother="jacobi", cycles=2), {},
     "bands", _LINE_RUN + (("fused_stage2_rbgs", "none"),)),
    ("stage2_fused axes=(1,) sweeps=2 s_stage=line axis=1 smoother=rbgs", "cptr",
     dict(stage2_fused=True, stage2_axes=(1,), stage2_sweeps=2, s_stage="line", s_axis=1),
     dict(smoother="rbgs"), {}, "bands",
     _LINE_RUN + (("block_rbgs_half_sweep", "wrapper"), ("fused_stage2_rbgs", "none"))),
    ("stage2_fused smoother=zebra axis=0", "cptr", dict(stage2_fused=True),
     dict(smoother="zebra", line_axis=0), {}, "bands",
     _LINE_RUN + (("fused_stage2_rbgs", "wrapper"),)),
    ("batch_pt", "cptr", BATCH_PT, {}, {}, "bands",
     (("chebyshev_smooth batched", "variant"), ("deep_correction", "none"))),
    ("pc_dtype=bf16 stage2_sweeps=2", "cptr", dict(pc_dtype="bf16", stage2_sweeps=2), {}, {},
     "newton", tuple((k, "variant") for k in DECOMP_WIDE[0][2])),
    ("pc_dtype=bf16_gmg", "cptr", dict(pc_dtype="bf16_gmg"), {}, {}, "newton",
     (("chebyshev_smooth bf16", "variant"), ("matvec bf16", "variant"))),
    ("pc_dtype=bf16_s2 stage2_sweeps=2 smoother=line axis=1", "cptr",
     dict(pc_dtype="bf16_s2", stage2_sweeps=2), dict(smoother="line", line_axis=1), {},
     "newton",
     _LINE_RUN + tuple((k, "variant") for k in ("block_matvec bf16", "fused_stage2_rbgs bf16",
                                                "block_rbgs_half_sweep bf16"))),
    # block Jacobi under the flagship's loose EW forcing stalls the line
    # search at 12 Newton (on the CPU too): the three named preconditioners
    # take a fixed Krylov tolerance, and their long Krylov runs a basis in
    # the state's dtype
    ("precond=jacobi", "jacobi", {}, {}, DECOMP_REST_PC_NEWTON, "bands",
     (("block_matvec", "wrapper"), ("fused_stage2_rbgs", "none"))),
    ("precond=rbgs", "rbgs", {}, {}, DECOMP_REST_PC_NEWTON, "bands",
     (("fused_stage2_rbgs", "wrapper"), ("block_rbgs_half_sweep", "wrapper"))),
    ("precond=lu", "lu", {}, {}, DECOMP_REST_PC_NEWTON, "bands",
     (("block_matvec", "wrapper"), ("chebyshev_smooth", "none"))),
    ("audit, two steps", "cptr", {}, {}, {}, "audit",
     (("chebyshev_smooth", "wrapper"), ("fused_stage2_rbgs", "wrapper"))),
)
# (e): levels above this many cells stay decomposed at FLAGSHIP_SMALL
# (2,376 cells, blocks 6x12 and 6x10): the finest level of the p and T
# hierarchies and of bgmg's coupled one
DECOMP_OPTIONS_REPLICATE = 1000
# (e): the reference tests' bands on the gathered f64 state against the
# CPU's (p in Pa, S): rounding differences of the reductions only
DECOMP_OPTION_P_PA = 10.0
DECOMP_OPTION_S = 1e-8
# the blocks of the kernel check: the flagship grid cut at odd boundaries
# (ext origin x 29: an odd index sum), as a 2x2 mesh's rank (1, 0) holds it
DECOMP_BLOCK = ((31, 60), (0, 112))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def decomp_kernel_blocks(dev) -> dict:
    """Phase 15 (a'): the kernels of the decomposed path on a block of the
    flagship grid whose extended origin has an odd index sum, against the
    same kernels on the whole grid: bitwise on the owned cells, the stage
    2 and the half-sweep with the block's parity (and not without it)."""
    from thermalporous_torch.kernels import residual as kres
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.chebyshev import gershgorin_lambda_max
    from thermalporous_torch.presets import get_case

    case = get_case("tp_spe10_full", device=dev)
    u0 = case.model.initial_state(case.data)
    st = case.model.assemble_stencil(u0, u0, DECOMP_DT, case.data)
    dinv = st.diag_inverse()
    g = torch.Generator(device=dev).manual_seed(15)
    rnd = lambda *s: torch.randn(s, generator=g, dtype=u0.dtype, device=dev)
    r, x1 = rnd(3, *SPE10_FULL), rnd(2, *SPE10_FULL)
    ps = st.scalar(0, 0)
    lam = gershgorin_lambda_max(ps)
    b, x = rnd(*SPE10_FULL), rnd(*SPE10_FULL)
    (ox0, ox1), (oy0, oy1) = DECOMP_BLOCK
    out = {}

    def check(label, w, fn, whole, coefs, vecs, parity_arg=False):
        ex0, ex1 = max(ox0 - w, 0), min(ox1 + w, SPE10_FULL[0])
        ey0, ey1 = max(oy0 - w, 0), min(oy1 + w, SPE10_FULL[1])
        par = (ex0 + ey0) % 2
        cut = lambda t, lead: t[(slice(None),) * lead + (slice(ex0, ex1), slice(ey0, ey1))
                                ].contiguous()
        own = lambda t, lead, x0=ex0, y0=ey0: t[(slice(None),) * lead + (
            slice(ox0 - x0, ox1 - x0), slice(oy0 - y0, oy1 - y0))]
        args = [cut(c, c.dim() - 3) for c in coefs] + [cut(v, v.dim() - 3) for v in vecs]
        got = fn(*args, par) if parity_arg else fn(*args)
        got, whole = (got, whole) if isinstance(got, tuple) else ((got,), (whole,))
        ok = all(torch.equal(own(gv, gv.dim() - 3), own(wv, wv.dim() - 3, 0, 0))
                 for gv, wv in zip(got, whole))
        if not ok:
            raise SystemExit(f"phase 15: {label} on the odd block differs from the whole grid")
        if parity_arg:
            wrong = fn(*args, 1 - par)
            wrong = wrong if isinstance(wrong, tuple) else (wrong,)
            if torch.equal(own(wrong[0], wrong[0].dim() - 3), own(whole[0], whole[0].dim() - 3,
                                                                  0, 0)):
                raise SystemExit(f"phase 15: {label} with the local colouring matches")
        out[label] = {"parity": par, "bitwise": True}
        print(f"  {label}: block x {ox0}:{ox1} y {oy0}:{oy1} (+{w} ghosts, origin parity "
              f"{par}) bitwise the whole grid's", flush=True)

    from thermalporous_torch.models.base import ProblemData

    u = u0 + 1e4 * rnd(3, *SPE10_FULL) * torch.tensor([1.0, 1e-4, 1e-6], dtype=u0.dtype,
                                                       device=dev).reshape(3, 1, 1, 1)

    def residual_on(fields, uu, uo):
        # the model on the block's grid: the extended shape, the same spacing
        block = copy.copy(case.model)
        block.grid = dataclasses.replace(case.model.grid, shape=tuple(uu.shape[1:]))
        return kres.fused_residual(block, uu, uo, DECOMP_DT, ProblemData(fields))

    check("fused_residual", 1, residual_on,
          kres.fused_residual(case.model, u, u0, DECOMP_DT, case.data),
          [case.data.fields], [u, u0])
    check("block_matvec k=3", 1, lambda c, v: kst.block_matvec(c, v, 3),
          kst.block_matvec(st.coef, r, 3), [st.coef], [r])
    check("matvec", 1, kst.matvec, kst.matvec(ps.packed, b), [ps.packed], [b])
    check("chebyshev_smooth deg=4 second=residual", 5,
          lambda c, bb, xx: kst.chebyshev_smooth(c, bb, xx, lam, 4, 0.3, second="residual"),
          kst.chebyshev_smooth(ps.packed, b, x, lam, 4, 0.3, second="residual"),
          [ps.packed], [b, x])
    check("fused_stage2_rbgs k=2", 2,
          lambda c, d, rr, xx, par: kst.fused_stage2_rbgs(c, d, rr, xx, parity=par),
          kst.fused_stage2_rbgs(st.coef, dinv, r, x1), [st.coef, dinv], [r, x1],
          parity_arg=True)
    for colour in (0, 1):
        check(f"block_rbgs_half_sweep colour {colour}", 1,
              lambda c, d, rr, xx, par: kst.block_rbgs_half_sweep(c, d, rr, xx, colour,
                                                                  parity=par),
              kst.block_rbgs_half_sweep(st.coef, dinv, r, u0, colour), [st.coef, dinv],
              [r, u0], parity_arg=True)
    del st, dinv, r, x1, ps, b, x
    torch.cuda.empty_cache()
    out["fused_jvp"] = decomp_jvp_block(case, u0, u, dev)
    return out


def decomp_jvp_block(case, u0, u, dev) -> dict:
    """Phase 15 (a): B7 (J(u)v) on the extended block of DECOMP_BLOCK (the
    decomposed step's ring, STATE_HALO deep: origin x 29, an odd index sum),
    f32 and f64, against its plain version on the same block, within phase
    2's tolerances for B7; its time per call and on the card beside phase
    2's B7 row, and (f32) phase 2's library yardstick on the block."""
    from thermalporous_torch.dist.sharding import STATE_HALO
    from thermalporous_torch.kernels import residual as kres
    from thermalporous_torch.models.base import ProblemData
    from thermalporous_torch.presets import get_case

    (ox0, ox1), (oy0, oy1) = DECOMP_BLOCK
    ex0, ex1 = max(ox0 - STATE_HALO, 0), min(ox1 + STATE_HALO, SPE10_FULL[0])
    ey0, ey1 = max(oy0 - STATE_HALO, 0), min(oy1 + STATE_HALO, SPE10_FULL[1])
    cut = lambda t: t[(slice(None),) * (t.dim() - 3) + (slice(ex0, ex1), slice(ey0, ey1))
                      ].contiguous()
    out = {}
    for dtype, tol in ((torch.float32, TOL_F32_JVP), (torch.float64, TOL_F64)):
        tname = "f32" if dtype == torch.float32 else "f64"
        if dtype != u0.dtype:
            case = get_case("tp_spe10_full", device=dev, dtype=dtype)
            u0, u = u0.to(dtype), u.to(dtype)
        block = copy.copy(case.model)
        block.grid = dataclasses.replace(case.model.grid, shape=(ex1 - ex0, ey1 - ey0,
                                                                  SPE10_FULL[2]))
        g = torch.Generator(device=dev).manual_seed(16)
        uu, uo, data = cut(u), cut(u0), ProblemData(cut(case.data.fields))
        v = (state_amp(uu) * torch.randn(tuple(uu.shape), generator=g, dtype=dtype,
                                         device=dev)).contiguous()
        kern = lambda: kres.fused_jvp(block, uu, v, uo, DECOMP_DT, data)
        plain = lambda: block.jvp(uu, uo, DECOMP_DT, data)(v)
        got, ref = kern(), plain()
        rel, abs_ = rel_err(got, ref, True)
        ms, plain_ms = time_ms(kern), time_ms(plain, reps=PLAIN_REPS, warm=1)
        device_ms = time_device_ms(kern)
        bnd, by = bound_ms(*cost_jvp(block, uu, data))
        # the library yardstick, as phase 2's B7 row: torch.sparse.mm on a CSR
        # of the operator assembled on the same block (f32 rows only)
        lib_ms = None
        if dtype == torch.float32:
            a = block_csr(block.assemble_stencil(uu, uo, DECOMP_DT, data).coef)
            lib_ms = time_ms(lambda: spmv(a, v))
            del a
        ok = math.isfinite(rel) and rel <= tol and bool(torch.isfinite(got).all())
        out[tname] = {"max_rel_err": rel, "max_abs_err": abs_, "ms": ms, "plain_ms": plain_ms,
                      "device_ms": device_ms, "library_ms": lib_ms,
                      "bound_ms": bnd, "bound_by": by, "origin_parity": (ex0 + ey0) % 2,
                      "shape": tuple(uu.shape[1:])}
        print(f"  {tname} fused_jvp on the block x {ex0}:{ex1} y {ey0}:{ey1} (origin parity "
              f"{(ex0 + ey0) % 2}): max_rel_err {rel:.3e} (tol {tol:.0e}) max_abs_err "
              f"{abs_:.3e}  kernel {ms:.4f} ms ({device_ms:.4f} on the card)  plain "
              f"{plain_ms:.4f} ms  bound {bnd:.4f} ms ({by})"
              + (f"  library {lib_ms:.4f} ms" if lib_ms is not None else "")
              + f"  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"phase 15(a): fused_jvp on the odd block, {tname}: {rel:.3e}")
        del got, ref
    return out


def decomp_variant_blocks(dev) -> dict:
    """Phase 15 (a), the bf16 and batched forms of the decomposed path's
    kernels: B1 (nc = 3, k = 2, the stage-2 residual of two sweeps), B2
    (the T<-p coupling) and B3 (the finest pressure level, degree 4 from
    zero with b - A y, the decomposed pre-smooth) with bf16 coefficients,
    B5 in bf16 at k = 2 with the block's odd parity offset, and B3 batched
    (batch_pt's stacked p and T finest levels, from zero with b - A y), each
    on the extended block of DECOMP_BLOCK at the ring its decomposed caller
    holds (STATE_HALO, the smooth's degree + 1), f32 and f64 vectors,
    against its plain version on the same block (phase 2's and 12's
    tolerances), timed.  Returns {dtype: {case: row}}."""
    from thermalporous_torch.core.stencil import BlockStencil
    from thermalporous_torch.dist.sharding import STATE_HALO
    from thermalporous_torch.kernels import stencil as kst
    from thermalporous_torch.precond.cpr import cast_coefficients, cpr_setup

    (ox0, ox1), (oy0, oy1) = DECOMP_BLOCK
    out = {}
    for dtype in (torch.float32, torch.float64):
        tname = "f32" if dtype == torch.float32 else "f64"
        tol = TOL_F64 if dtype == torch.float64 else TOL_F32_STENCIL
        _, _, _, pc, st, _ = preset_state("tp_spe10_full", dtype, dev,
                                          dict(fuse_below=FLAGSHIP_FUSE_BELOW))
        bf = cast_coefficients(cpr_setup(st, pc), "bf16")
        bat = cpr_setup(st, dataclasses.replace(pc, **BATCH_PT))
        deg, frac = pc.gmg.degree, pc.gmg.lam_min_frac

        def cut(t, w, grid_lead):
            ex0, ex1 = max(ox0 - w, 0), min(ox1 + w, SPE10_FULL[0])
            ey0, ey1 = max(oy0 - w, 0), min(oy1 + w, SPE10_FULL[1])
            return t[(slice(None),) * grid_lead + (slice(ex0, ex1), slice(ey0, ey1))
                     ].contiguous()

        w2, ws = STATE_HALO, deg + 1
        par = (max(ox0 - w2, 0) + max(oy0 - w2, 0)) % 2
        coef, dinv = cut(bf.stencil.coef, w2, 3), cut(bf.dinv, w2, 2)
        grid = tuple(coef.shape[3:])
        n, dim, item = math.prod(grid), 3, st.coef.element_size()
        g = torch.Generator(device=dev).manual_seed(21)
        rand = lambda shape: torch.randn(shape, generator=g, dtype=dtype, device=dev)
        r, x1, v = rand((3,) + grid), rand((2,) + grid), rand((2,) + grid)
        atp, b2 = cut(bf.a_tp.packed, w2, 1), rand(grid)
        gs = "x".join(map(str, grid))
        cases = [
            (f"block_matvec nc=3 k=2 bf16 coefficients odd block {gs}", "block_matvec",
             lambda: kst.block_matvec(coef, v, 2), lambda: kst.block_matvec_plain(coef, v), tol,
             cost_block_matvec(n, dim, 3, 2, item, 2), None),
            (f"matvec T<-p bf16 coefficients odd block {gs}", "matvec",
             lambda: kst.matvec(atp, b2), lambda: kst.matvec_plain(atp, b2), tol,
             cost_matvec(n, dim, item, 2), None),
            (f"fused_stage2_rbgs k=2 bf16 coefficients odd block parity {par} {gs}",
             "fused_stage2_rbgs",
             lambda: kst.fused_stage2_rbgs(coef, dinv, r, x1, parity=par),
             lambda: kst.fused_stage2_rbgs_plain(coef, dinv, r, x1, parity=par), tol,
             cost_stage2(n, dim, 3, 2, item, 2), None)]
        fine = cut(bf.gmg_p.stencils[0].packed, ws, 1)
        bs = rand(tuple(fine.shape[1:]))
        cases.append(second_case(f"fine bf16 coefficients odd block", fine,
                                 bf.gmg_p.lam_max[0], bs, None, deg, "residual", tol, item))
        pt = cut(bat.gmg_p.stencils[0].packed, ws, 2)
        lam2, bb = bat.gmg_p.lam_max[0], rand((2,) + tuple(pt.shape[2:]))
        ns = math.prod(pt.shape[2:])
        sb, so = cost_chebyshev_second(ns, dim, deg, False, "residual", item)
        cases.append((f"chebyshev batch_pt (p, T) fine deg={deg} zero second=residual odd "
                      f"block {'x'.join(map(str, pt.shape[2:]))}", "chebyshev_smooth",
                      lambda: kst.chebyshev_smooth(pt, bb, None, lam2, deg, frac,
                                                   second="residual"),
                      lambda: kst.chebyshev_smooth_plain(pt, bb, None, lam2, deg, frac,
                                                         second="residual"),
                      tol, (2 * sb, 2 * so), None))
        start = len(ROWS)
        run_cases(f"{tname} (15a)", cases, BlockStencil(coef), {}, dtype, record=False)
        out[tname] = _rows_since(start)
        del st, bf, bat, coef, dinv, fine, pt
        torch.cuda.empty_cache()
    return out


def _flagship_step(dev, dtype, pc_kw: dict | None = None, dt: float = DECOMP_DT):
    """The flagship's undecomposed first step from ``dt`` (fuse_below=150000,
    with the CPRConfig overrides ``pc_kw``): (case, planned CPRConfig, u0,
    state, stats, launches, wall)."""
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.presets import get_case
    from thermalporous_torch.solve import make_step_fn

    case = get_case("tp_spe10_full", device=dev, dtype=dtype)
    pc = dataclasses.replace(with_fuse(case.pc_cfg, FLAGSHIP_FUSE_BELOW), **(pc_kw or {}))
    pc = case.simulator(pc_cfg=pc).pc_cfg
    u0 = case.model.initial_state(case.data)
    step = make_step_fn(case.model, "cptr", case.newton_cfg, pc, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    u, st = step(u0, dt, case.data)
    torch.cuda.synchronize()
    return case, pc, u0, u, st, launch_counts(), time.perf_counter() - t


def decomp_wide_steps(dev) -> list:
    """Phase 15 (b), PR 15: the undecomposed card step of each DECOMP_WIDE
    configuration from DECOMP_WIDE_DT (from half of it, and then its 2x2
    run too, when it fails there): per run {label, pc_kw, dt, counts,
    wall, launches, level factors, case, u0}."""
    from thermalporous_torch.kernels import variant_counts

    out = []
    for label, pc_kw, _ in DECOMP_WIDE:
        for dt in (DECOMP_WIDE_DT, DECOMP_WIDE_DT / 2):
            case, pc, u0, u, st, launches, wall = _flagship_step(dev, torch.float32, pc_kw, dt)
            if not st.failed:
                break
            print(f"  {label}: the undecomposed card step fails at {dt:.0f} s "
                  f"({st.iters} Newton); both runs start at {dt / 2:.0f} s", flush=True)
        if st.failed:
            raise SystemExit(f"phase 15(b): {label}: the undecomposed step fails at {dt} s")
        variants = variant_counts()
        print(f"  undecomposed {label} from {dt:.0f} s: (newton, fgmres) ({st.iters}, "
              f"{st.ksp_iters}), wall {wall:.3f} s, launches {launches}; variants {variants}",
              flush=True)
        out.append({"label": label, "pc_kw": pc_kw, "dt": dt, "newton": st.iters,
                    "fgmres": st.ksp_iters, "wall_s": wall, "launches": launches,
                    "variants": variants,
                    "level_factors": (pc.gmg.level_factors,
                                      None if pc.gmg_t is None else pc.gmg_t.level_factors),
                    "case": case, "u0": u0})
        del u
        torch.cuda.empty_cache()
    return out


def decomp_one_rank(dev, dtype=torch.float32) -> dict:
    """Phase 15 (a): the flagship's first step on a one-rank NCCL mesh,
    bitwise the undecomposed step with the same GMGConfig apart from
    ``mesh``, with the same launches per kernel."""
    import torch.distributed as tdist

    from thermalporous_torch.dist.sharding import (
        gather_state,
        init_process_group,
        make_grid_mesh,
        shard_problem_data,
        shard_state,
    )
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.solve import Simulator

    case, pc, u0, u_ref, st_ref, l_ref, wall_ref = _flagship_step(dev, dtype)
    init_process_group("nccl", 0, 1, f"tcp://localhost:{_free_port()}")
    try:
        mesh = make_grid_mesh(1, backend="nccl", device=dev)
        pc_m = option_config(pc, {}, dict(mesh=mesh))
        sim = Simulator(case.model, shard_problem_data(case.data, mesh), pc_cfg=pc_m,
                        newton_cfg=case.newton_cfg, time_cfg=case.time_cfg, device=dev)
        us = shard_state(u0, mesh)
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        u1, st1 = sim.step(us, DECOMP_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        l_one = launch_counts()
        u1 = gather_state(u1, mesh)
    finally:
        tdist.destroy_process_group()
    counts = (st1.iters, st1.ksp_iters)
    tag = str(dtype).removeprefix("torch.")
    print(f"  undecomposed {tag}: (newton, fgmres) ({st_ref.iters}, {st_ref.ksp_iters}), wall "
          f"{wall_ref:.3f} s, launches {l_ref}", flush=True)
    print(f"  one-rank NCCL mesh {tag}: (newton, fgmres) {counts}, wall {wall:.3f} s, "
          f"launches {l_one}", flush=True)
    if not torch.equal(u1, u_ref) or counts != (st_ref.iters, st_ref.ksp_iters):
        gap = float((u1.double() - u_ref.double()).abs().max())
        raise SystemExit(f"phase 15(a): the one-rank step is not the undecomposed step "
                         f"(gap {gap:.3e}, counts {counts})")
    if l_one != l_ref:
        raise SystemExit(f"phase 15(a): launches {l_one} != undecomposed {l_ref}")
    check_physical(u1, SPE10_FULL, "phase 15(a)")
    return {"dtype": tag, "newton": counts[0], "fgmres": counts[1], "norm": st1.norm,
            "norm0": st1.norm0, "wall_s": wall, "wall_ref_s": wall_ref, "launches": l_one,
            "level_factors": (pc.gmg.level_factors, pc.gmg_t.level_factors),
            "u": u1.cpu().numpy(), "case": case, "u0": u0}


def _gaps(a: np.ndarray, b: np.ndarray) -> list:
    return [float(np.abs(a[c].astype(np.float64) - b[c].astype(np.float64)).max())
            for c in range(3)]


def _decomp_rank(mesh, level_factors, dtype_name: str, pc_kw: dict | None = None,
                 dt: float = DECOMP_DT) -> dict:
    """Phase 15 (b), one rank: the flagship's first step from ``dt`` on the
    2x2 mesh (with the CPRConfig overrides ``pc_kw``), with the
    undecomposed run's coarsening schedules ``level_factors`` (p, T); under
    a zebra stage 2 also the line solves' share of an apply
    (:func:`_zebra_share`)."""
    from thermalporous_torch.dist.sharding import gather_state, shard_problem_data, shard_state
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts, variant_counts
    from thermalporous_torch.presets import get_case
    from thermalporous_torch.solve import Simulator

    dev = mesh.device
    case = get_case("tp_spe10_full", device=dev, dtype=getattr(torch, dtype_name))
    pc = dataclasses.replace(with_fuse(case.pc_cfg, FLAGSHIP_FUSE_BELOW), **(pc_kw or {}))
    gmg_t = None if pc.gmg_t is None else dataclasses.replace(
        pc.gmg_t, mesh=mesh, level_factors=level_factors[1])
    pc = dataclasses.replace(
        pc, gmg=dataclasses.replace(pc.gmg, mesh=mesh, level_factors=level_factors[0]),
        gmg_t=gmg_t)
    data = shard_problem_data(case.data, mesh)
    sim = Simulator(case.model, data, pc_cfg=pc, newton_cfg=case.newton_cfg,
                    time_cfg=case.time_cfg, device=dev)
    u0 = shard_state(case.model.initial_state(case.data), mesh)
    del case
    mesh.barrier()
    torch.cuda.synchronize()
    reset_launch_counts()
    mesh.reset_stats()
    by_cols: dict = {}
    t = time.perf_counter()
    with count_by_columns(by_cols):
        u, st = sim.step(u0, dt)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, variants = launch_counts(), variant_counts()
    stats = dict(mesh.stats)
    whole = gather_state(u, mesh)
    out = {"rank": mesh.rank, "block": data.block.owned_shape, "newton": st.iters,
           "fgmres": st.ksp_iters, "converged": st.converged, "norm": st.norm, "wall_s": wall,
           "launches": launches, "variants": variants, "by_columns": by_cols, "stats": stats,
           "u": whole.cpu().numpy() if mesh.rank == 0 else None}
    if sim.pc_cfg.stage2 == "zebra":
        out["zebra"] = _zebra_share(mesh, sim, data, u0, dt)
    return out


def _zebra_share(mesh, sim, data, u0, dt: float) -> dict:
    """Phase 15 (b), one rank: the decomposed CPTR apply of ``sim``'s
    configuration (a zebra stage 2 along a decomposed axis) at ``u0`` and
    its two pipelined block line solves alone (the carries' waits
    included), each timed over the ranks started together: ms each and
    the solves' share of the apply."""
    from thermalporous_torch.precond.chebyshev import block_tridiag_solve_factored
    from thermalporous_torch.precond.cpr import cpr_apply, cpr_setup

    blk, pc = data.block, sim.pc_cfg
    state = cpr_setup(sim.model.assemble_stencil(u0, u0, dt, data), pc, block=blk)
    g = torch.Generator(device=mesh.device).manual_seed(22 + mesh.rank)
    r = torch.randn((3,) + blk.owned_shape, generator=g, dtype=u0.dtype, device=mesh.device)
    a = pc.stage2_axis % 3

    def timed(fn, reps: int = 3) -> float:
        fn()
        mesh.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    apply_ms = timed(lambda: cpr_apply(state, r, pc))
    solves_ms = timed(lambda: [block_tridiag_solve_factored(a, state.zebra_fac, r, block=blk)
                               for _ in range(2)])
    return {"apply_ms": apply_ms, "line_solves_ms": solves_ms, "share": solves_ms / apply_ms}


def _newton_norm(case, u: torch.Tensor, u0: torch.Tensor, dt: float = DECOMP_DT) -> float:
    """The Newton test's scaled RMS norm of the undecomposed residual at
    ``u`` (the step of ``dt`` from ``u0``), accumulated in f64 as Newton
    does."""
    from thermalporous_torch.kernels.residual import fused_residual

    f = fused_residual(case.model, u, u0, dt, case.data)
    q = (f / case.model.residual_scales(u0, dt, case.data)).reshape(-1).double()
    return float(torch.sqrt(torch.dot(q, q) / q.numel()))


def _ranks_report(tag: str, outs: list, counts: tuple, kernels: tuple,
                  columns: tuple = ()) -> None:
    """Each rank's counts, wall, collectives per Newton and launches
    printed; every rank must take ``counts`` (Newton, FGMRES) and converge,
    launch each of ``kernels`` (and each key of ``columns`` in its launches
    by block columns) and none of DECOMP_REFUSED."""
    for o in outs:
        n = max(o["newton"], 1)
        print(f"  rank {o['rank']} block {o['block']}: (newton, fgmres) "
              f"({o['newton']}, {o['fgmres']}), wall {o['wall_s']:.3f} s; per Newton "
              f"{o['stats']['exchanges'] / n:.1f} exchanges, "
              f"{o['stats']['allreduces'] / n:.1f} all-reduces, "
              f"{o['stats']['gathers'] / n:.1f} all-gathers; host-staged exchange "
              f"{1e3 * o['stats']['exchange_s'] / max(o['stats']['exchanges'], 1):.3f} ms "
              f"each; launches {o['launches']}; by columns {o['by_columns']}", flush=True)
        if (o["newton"], o["fgmres"]) != counts or not o["converged"]:
            raise SystemExit(f"phase 15{tag}: rank {o['rank']} (newton, fgmres) "
                             f"({o['newton']}, {o['fgmres']}) != the reference's {counts}")
        missing = ([k for k in kernels if o["launches"][k] <= 0]
                   + [k for k in columns if o["by_columns"].get(k, 0) <= 0])
        extra = [k for k in DECOMP_REFUSED if o["launches"][k] != 0]
        if missing or extra:
            raise SystemExit(f"phase 15{tag}: rank {o['rank']} launched no {missing}, "
                             f"launched {extra}")


def _gathered_newton_test(tag: str, case, u0: torch.Tensor, outs: list,
                          dt: float = DECOMP_DT) -> dict:
    """The gathered state (rank 0's) finite and physical, and under the
    undecomposed Newton test of the step of ``dt``: its scaled residual
    norm on the whole grid under the step's tolerance and equal to the
    ranks' own final norm."""
    u = torch.as_tensor(outs[0]["u"], device=u0.device)
    check_physical(u, SPE10_FULL, f"phase 15{tag}")
    newton = case.newton_cfg
    norm0 = _newton_norm(case, u0, u0, dt)
    tol = max(newton.rtol * norm0, newton.atol, 50.0 * float(torch.finfo(u0.dtype).eps))
    norm = _newton_norm(case, u, u0, dt)
    print(f"  the undecomposed Newton test at the gathered state: {norm:.6e} (tol {tol:.3e}; "
          f"the ranks' final norm {outs[0]['norm']:.6e})", flush=True)
    if not (norm <= tol and abs(norm - outs[0]["norm"]) <= DECOMP_NORM_RTOL * norm):
        raise SystemExit(f"phase 15{tag}: the gathered state's Newton norm {norm} (tol {tol}, "
                         f"the ranks' {outs[0]['norm']})")
    return {"newton_norm": norm, "newton_tol": tol}


def _decomp_ranks(mesh, factors_b, factors_e, wide) -> tuple:
    """Phase 15 (b), (e), (f) and (g), one rank, in one spawn: the
    flagship's first step on the 2x2 mesh and the full-width runs of
    ``wide`` (per DECOMP_WIDE run: its CPRConfig overrides, Δt and
    coarsening schedules), every DECOMP_OPTIONS and DECOMP_FAMILY entry's
    step, (f)'s adjoint and ensemble, then every DECOMP_REST run."""
    b = _decomp_rank(mesh, factors_b, "float32")
    torch.cuda.empty_cache()
    w = []
    for run in wide:
        w.append(_decomp_rank(mesh, run["level_factors"], "float32", run["pc_kw"], run["dt"]))
        torch.cuda.empty_cache()
    e = _decomp_option_rank(mesh, [o[0] for o in DECOMP_OPTIONS + DECOMP_FAMILY], factors_e)
    f = _decomp_family_rank(mesh, factors_e)
    return b, e, f, w, _decomp_rest_rank(mesh)


def _wide_report(run: dict, outs: list) -> dict:
    """Phase 15 (b), a full-width 2x2 run of DECOMP_WIDE (``run`` its
    undecomposed card step, ``outs`` per rank): every rank converged with
    the same counts and launched the run's variants (and, under the zebra
    stage 2, handed pipeline carries on), the gathered state under the
    undecomposed Newton test; each rank's counts, wall and collectives a
    Newton printed beside the undecomposed step's."""
    label = run["label"]
    want = next(o[2] for o in DECOMP_WIDE if o[0] == label)
    zebra = "zebra" in outs[0]
    print(f"  (b) {label} from {run['dt']:.0f} s split 2x2; undecomposed (newton, fgmres) "
          f"({run['newton']}, {run['fgmres']}), wall {run['wall_s']:.3f} s", flush=True)
    for o in outs:
        n = max(o["newton"], 1)
        print(f"  rank {o['rank']} block {o['block']}: (newton, fgmres) ({o['newton']}, "
              f"{o['fgmres']}), wall {o['wall_s']:.3f} s; per Newton "
              f"{o['stats']['exchanges'] / n:.1f} exchanges, {o['stats']['carries'] / n:.1f} "
              f"pipeline carries, {o['stats']['allreduces'] / n:.1f} all-reduces; variants "
              f"{o['variants']}; launches {o['launches']}"
              + (f"; zebra apply {o['zebra']['apply_ms']:.2f} ms, its two line solves "
                 f"{o['zebra']['line_solves_ms']:.2f} ms ({100 * o['zebra']['share']:.1f}%)"
                 if zebra else ""), flush=True)
    r0 = outs[0]
    fails = [f"rank {o['rank']} ({o['newton']}, {o['fgmres']}, {o['converged']})" for o in outs
             if (o["newton"], o["fgmres"]) != (r0["newton"], r0["fgmres"]) or not o["converged"]]
    fails += [f"rank {o['rank']} launched no {k}" for o in outs for k in want
              if o["variants"].get(k, 0) <= 0]
    fails += [f"rank {o['rank']} launched {k}" for o in outs for k in DECOMP_REFUSED
              if o["launches"][k] != 0]
    if zebra:
        fails += [f"rank {o['rank']} handed no carry on" for o in outs
                  if o["stats"]["carries"] <= 0]
    if fails:
        raise SystemExit(f"phase 15(b) {label}: {fails}")
    gate = _gathered_newton_test(f"(b) {label}", run["case"], run["u0"], outs, run["dt"])
    return {"label": label, "dt": run["dt"], "undecomposed": (run["newton"], run["fgmres"]),
            "undecomposed_wall_s": run["wall_s"], "undecomposed_variants": run["variants"],
            "ranks": [{k: v for k, v in o.items() if k != "u"} for o in outs], **gate}


def decomp_four_ranks(dev, one: dict, refs: dict, wide: list) -> tuple:
    """Phase 15 (b), (e), (f) and (g) over four gloo ranks sharing cuda:0
    (one spawn: each rank takes (b)'s steps, then (e)'s, (f)'s and (g)'s;
    no other process holds the card meanwhile but (c)'s).

    (b): the 2x2 flagship's first step against the one-rank step of (a):
    its counts, kernels and the undecomposed Newton test on the gathered
    state; the largest gap per component printed; then the full-width runs
    of ``wide`` (:func:`decomp_wide_steps`), each by :func:`_wide_report`.

    (e), (f) and (g): :func:`decomp_options_check` and
    :func:`decomp_family_check` against the CPU's runs in ``refs``."""
    from thermalporous_torch.dist.launch import run_ranks

    light = [{k: run[k] for k in ("pc_kw", "dt", "level_factors")} for run in wide]
    outs, _ = run_ranks(_decomp_ranks, DECOMP_RANKS, one["level_factors"],
                        decomp_option_factors(), light, backend="gloo", device="cuda:0")
    print("  (b) the flagship split 2x2", flush=True)
    outs_b = [o[0] for o in outs]
    _ranks_report("(b)", outs_b, (one["newton"], one["fgmres"]), DECOMP_KERNELS)
    gate = _gathered_newton_test("(b)", one["case"], one["u0"], outs_b)
    norm_one = _newton_norm(one["case"], torch.as_tensor(one["u"], device=one["u0"].device),
                            one["u0"])
    gaps = _gaps(outs_b[0]["u"], one["u"])
    print(f"  the one-rank state's Newton norm {norm_one:.6e}; largest gap to the one-rank "
          f"step: p {gaps[0]:.6e} Pa, T {gaps[1]:.6e} K, S {gaps[2]:.6e}", flush=True)
    four = {"ranks": [{k: v for k, v in o.items() if k != "u"} for o in outs_b], "gaps": gaps,
            "newton_norm_one_rank": norm_one, **gate}
    four["wide"] = [_wide_report(run, [o[3][i] for o in outs]) for i, run in enumerate(wide)]
    n_e = len(DECOMP_OPTIONS)
    print(f"  (e) the options the stage-2 and Krylov slice lifted and tp_spe10_inner's "
          f"configuration over 2x2 ranks, {'x'.join(map(str, FLAGSHIP_SMALL))} f64 against "
          f"the CPU", flush=True)
    opt = decomp_options_check([o[1][:n_e] for o in outs], refs, DECOMP_OPTIONS, "(e)")
    print(f"  (f) the weighted and variational transfers, krylov_op='jvp', the adjoint and "
          f"the ensemble over 2x2 ranks, {'x'.join(map(str, FLAGSHIP_SMALL))} f64 against "
          f"the CPU", flush=True)
    fam = decomp_options_check([o[1][n_e:] for o in outs], refs, DECOMP_FAMILY, "(f)")
    fam.update(decomp_family_check([o[2] for o in outs], refs["decomp family"]))
    print(f"  (g) every option the decomposition ran last over 2x2 ranks, "
          f"{'x'.join(map(str, DECOMP_REST_SHAPE))} f64 (owned origins odd) against the CPU",
          flush=True)
    rest = decomp_options_check([o[4] for o in outs], refs, [(o[0], o[5]) for o in DECOMP_REST],
                                "(g)", checks={o[0]: o[6] for o in DECOMP_REST},
                                case_of=_decomp_rest_case, key="decomp rest")
    return four, opt, fam, rest


def _decomp_rest_case(label: str, device, mesh=None):
    """The (case, CPRConfig, NewtonConfig) of DECOMP_REST entry ``label`` at
    DECOMP_REST_SHAPE in f64 on ``device`` (the GMG configurations naming
    ``mesh``)."""
    from thermalporous_torch.presets import get_case

    _, _, pc_kw, gmg_kw, newton_kw, _, _ = next(o for o in DECOMP_REST if o[0] == label)
    case = get_case("tp_spe10_full", device=device, dtype=torch.float64, shape=DECOMP_REST_SHAPE)
    pc = option_config(with_fuse(case.pc_cfg, **SMALL_GMG), pc_kw,
                       dict(gmg_kw, mesh=mesh, replicate_below=DECOMP_REST_REPLICATE,
                            level_factors=DECOMP_REST_FACTORS))
    return case, pc, dataclasses.replace(case.newton_cfg, **newton_kw)


def _decomp_rest_run(label: str, device, mesh=None) -> dict:
    """DECOMP_REST entry ``label``'s run on ``device`` (decomposed over
    ``mesh`` when given): one step of DECOMP_DT, or for the audit two
    steps of it with a ``BalanceAuditor``; (Newton, FGMRES, converged,
    final norm, the state as held, the audit's totals and report)."""
    from thermalporous_torch.dist.sharding import shard_problem_data, shard_state
    from thermalporous_torch.io.balance import BalanceAuditor
    from thermalporous_torch.solve import Simulator

    precond, gate = next((o[1], o[5]) for o in DECOMP_REST if o[0] == label)
    case, pc, newton = _decomp_rest_case(label, device, mesh)
    data, u0 = case.data, case.model.initial_state(case.data)
    if mesh is not None:
        data, u0 = shard_problem_data(data, mesh), shard_state(u0, mesh)
    tc = dataclasses.replace(case.time_cfg, dt_init=DECOMP_DT, dt_max=DECOMP_DT)
    sim = Simulator(case.model, data, precond=precond, pc_cfg=pc, newton_cfg=newton,
                    time_cfg=tc, device=device)
    if gate != "audit":
        u, st = sim.step(u0, DECOMP_DT)
        return {"newton": st.iters, "fgmres": st.ksp_iters, "converged": st.converged,
                "norm": st.norm, "u": u}
    aud = BalanceAuditor(sim.model, data, u0)
    res = sim.run(2 * DECOMP_DT, u0=u0, callback=aud)
    audit = {k: getattr(aud, k) for k in ("m0", "m_last", "cum", "cum_abs", "steps")}
    return {"newton": res.total_newton, "fgmres": res.total_ksp,
            "converged": res.steps == 2 and all(r.retries == 0 for r in res.records),
            "norm": res.records[-1].residual_norm, "u": res.u,
            "audit": dict(audit, report=aud.report())}


def _decomp_rest_rank(mesh) -> list:
    """Phase 15 (g), one rank: each DECOMP_REST run on the 2x2 mesh, its
    counts, launches (their bf16 and batched variants too), collectives
    and wall, and (rank 0) the gathered state."""
    from thermalporous_torch.dist.sharding import gather_state
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts, variant_counts

    out = []
    for label, *_ in DECOMP_REST:
        mesh.barrier()
        reset_launch_counts()
        mesh.reset_stats()
        t = time.perf_counter()
        run = _decomp_rest_run(label, mesh.device, mesh)
        torch.cuda.synchronize()
        rec = dict(run, rank=mesh.rank, wall_s=time.perf_counter() - t,
                   launches=launch_counts(), variants=variant_counts(),
                   by_columns={}, stats=dict(mesh.stats), bgmg_levels=None)
        whole = gather_state(run["u"], mesh)
        rec["u"] = whole.cpu().numpy() if mesh.rank == 0 else None
        out.append(rec)
    return out


def _decomp_rest_cpu(label: str) -> dict:
    """Phase 15 (g), a task of the references' pool: the undecomposed CPU
    run of DECOMP_REST entry ``label``."""
    torch.set_num_threads(2)
    run = _decomp_rest_run(label, "cpu")
    return dict(run, u=run["u"].numpy())


def _decomp_option_case(label: str | None, device, mesh=None, factors=None,
                        newton_kw: dict | None = None):
    """The (case, CPRConfig, NewtonConfig) of DECOMP_OPTIONS or DECOMP_FAMILY
    entry ``label`` (None: the flagship's own, with ``newton_kw``) at
    FLAGSHIP_SMALL in f64 on ``device`` (the GMG configurations naming
    ``mesh``, with the coarsening schedules ``factors`` (p, T) when
    given)."""
    from thermalporous_torch.presets import get_case

    pc_kw, gmg_kw = {}, {}
    if label is not None:
        _, pc_kw, gmg_kw, newton_kw, _ = next(o for o in DECOMP_OPTIONS + DECOMP_FAMILY
                                              if o[0] == label)
    case = get_case("tp_spe10_full", device=device, dtype=torch.float64, shape=FLAGSHIP_SMALL)
    pc = option_config(with_fuse(case.pc_cfg, **SMALL_GMG), pc_kw,
                       dict(gmg_kw, mesh=mesh, replicate_below=DECOMP_OPTIONS_REPLICATE))
    if factors is not None:
        pc = dataclasses.replace(
            pc, gmg=dataclasses.replace(pc.gmg, level_factors=factors[0]),
            gmg_t=None if pc.gmg_t is None else dataclasses.replace(pc.gmg_t,
                                                                   level_factors=factors[1]))
    return case, pc, dataclasses.replace(case.newton_cfg, **(newton_kw or {}))


def decomp_option_factors() -> tuple:
    """Phase 15 (e): the coarsening schedules (p, T) every option runs
    with, planned once on the CPU (no option changes them)."""
    case, pc, newton = _decomp_option_case(DECOMP_OPTIONS[0][0], "cpu")
    pc = case.simulator(pc_cfg=pc, newton_cfg=newton).pc_cfg
    return pc.gmg.level_factors, pc.gmg_t.level_factors


def _decomp_option_rank(mesh, labels, factors) -> list:
    """Phase 15 (e), one rank: each option's first step on the 2x2 mesh,
    its counts, launches (by block columns too), collectives and wall, the
    coupled hierarchy's decomposed level count under bgmg, and (rank 0)
    the gathered state."""
    from thermalporous_torch.dist.sharding import gather_state, shard_problem_data, shard_state
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.precond.cpr import cpr_setup
    from thermalporous_torch.solve import Simulator

    out = []
    for label in labels:
        case, pc, newton = _decomp_option_case(label, mesh.device, mesh, factors)
        data = shard_problem_data(case.data, mesh)
        sim = Simulator(case.model, data, pc_cfg=pc, newton_cfg=newton,
                        time_cfg=case.time_cfg, device=mesh.device)
        u0 = shard_state(case.model.initial_state(case.data), mesh)
        mesh.barrier()
        reset_launch_counts()
        mesh.reset_stats()
        by_cols: dict = {}
        t = time.perf_counter()
        with count_by_columns(by_cols):
            u, st = sim.step(u0, DECOMP_DT)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rec = {"rank": mesh.rank, "newton": st.iters, "fgmres": st.ksp_iters,
               "converged": st.converged, "norm": st.norm, "wall_s": wall,
               "launches": launch_counts(),
               "by_columns": by_cols, "stats": dict(mesh.stats), "bgmg_levels": None}
        if sim.pc_cfg.stage2 == "bgmg":
            stencil = sim.model.assemble_stencil(u0, u0, DECOMP_DT, data)
            rec["bgmg_levels"] = len(cpr_setup(stencil, sim.pc_cfg, block=data.block).bgmg.blocks)
        whole = gather_state(u, mesh)
        rec["u"] = whole.cpu().numpy() if mesh.rank == 0 else None
        out.append(rec)
    return out


def _decomp_option_cpu(label: str) -> dict:
    """Phase 15 (e) and (f), a task of the references' pool: the
    undecomposed CPU step of DECOMP_OPTIONS or DECOMP_FAMILY entry
    ``label``."""
    torch.set_num_threads(2)
    case, pc, newton = _decomp_option_case(label, "cpu", factors=decomp_option_factors())
    u, st = case.simulator(pc_cfg=pc, newton_cfg=newton).step(
        case.model.initial_state(case.data), DECOMP_DT)
    return {"newton": st.iters, "fgmres": st.ksp_iters, "converged": st.converged,
            "u": u.numpy()}


def decomp_options_check(outs: list, refs: dict, options: tuple, tag: str,
                         checks: dict = DECOMP_FAMILY_CHECKS, case_of=None,
                         key: str = "decomp") -> dict:
    """Phase 15 (e), (f) or (g): every entry of ``options`` (label first,
    gate last) run on the four ranks (``outs``, per rank a list in the
    options' order) against the CPU's undecomposed run (``refs[(key,
    label)]``): each rank's (Newton, FGMRES, converged) equal to the CPU's,
    the gathered state within DECOMP_OPTION_P_PA and DECOMP_OPTION_S of it
    (gates "bands" and "audit"; "newton": under the undecomposed Newton
    test of ``case_of(label, "cpu")``'s case), an audit's totals and rows
    within DECOMP_AUDIT_RTOL of the CPU's and every rank's report the
    same, bgmg with its finest level decomposed and B5 at k = 0 and the
    half-sweep launched on every rank, tp_spe10_inner's B1 at nc = 2 and
    B5 at k = 3, ``checks``' launches, the fused subtree on none.  Prints
    a line per option; fails after the last if any failed."""
    case_of = case_of or _decomp_option_case
    count = lambda r, name, kind: (r["variants"].get(name, 0) if kind == "variant"
                                   else r["stats"]["carries"] if kind == "carries"
                                   else r["launches"][name])
    summary, bad = {}, []
    for i, (label, *_, gate) in enumerate(options):
        ranks, ref = [o[i] for o in outs], refs[(key, label)].get(timeout=1200)
        gaps = _gaps(ranks[0]["u"], ref["u"])
        want_counts = (ref["newton"], ref["fgmres"], ref["converged"])
        fails = [f"rank {r['rank']} {(r['newton'], r['fgmres'], r['converged'])}"
                 for r in ranks if (r["newton"], r["fgmres"], r["converged"]) != want_counts]
        extra = ""
        if gate in ("bands", "audit") and not (gaps[0] <= DECOMP_OPTION_P_PA
                                               and gaps[2] <= DECOMP_OPTION_S):
            fails.append(f"gaps {gaps}")
        if gate == "audit":
            a, b = ranks[0]["audit"], ref["audit"]
            scale = np.abs(np.asarray(b["m0"]))
            gap = max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k])) / scale))
                      for k in ("m0", "m_last", "cum", "cum_abs"))
            rows = max(abs(a["report"]["rows"][lab][k] - r[k]) / scale[j]
                       for j, (lab, r) in enumerate(b["report"]["rows"].items())
                       for k in ("delta_in_place", "cum_source", "abs_error"))
            extra = f"; audit gaps: totals {gap:.2e}, rows {rows:.2e} of each in-place total"
            if max(gap, rows) > DECOMP_AUDIT_RTOL or a["steps"] != b["steps"]:
                fails.append(f"audit {gap:.2e} {rows:.2e}")
            fails += [f"rank {r['rank']} audit report" for r in ranks[1:]
                      if r["audit"]["report"] != a["report"]]
        if gate == "newton":
            case, _, ncfg = case_of(label, "cpu")
            u0 = case.model.initial_state(case.data)
            norm0 = _newton_norm(case, u0, u0)
            tol = max(ncfg.rtol * norm0, ncfg.atol, 50.0 * float(torch.finfo(u0.dtype).eps))
            norm = _newton_norm(case, torch.as_tensor(ranks[0]["u"]), u0)
            extra = (f"; the undecomposed Newton test at the gathered state {norm:.6e} (tol "
                     f"{tol:.3e}, the ranks' final norm {ranks[0]['norm']:.6e})")
            if not (norm <= tol and abs(norm - ranks[0]["norm"]) <= DECOMP_NORM_RTOL * norm):
                fails.append(f"Newton test {norm} (tol {tol}, the ranks' {ranks[0]['norm']})")
        if label.startswith("stage2=bgmg"):
            fails += [f"rank {r['rank']} bgmg levels {r['bgmg_levels']}, B5 k=0 "
                      f"{r['by_columns'].get('fused_stage2_rbgs k=0', 0)}, half-sweep "
                      f"{r['launches']['block_rbgs_half_sweep']}"
                      for r in ranks if not (r["bgmg_levels"] >= 1
                                             and r["by_columns"].get("fused_stage2_rbgs k=0", 0) > 0
                                             and r["launches"]["block_rbgs_half_sweep"] > 0)]
        if label == "tp_spe10_inner":
            fails += [f"rank {r['rank']} launched no {k}" for r in ranks
                      for k in DECOMP_INNER_COLUMNS if r["by_columns"].get(k, 0) <= 0]
        for name, kind in checks.get(label, ()):
            fails += [f"rank {r['rank']} {name} {count(r, name, kind)}" for r in ranks
                      if (count(r, name, kind) == 0) != (kind == "none")]
        fails += [f"rank {r['rank']} launched {k}" for r in ranks for k in DECOMP_REFUSED
                  if r["launches"][k] != 0]
        r0, n = ranks[0], max(ranks[0]["newton"], 1)
        print(f"  {tag} {label}: cpu (newton, fgmres, converged) {want_counts}, 2x2 "
              f"{'==' if not fails else '!='} on every rank; gaps p {gaps[0]:.3e} Pa, "
              f"T {gaps[1]:.3e} K, S {gaps[2]:.3e}; rank 0 per Newton "
              f"{r0['stats']['exchanges'] / n:.1f} exchanges, "
              f"{r0['stats']['carries'] / n:.1f} pipeline carries, "
              f"{r0['stats']['allreduces'] / n:.1f} all-reduces, wall {r0['wall_s']:.2f} s; "
              f"launches {r0['launches']}; by columns {r0['by_columns']}"
              + (f"; variants {r0['variants']}" if r0.get("variants") else "")
              + (f"; bgmg decomposed levels {r0['bgmg_levels']}" if r0["bgmg_levels"] is not None
                 else "") + extra + (f"; FAILED: {fails}" if fails else ""), flush=True)
        bad += [label] * bool(fails)
        summary[label] = {"cpu": want_counts, "gaps": gaps, "gate": gate,
                          "ranks": [{k: v for k, v in r.items() if k not in ("u", "audit")}
                                    for r in ranks]}
    if bad:
        raise SystemExit(f"phase 15{tag}: {bad} differ from the CPU")
    return {"options": summary}


def _decomp_family_rank(mesh, factors) -> dict:
    """Phase 15 (f), one rank: the flagship configuration at FLAGSHIP_SMALL,
    f64, with ADJ_NEWTON on the 2x2 mesh: the trajectory over
    DECOMP_ADJ_DTS and its adjoint with phase 13(d)'s objectives (the
    sweep's launches and collectives counted alone); then the ENS_BHP
    ensemble of members decomposed alike, one DECOMP_ENS_DTS step (member 0
    must give the trajectory's first state bit for bit, member 1 its solo
    decomposed step's) and the ensemble adjoint over it.  Rank 0 keeps the
    gathered gradients."""
    from thermalporous_torch.dist import make_ensemble_step_fn, stack_ensemble
    from thermalporous_torch.dist.sharding import gather_state, shard_problem_data, shard_state
    from thermalporous_torch.interop import problem_data_to_numpy
    from thermalporous_torch.kernels import launch_counts, reset_launch_counts
    from thermalporous_torch.models.base import ProblemData
    from thermalporous_torch.solve import (
        Simulator,
        adjoint_gradients,
        ensemble_adjoint_gradients,
        make_step_fn,
        record_ensemble_trajectory,
        record_trajectory,
    )

    case, pc, newton = _decomp_option_case(None, mesh.device, mesh, factors, ADJ_NEWTON)
    terminal, running = adj_objectives()
    data = shard_problem_data(case.data, mesh)
    blk = data.block
    sim = Simulator(case.model, data, pc_cfg=pc, newton_cfg=newton, time_cfg=case.time_cfg,
                    device=mesh.device)
    sweep = dict(pc_cfg=sim.pc_cfg, rtol=ADJ_RTOL_SMALL, maxiter=ADJ_MAXITER)
    whole = lambda f: problem_data_to_numpy(ProblemData(blk.gather(blk.owned(f, lead=1),
                                                                   lead=1)))
    mesh.barrier()
    t = time.perf_counter()
    states = record_trajectory(sim, shard_state(case.model.initial_state(case.data), mesh),
                               list(DECOMP_ADJ_DTS))
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t
    reset_launch_counts()
    mesh.reset_stats()
    t = time.perf_counter()
    res = adjoint_gradients(case.model, data, states, list(DECOMP_ADJ_DTS), terminal=terminal,
                            running=running, **sweep)
    torch.cuda.synchronize()
    adj = {"record_s": record_s, "wall_s": time.perf_counter() - t, "launches": launch_counts(),
           "stats": dict(mesh.stats), "value": float(res.value), "step_iters": res.step_iters,
           "converged": res.converged}
    grad, grad_u0 = whole(res.grad_data.fields), gather_state(res.grad_u0, mesh)
    if mesh.rank == 0:
        adj.update(grad=grad, grad_u0=grad_u0.cpu().numpy())
    members = [shard_problem_data(d, mesh) for d in ensemble_members(case)]
    data_e = stack_ensemble(members)
    step_e = make_ensemble_step_fn(case.model, "cptr", newton, sim.pc_cfg, device=mesh.device)
    u0_e = torch.stack([shard_state(case.model.initial_state(case.data), mesh)
                        for _ in members])
    t = time.perf_counter()
    states_e = record_ensemble_trajectory(step_e, u0_e, list(DECOMP_ENS_DTS), data_e)
    solo, _ = make_step_fn(case.model, "cptr", newton, sim.pc_cfg, device=mesh.device)(
        u0_e[1].clone(), DECOMP_ENS_DTS[0], members[1])
    bitwise = [torch.equal(states_e[1][0], states[1]), torch.equal(states_e[1][1], solo)]
    res_e = ensemble_adjoint_gradients(case.model, data_e, states_e, list(DECOMP_ENS_DTS),
                                       terminal=terminal, running=running, **sweep)
    torch.cuda.synchronize()
    ens = {"wall_s": time.perf_counter() - t, "bitwise": bitwise,
           "value": res_e.value.cpu().tolist(), "step_iters": res_e.step_iters,
           "ksp_iters": res_e.ksp_iters, "converged": res_e.converged}
    grads = [whole(f) for f in res_e.grad_data.fields]
    if mesh.rank == 0:
        ens["grads"] = grads
    return {"rank": mesh.rank, "adjoint": adj, "ensemble": ens}


def _decomp_family_cpu() -> dict:
    """Phase 15 (f), a task of the references' pool: the undecomposed CPU
    sweeps of :func:`_decomp_family_rank`'s adjoint and ensemble adjoint."""
    from thermalporous_torch.dist import make_ensemble_step_fn, stack_ensemble
    from thermalporous_torch.interop import problem_data_to_numpy
    from thermalporous_torch.models.base import ProblemData
    from thermalporous_torch.solve import (
        adjoint_gradients,
        ensemble_adjoint_gradients,
        record_ensemble_trajectory,
        record_trajectory,
    )

    torch.set_num_threads(2)
    t = time.perf_counter()
    case, pc, newton = _decomp_option_case(None, "cpu", factors=decomp_option_factors(),
                                           newton_kw=ADJ_NEWTON)
    terminal, running = adj_objectives()
    sim = case.simulator(pc_cfg=pc, newton_cfg=newton)
    sweep = dict(pc_cfg=sim.pc_cfg, rtol=ADJ_RTOL_SMALL, maxiter=ADJ_MAXITER)
    states = record_trajectory(sim, case.model.initial_state(case.data), list(DECOMP_ADJ_DTS))
    res = adjoint_gradients(case.model, case.data, states, list(DECOMP_ADJ_DTS),
                            terminal=terminal, running=running, **sweep)
    members = ensemble_members(case)
    step_e = make_ensemble_step_fn(case.model, "cptr", newton, sim.pc_cfg, device="cpu")
    data_e = stack_ensemble(members)
    states_e = record_ensemble_trajectory(
        step_e, torch.stack([case.model.initial_state(case.data) for _ in members]),
        list(DECOMP_ENS_DTS), data_e)
    res_e = ensemble_adjoint_gradients(case.model, data_e, states_e, list(DECOMP_ENS_DTS),
                                       terminal=terminal, running=running, **sweep)
    return {"value": float(res.value), "step_iters": res.step_iters, "converged": res.converged,
            "grad": problem_data_to_numpy(res.grad_data), "grad_u0": res.grad_u0.numpy(),
            "ens_value": res_e.value.tolist(), "ens_step_iters": res_e.step_iters,
            "ens_ksp_iters": res_e.ksp_iters, "ens_converged": res_e.converged,
            "ens_grads": [problem_data_to_numpy(ProblemData(f)) for f in res_e.grad_data.fields],
            "s": time.perf_counter() - t}


def decomp_family_check(outs: list, pending) -> dict:
    """Phase 15 (f): the 2x2 adjoint and ensemble (``outs``, per rank)
    against the CPU's undecomposed sweeps (``pending``): every rank's
    FGMRES counts per backward step the CPU's and converged, J and every
    gradient within ADJ_GRAD_TOL of the CPU's, the scalar matvec, smooth
    and stage 2 launched on every rank in the sweep; ensemble member 0 bitwise the
    solo trajectory's step and member 1 its solo decomposed step, the
    lockstep count the CPU's, each member's gradients within
    ADJ_GRAD_TOL."""
    cpu = pending.get(timeout=1200)
    a0, e0 = outs[0]["adjoint"], outs[0]["ensemble"]
    fails = [f"rank {o['rank']} adjoint {o['adjoint']['step_iters']}"
             for o in outs if o["adjoint"]["step_iters"] != cpu["step_iters"]
             or not o["adjoint"]["converged"]]
    gap = _grad_gap(a0["grad"], cpu["grad"])
    u0_gap = float(np.abs(a0["grad_u0"] - cpu["grad_u0"]).max() / np.abs(cpu["grad_u0"]).max())
    j_gap = abs(a0["value"] - cpu["value"]) / abs(cpu["value"])
    if not cpu["converged"] or max(gap, u0_gap, j_gap) > ADJ_GRAD_TOL:
        fails.append(f"adjoint gaps {gap:.2e} {u0_gap:.2e} {j_gap:.2e}")
    # the CPTR kernels on the transposed decomposed hierarchy, on every rank
    fails += [f"rank {o['rank']} adjoint launched no {k}" for o in outs
              for k in ("matvec", "chebyshev_smooth", "fused_stage2_rbgs")
              if o["adjoint"]["launches"][k] <= 0]
    n = max(sum(a0["step_iters"]), 1)
    print(f"  (f) the adjoint, dts {list(DECOMP_ADJ_DTS)}: J cpu {cpu['value']:.12e} 2x2 "
          f"{a0['value']:.12e}; FGMRES per backward step cpu {cpu['step_iters']} 2x2 "
          f"{a0['step_iters']}; gradient gaps: leaves {gap:.2e}, grad_u0 {u0_gap:.2e}, J "
          f"{j_gap:.2e}; rank 0 sweep {a0['wall_s']:.2f} s (trajectory {a0['record_s']:.2f} s), "
          f"per FGMRES iteration {a0['stats']['exchanges'] / n:.1f} exchanges, "
          f"{a0['stats']['allreduces'] / n:.1f} all-reduces; the sweep's launches "
          f"{a0['launches']}; the CPU's sweeps {cpu['s']:.1f} s", flush=True)
    fails += [f"rank {o['rank']} ensemble bitwise {o['ensemble']['bitwise']}, lockstep "
              f"{o['ensemble']['ksp_iters']}" for o in outs
              if not all(o["ensemble"]["bitwise"]) or not o["ensemble"]["converged"]
              or o["ensemble"]["ksp_iters"] != cpu["ens_ksp_iters"]]
    egap = max(_grad_gap(g, c) for g, c in zip(e0["grads"], cpu["ens_grads"]))
    ej = max(abs(a - b) / abs(b) for a, b in zip(e0["value"], cpu["ens_value"]))
    if max(egap, ej) > ADJ_GRAD_TOL:
        fails.append(f"ensemble adjoint gaps {egap:.2e} {ej:.2e}")
    print(f"  (f) the ensemble of {len(ENS_BHP)} decomposed members, dts "
          f"{list(DECOMP_ENS_DTS)}: member 0 bitwise the solo trajectory's step, member 1 "
          f"its solo decomposed step: {e0['bitwise']}; the ensemble adjoint's lockstep FGMRES "
          f"cpu {cpu['ens_ksp_iters']} 2x2 {e0['ksp_iters']}, gradient gaps {egap:.2e}, J "
          f"{ej:.2e}; rank 0 {e0['wall_s']:.2f} s" + (f"; FAILED: {fails}" if fails else ""),
          flush=True)
    if fails:
        raise SystemExit(f"phase 15(f): {fails}")
    return {"adjoint": {k: v for k, v in a0.items() if k not in ("grad", "grad_u0")},
            "adjoint_gaps": [gap, u0_gap, j_gap], "adjoint_cpu_iters": cpu["step_iters"],
            "ensemble": {k: v for k, v in e0.items() if k != "grads"},
            "ensemble_gaps": [egap, ej], "ensemble_cpu_ksp": cpu["ens_ksp_iters"],
            "cpu_s": cpu["s"]}


def decomp_dryrun_start():
    """Phase 15 (c), started: ``python -m thermalporous_torch.dist.dryrun``
    over four gloo ranks on the card (f64), in a subprocess."""
    return subprocess.Popen(
        [sys.executable, "-m", "thermalporous_torch.dist.dryrun", "--ranks", str(DECOMP_RANKS),
         "--backend", "gloo", "--device", "cuda"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(pathlib.Path(__file__).resolve().parent))


def decomp_dryrun_finish(proc) -> dict:
    """Phase 15 (c): the dry run's output and summary; it must exit 0."""
    t = time.perf_counter()
    out = proc.communicate(timeout=600)[0]
    for line in out.splitlines():
        if line.startswith("dryrun_multichip"):
            print("  " + line, flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"phase 15(c): the dry run exited {proc.returncode}:\n{out[-3000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    summary["waited_s"] = time.perf_counter() - t
    return summary


# ------------------------------ the CPU's references of phases 5 and 8-15

# the CPU's side of every GPU-against-CPU check of phases 5 and 8-15,
# computed in a pool of REF_WORKERS processes started before phase 5 (each
# task sets its own threads; those of phases 10-15 are submitted at phase
# 10, so that phases 6-9 are timed beside an idle pool): no phase waits for
# its CPU run, and the host keeps cores for the card's processes
REF_WORKERS = 3
# phase 14(c), (d): the example drivers' arguments
EXAMPLE_CLIS = (("iteration_study", ("--steps", str(STUDY_STEPS))),
                ("custom_case", ("--days", str(CUSTOM_DAYS))))


def _example_cpu_task(name: str) -> tuple:
    """Phase 14(c) or (d), a task of the references' pool: ``python -m
    thermalporous_torch.<name>`` with EXAMPLE_CLIS' arguments and
    ``--device cpu``: (exit code, stdout, stderr)."""
    import os

    args = dict(EXAMPLE_CLIS)[name]
    sub = subprocess.run([sys.executable, "-m", f"thermalporous_torch.{name}", *args,
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=1200, env=dict(os.environ, OMP_NUM_THREADS=str(P14_THREADS)))
    return sub.returncode, sub.stdout, sub.stderr


def cpu_refs_start(want) -> dict:
    """The references' pool, started, with the CPU runs of the count
    checks of phases 5, 8 and 9 that ``want`` takes.  Returns {"pool":
    pool, key: async result}."""
    import multiprocessing

    refs = {"pool": multiprocessing.get_context("spawn").Pool(REF_WORKERS)}
    for phase_k, keys in ((5, ("flagship", "flagship sweeps=2")), (8, ("sp_hot_injection_2d",)),
                          (9, ("flagship jvp",))):
        for key in keys if want(phase_k) else ():
            refs[("counts", key)] = refs["pool"].apply_async(_counts_cpu_task, (key,))
    return refs


def cpu_refs_later(refs: dict, want) -> None:
    """Every CPU run of the phases ``want`` takes among 10-15, submitted to
    the references' pool ``refs`` in the order the phases need them: phase
    10(c)'s options (or those phases 12 and 13 run themselves when 10 does
    not), 11(b) and (c)'s runs, 13(d)'s small adjoint, 14(b)'s ensemble
    adjoint, (c)'s and (d)'s drivers and the custom case, 15(e), (f) and
    (g)'s runs."""
    def put(key, fn, *args):
        refs[key] = refs["pool"].apply_async(fn, args)

    labels = ({o[0] for o in SOLVER_OPTIONS} if want(10)
              else set(PC12_OPTIONS if want(12) else ()) | set(P13_OPTIONS if want(13) else ()))
    for i, o in enumerate(SOLVER_OPTIONS):
        if o[0] in labels:
            put(("option", i), _option_task, (i, "cpu"))
    if want(11):
        for kind in ("blocked cpu", "schedule cpu"):
            put(kind, _phase11_task, kind, 1)
    if want(13):
        put("adjoint small", _adjoint_small_task, ("cpu", None, False))
    if want(14):
        put("ensemble adjoint", _ensemble_adjoint_task, "cpu")
        put("custom", _custom_case_task, "cpu")
        for name, _ in EXAMPLE_CLIS:
            put(("example", name), _example_cpu_task, name)
    if want(15):
        for o in DECOMP_OPTIONS + DECOMP_FAMILY:
            put(("decomp", o[0]), _decomp_option_cpu, o[0])
        put("decomp family", _decomp_family_cpu)
        for o in DECOMP_REST:
            put(("decomp rest", o[0]), _decomp_rest_cpu, o[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the full record to this path")
    ap.add_argument("--phases", help="comma-separated phases to run after 0 and 1 "
                    "(default: all; a partial run prints no ok line)")
    args = ap.parse_args()
    phases = None if args.phases is None else {int(k) for k in args.phases.split(",")}
    want = lambda k: phases is None or k in phases

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
        if line.startswith("==") or "error" in line.lower():
            print("  " + line.strip())
    ptxas = ptxas_summary(log)
    for kernel, regs, st_bytes, ld_bytes in ptxas:
        print(f"  ptxas {kernel}: {regs} registers, spills {st_bytes} B stored "
              f"{ld_bytes} B loaded")
    phase("1 build", t0, f"nvcc {secs:.1f} s -> {path}")

    # (2) kernel parity at the main paths' shapes
    if want(2):
        t0 = time.perf_counter()
        krec, fuse_times, barriers = kernel_parity(dev)
        phase("2 kernel parity", t0, "all kernels within tolerance")

    # (3) slice parity, GPU against CPU
    if want(3):
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
    if want(4):
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

    # the CPU's references of phases 5 and 8-15, computed from here on
    refs = cpu_refs_start(want) if any(want(k) for k in (5, *range(8, 16))) else None

    # (5) flagship parity, GPU against CPU
    if want(5):
        t0 = time.perf_counter()
        small = flagship_parity(refs)
        print(f"  stage2_sweeps=2:", flush=True)
        small2 = flagship_parity(refs, stage2_sweeps=2)
        phase("5 flagship parity", t0, f"{'x'.join(map(str, FLAGSHIP_SMALL))} f64 "
              f"(dt, newton, fgmres, retries) per step: cpu {small['cpu']} == cuda "
              f"{small['cuda']}; with stage2_sweeps=2 cpu {small2['cpu']} == cuda "
              f"{small2['cuda']}")

    # (6) the flagship
    if want(6):
        t0 = time.perf_counter()
        frecs, launches, attempts, fcu_s, peak = flagship_run(dev)
        phase("6 flagship", t0, f"60x220x85 f32: {fcu_s:.1f} cell-updates/s over steps "
              f"2-{len(frecs)}; peak mem {peak:.2f} GiB")

    # (7) where the flagship's time goes
    if want(7):
        t0 = time.perf_counter()
        layers = flagship_layers(dev)
        phase("7 flagship layers", t0, "60x220x85 f32, synchronized layer timers")

    # (8) the single-phase family
    if want(8):
        t0 = time.perf_counter()
        sp_small = gpu_cpu_counts("sp_hot_injection_2d", SP_KERNELS, refs)
        print(f"  sp_hot_injection_2d 40x40 f64 (dt, newton, fgmres, retries) per step: "
              f"cpu {sp_small['cpu']} == cuda {sp_small['cuda']}")
        sp_recs, sp_launches, sp_cu_s, sp_rates = sp_geothermal_run(dev, SP_GEO_STEPS)
        phase("8 single-phase", t0, f"sp_geothermal_3d 64x64x32 f32: {sp_cu_s:.1f} "
              f"cell-updates/s over steps 2-{len(sp_recs)}")

    # (9) the matrix-free Krylov operator
    if want(9):
        t0 = time.perf_counter()
        small_jvp = flagship_parity(refs, "jvp")
        print(f"  flagship {'x'.join(map(str, FLAGSHIP_SMALL))} f64 jvp (dt, newton, fgmres, "
              f"retries) per step: cpu {small_jvp['cpu']} == cuda {small_jvp['cuda']}")
        # both operators' flagship steps in turns, within this one process
        turns, first = [], {}
        for op in OPERATOR_TURNS:
            print(f"  flagship, krylov_op={op!r}:")
            recs_op, launches_op, _, cu_op, _ = flagship_run(dev, JVP_STEPS, op)
            turns.append({"krylov_op": op, "wall_s": [r.wall_s for r in recs_op],
                          "counts": [(r.dt, r.newton_iters, r.ksp_iters) for r in recs_op],
                          "cell_updates_per_s": cu_op})
            first.setdefault(op, (recs_op, launches_op, cu_op))
        for t in turns:
            print(f"  turn {t['krylov_op']}: step walls "
                  + ", ".join(f"{w:.3f}" for w in t["wall_s"])
                  + f" s; {t['cell_updates_per_s']:.1f} cell-updates/s over step 2")
        jrecs, jlaunches, jcu_s = first["jvp"]
        stencil_recs = (first["stencil"][0] if "stencil" in first
                        else frecs if want(6) else [])
        for rj, rs in zip(jrecs, stencil_recs):
            print(f"  flagship step {rj.step}: jvp (dt {rj.dt:.1f}, newton {rj.newton_iters}, "
                  f"fgmres {rj.ksp_iters}) | stencil (dt {rs.dt:.1f}, newton {rs.newton_iters}, "
                  f"fgmres {rs.ksp_iters})"
                  + ("" if (rj.dt, rj.newton_iters, rj.ksp_iters)
                     == (rs.dt, rs.newton_iters, rs.ksp_iters) else "  differ"))
        sj_recs, sj_launches, _, _ = sp_geothermal_run(dev, JVP_STEPS, "jvp")
        phase("9 jvp operator", t0, f"flagship jvp {jcu_s:.1f} cell-updates/s "
              f"{over_steps(len(jrecs))}; fused_jvp {jlaunches['fused_jvp']} and fused_jvp_sp "
              f"{sj_launches['fused_jvp_sp']} launches")

    # the CPU's references of phases 10-15, computed from here on
    if refs is not None and any(want(k) for k in range(10, 16)):
        cpu_refs_later(refs, want)

    # (10) the solver options: the W-cycle kernel, tp_spe10_inner, every option
    if want(10):
        t0 = time.perf_counter()
        print("  (a) the W-cycle in the fused subtree", flush=True)
        wrec: dict = {}
        for dtype in (torch.float64, torch.float32):
            tname = "f64" if dtype == torch.float64 else "f32"
            (st, cases), (sst, scases) = w_cycle_cases(dtype, dev)
            run_cases(tname, cases, st, wrec, dtype, record=dtype == torch.float32)
            run_cases(tname, scases, sst, {}, dtype, record=False)
            del st, cases, sst, scases
            torch.cuda.empty_cache()
        print("  (b) tp_spe10_inner", flush=True)
        irec: dict = {}
        irec_pt: dict = {}
        for dtype in (torch.float64, torch.float32):
            tname = "f64" if dtype == torch.float64 else "f32"
            st, pt, cases, pt_cases = inner_cases(dtype, dev)
            run_cases(tname, cases, st, irec, dtype, record=dtype == torch.float32)
            run_cases(tname, pt_cases, pt, irec_pt, dtype, record=dtype == torch.float32)
            del st, pt, cases, pt_cases
            torch.cuda.empty_cache()
        apply_ms = inner_apply_times(dev)
        inner_cols: dict = {}
        irecs, ilaunches, iattempts, icu_s, ipeak = flagship_run(
            dev, INNER_STEPS, name="tp_spe10_inner", by_cols=inner_cols)
        print(f"  tp_spe10_inner launches by block columns: {inner_cols}")
        for key in ("block_matvec nc=3 k=3", "block_matvec nc=2 k=2", "fused_stage2_rbgs k=3"):
            if inner_cols.get(key, 0) <= 0:
                raise SystemExit(f"tp_spe10_inner launched no {key}")
        if want(6):
            for ri, rf in zip(irecs, frecs):
                print(f"  step {ri.step}: tp_spe10_inner (dt {ri.dt:.1f}, newton "
                      f"{ri.newton_iters}, fgmres {ri.ksp_iters}) | tp_spe10_full phase 6 "
                      f"(dt {rf.dt:.1f}, newton {rf.newton_iters}, fgmres {rf.ksp_iters})")
        print("  (c) every solver option, GPU against CPU", flush=True)
        opts = option_runs(refs)
        phase("10 solver options", t0, f"tp_spe10_inner 60x220x85 f32: {icu_s:.1f} "
              f"cell-updates/s {over_steps(len(irecs))}, peak mem {ipeak:.2f} GiB; "
              f"{len(opts)} options GPU == CPU")

    # (11) the run_case path: the CLI, blocked stepping, a control schedule
    if want(11):
        t0 = time.perf_counter()
        print("  (a) run_case on tp_spe10_full, every output on", flush=True)
        cli = cli_flagship(REPO / "out" / "chip_smoke_p11")
        t_a = time.perf_counter() - t0
        print(f"  (a) {t_a:.1f} s; (b) blocked stepping and (c) a control schedule",
              flush=True)
        entry = cli_entry_start()
        try:
            blocked, sched = phase11_parity(refs)
            cli_entry_finish(entry)
        finally:
            if entry.poll() is None:
                entry.kill()
                entry.wait()
        print(f"  (b) {'x'.join(map(str, FLAGSHIP_SMALL))} f64 in blocks of {BLOCK_STEPS} "
              f"(dt, newton, fgmres, retries, consistent): cpu {blocked['cpu']} == cuda "
              f"{blocked['cuda']} == cuda host loop {blocked['host cuda']}")
        print(f"  (c) tp_thermal_2d 60x60 f64 (dt, newton, fgmres, retries): cpu "
              f"{sched['cpu']['records']} == cuda {sched['cuda']['records']}")
        phase("11 run_case path", t0, f"run_case tp_spe10_full f32: {cli['cell_updates_per_s']:.1f} "
              f"cell-updates/s {over_steps(CLI_STEPS)}, checkpoint "
              f"{statistics.median(cli['write_ms']['checkpoint_ms']):.3f} ms, VTK frame "
              f"{statistics.median(cli['write_ms']['vtk_write_ms']):.3f} ms (median), resume "
              f"bitwise; blocked and schedule GPU == CPU")

    # (12) bf16 coefficients and the batched p/T traversal
    if want(12):
        t0 = time.perf_counter()
        print("  (a) the kernels with bf16 coefficients", flush=True)
        brec: dict = {}
        for dtype in (torch.float64, torch.float32):
            tname = "f64" if dtype == torch.float64 else "f32"
            # the f32 form of each case ran in phase 2 (and 10(b)) of this call
            st12, sets = bf16_kernel_cases(dtype, dev, with_f32=not (want(2) and want(10)))
            for cname, cases in sets.items():
                start = len(ROWS)
                run_cases(tname, cases, st12, {}, dtype, record=False)
                if dtype == torch.float32:
                    brec[cname] = _rows_since(start)
            del st12, sets
            torch.cuda.empty_cache()
        print("  (b) tp_spe10_full with pc_dtype='bf16'", flush=True)
        apply12 = pc_dtype_apply_times(dev)
        bvar: dict = {}
        brecs, blaunches, _, bcu_s, bpeak = flagship_run(
            dev, BF16_STEPS, pc_overrides=dict(pc_dtype="bf16"), variants=bvar,
            dt_init=RETRY_DT)
        print(f"  bf16 launches {bvar}; (newton, fgmres, retries) "
              f"{[(r.newton_iters, r.ksp_iters, r.retries) for r in brecs]}"
              + (f" (f32, phase 6: {[(r.newton_iters, r.ksp_iters, r.retries) for r in frecs]})"
                 if want(6) else ""), flush=True)
        for k in ("matvec", "chebyshev_smooth", "fused_stage2_rbgs", "deep_correction"):
            if bvar.get(f"{k} bf16", 0) <= 0:
                raise SystemExit(f"flagship, pc_dtype=bf16: no bf16 {k} launched")
        print("  (c) the bench step with pc_dtype='bf16'", flush=True)
        bench12 = bench_bf16_steps(dev)
        print("  (d) batch_pt", flush=True)
        batch12, st12, cases12 = batch_pt_apply(dev)
        start = len(ROWS)
        run_cases("f32", cases12, st12, {}, torch.float32, record=False)
        batch_rows = _rows_since(start)
        del st12, cases12
        torch.cuda.empty_cache()
        dvar: dict = {}
        # the block-diagonal stage 1 has no T<-p coupling product: no matvec
        drecs, dlaunches, _, dcu_s, dpeak = flagship_run(
            dev, BATCH_STEPS, pc_overrides=BATCH_PT, variants=dvar,
            kernels=tuple(k for k in FLAGSHIP_KERNELS if k != "matvec"))
        print(f"  batched launches {dvar}", flush=True)
        for k in ("chebyshev_smooth", "deep_correction"):
            if dvar.get(f"{k} batched", 0) <= 0:
                raise SystemExit(f"flagship, batch_pt: no batched {k} launched")
        print("  (e) the storage modes and batch_pt, GPU against CPU", flush=True)
        opts12 = ({k: opts[k] for k in PC12_OPTIONS} if want(10)
                  else option_runs(refs, labels=PC12_OPTIONS))
        for label, need in (("pc_dtype=bf16 stage2=jacobi2", "block_matvec bf16"),
                            ("pc_dtype=bf16_s2 sweeps=2", "block_rbgs_half_sweep bf16"),
                            ("batch_pt pc_dtype=bf16 inner", "block_matvec bf16"),
                            ("batch_pt", "deep_correction batched")):
            if (opts12[label]["variants"] or {}).get(need, 0) <= 0:
                raise SystemExit(f"option {label}: no {need} launched")
        pc12 = {"bf16_rows": brec, "apply_ms": apply12,
                "flagship_bf16_steps": [r.as_dict() for r in brecs],
                "flagship_bf16_launches": blaunches, "flagship_bf16_variants": bvar,
                "flagship_bf16_cell_updates_per_s": bcu_s, "flagship_bf16_peak_gib": bpeak,
                "bench_bf16": bench12, "batch_pt": batch12, "batch_rows": batch_rows,
                "flagship_batch_steps": [r.as_dict() for r in drecs],
                "flagship_batch_launches": dlaunches, "flagship_batch_variants": dvar,
                "flagship_batch_cell_updates_per_s": dcu_s, "flagship_batch_peak_gib": dpeak,
                "options": opts12}
        phase("12 pc_dtype and batch_pt", t0, f"flagship bf16 {bcu_s:.1f} cell-updates/s "
              f"{over_steps(len(brecs))}, peak {bpeak:.2f} GiB; batch_pt {dcu_s:.1f} "
              f"{over_steps(len(drecs))}; "
              f"{len(opts12)} options GPU == CPU")

    # (13) transfers, bgmg, recycling, the adjoint
    if want(13):
        t0 = time.perf_counter()
        cli13 = adjoint_cli_start()
        print("  (a) weighted and variational transfers on the flagship's pressure stencil",
              flush=True)
        flag13 = preset_state("tp_spe10_full", torch.float32, dev,
                              dict(fuse_below=FLAGSHIP_FUSE_BELOW))
        tr13 = transfer_cases(dev, flag13)
        print("  (b) tp_spe10_full with stage2='bgmg'", flush=True)
        bgmg13 = bgmg_apply_times(dev, flag13)
        del flag13
        torch.cuda.empty_cache()
        by_level: dict = {}
        g_recs, g_launches, g_attempts, g_cu_s, g_peak = flagship_run(
            dev, BGMG_STEPS, pc_overrides=dict(stage2="bgmg", bgmg_coarse_cells=BGMG_COARSE),
            dt_init=RETRY_DT,
            kernels=FLAGSHIP_KERNELS + ("block_rbgs_half_sweep",),
            counting=count_by_level(by_level))
        print(f"  bgmg launches by level: {by_level}", flush=True)
        print(f"  bgmg (newton, fgmres) {[(r.newton_iters, r.ksp_iters) for r in g_recs]}"
              + (f" (rbgs, phase 6: {[(r.newton_iters, r.ksp_iters) for r in frecs[:BGMG_STEPS]]})"
                 if want(6) else "") + f"; {g_cu_s:.1f} cell-updates/s, peak {g_peak:.2f} GiB",
              flush=True)
        print("  (d) the adjoint", flush=True)
        adj_small = adjoint_small(refs["adjoint small"])
        adj_dts = ([r.dt for r in frecs[:ADJ_FULL_STEPS]] if want(6) else
                   [r.dt for r in flagship_run(dev, ADJ_FULL_STEPS)[0]])
        adj_full = adjoint_full(dev, adj_dts)
        if want(2):
            print(f"  the VJP {adj_full['vjp_ms_per_product']:.3f} ms a transposed product "
                  f"against the J(u)v kernel's {krec['fused_jvp']['ms']:.4f} ms "
                  f"({adj_full['vjp_ms_per_product'] / krec['fused_jvp']['ms']:.0f}x)", flush=True)
        print("  (e) the new options, GPU against CPU", flush=True)
        opts13 = ({k: opts[k] for k in P13_OPTIONS} if want(10)
                  else option_runs(refs, labels=P13_OPTIONS))
        for label, needs in P13_CHECKS.items():
            for key, kind in needs:
                n_l = ((opts13[label]["variants"] or {}).get(key, 0) if kind == "variant"
                       else opts13[label]["launches"][key])
                if (n_l == 0) != (kind == "none"):
                    raise SystemExit(f"option {label}: {key} launched {n_l} times")
        print("  (f) python -m thermalporous_torch.adjoint_study --ascent 1", flush=True)
        cli_adj = adjoint_cli_finish(cli13)
        p13 = {"transfers": tr13,
               "bgmg": bgmg13, "bgmg_steps": [r.as_dict() for r in g_recs],
               "bgmg_launches": g_launches, "bgmg_launches_by_level": by_level,
               "bgmg_newton_all_attempts": g_attempts, "bgmg_cell_updates_per_s": g_cu_s,
               "bgmg_peak_gib": g_peak,
               "adjoint_small": adj_small, "adjoint_full": adj_full, "options": opts13,
               "adjoint_study": cli_adj}
        phase("13 transfers, bgmg, recycling, adjoint", t0,
              f"bgmg {g_cu_s:.1f} cell-updates/s {over_steps(len(g_recs))}; adjoint "
              f"{'x'.join(map(str, FLAGSHIP_SMALL))} GPU == CPU (gaps {adj_small['grad_gap']:.1e}), "
              f"FD {adj_small['fd_rel']:.1e}; full size {adj_full['wall_per_step_s']:.2f} s a "
              f"backward step; {len(opts13)} options GPU == CPU; CLI FD {cli_adj['fd_rel']:.1e}")

    # (14) the ensemble axis, the ensemble adjoint and the example drivers
    if want(14):
        t0 = time.perf_counter()
        print("  (a) tp_spe10_full, a well-control ensemble of "
              f"{len(ENS_BHP)} members, one {ENS_DT:.0f} s step", flush=True)
        ex14: dict = {}
        try:
            ens14 = ensemble_small(dev, after_ensemble=lambda: ex14.update(examples_start()))
            t_a = time.perf_counter() - t0
            print(f"  ensemble {ens14['wall_s']:.3f} s, {ens14['cell_updates_per_s']:.1f} "
                  f"cell-updates/s over the members' Newton, peak {ens14['peak_gib']:.2f} "
                  f"GiB; launches {ens14['launches']}", flush=True)
            print("  (b) the ensemble adjoint", flush=True)
            adj14 = ensemble_adjoint(refs["ensemble adjoint"])
            t_b = time.perf_counter() - t0 - t_a
            print("  (c) iteration_study and (d) custom_case, GPU against CPU", flush=True)
            cli14 = examples_finish(ex14, refs)
        finally:
            examples_stop(ex14)
        p14 = {"ensemble": ens14, "ensemble_adjoint": adj14, "examples": cli14,
               "a_s": t_a, "b_s": t_b}
        phase("14 ensemble and examples", t0, f"ensemble of {len(ENS_BHP)} at "
              f"{'x'.join(map(str, FLAGSHIP_SMALL))} f32 bitwise its solo steps, {ens14['cell_updates_per_s']:.1f} cell-updates/s; "
              f"ensemble adjoint {'x'.join(map(str, FLAGSHIP_SMALL))} GPU == CPU (gaps "
              f"{max(adj14['gaps']):.1e}), lockstep {adj14['ksp_iters']}; iteration_study and "
              f"custom_case GPU == CPU ((a) {t_a:.1f} s, (b) {t_b:.1f} s)")

    # (15) the grid decomposition
    if want(15):
        t0 = time.perf_counter()
        dry_proc = decomp_dryrun_start()
        try:
            print("  (a) the decomposed path's kernels on an odd-origin block", flush=True)
            blk15 = decomp_kernel_blocks(dev)
            print("  (a) their bf16 and batched forms on the odd-origin block", flush=True)
            var15 = decomp_variant_blocks(dev)
            print("  (a) the flagship's first step on a one-rank NCCL mesh", flush=True)
            one15 = decomp_one_rank(dev)
            torch.cuda.empty_cache()
            print("  (b) the undecomposed card steps of the full-width 2x2 runs", flush=True)
            wide15 = decomp_wide_steps(dev)
            t_a = time.perf_counter() - t0
            print(f"  (b), (e), (f) and (g) over {DECOMP_RANKS} gloo ranks sharing cuda:0, one "
                  f"spawn: the flagship and its bf16 and batch_pt/zebra runs, then the lifted "
                  f"options, the adjoint, the ensemble and every option lifted last, split 2x2",
                  flush=True)
            four15, opt15, fam15, rest15 = decomp_four_ranks(dev, one15, refs, wide15)
            del one15["case"], one15["u0"], wide15
            torch.cuda.empty_cache()
            t_bd = time.perf_counter() - t0 - t_a
            print(f"  (c) dryrun_multichip({DECOMP_RANKS}, device=\"cuda\", backend=\"gloo\"), "
                  f"f64, started with the phase", flush=True)
            dry15 = decomp_dryrun_finish(dry_proc)
        finally:
            if dry_proc.poll() is None:
                dry_proc.kill()
                dry_proc.wait()
        t_c = time.perf_counter() - t0 - t_a - t_bd
        p15 = {"kernel_blocks": blk15, "variant_blocks": var15,
               "one_rank": {k: v for k, v in one15.items() if k != "u"},
               "four_ranks": four15, "dryrun": dry15, "options": opt15, "family": fam15,
               "rest": rest15, "a_s": t_a, "b_e_f_g_s": t_bd, "c_s": t_c}
        r0 = four15["ranks"][0]
        jv = blk15["fused_jvp"]
        phase("15 grid decomposition", t0,
              f"fused_jvp on the odd block within tolerance (f32 {jv['f32']['ms']:.4f} ms, f64 "
              f"{jv['f64']['ms']:.4f} ms); one-rank NCCL mesh bitwise the undecomposed flagship "
              f"step ({one15['newton']}, {one15['fgmres']}); 2x2 over {DECOMP_RANKS} gloo ranks on "
              f"one card ({r0['newton']}, {r0['fgmres']}), its Newton test "
              f"{four15['newton_norm']:.3e} <= {four15['newton_tol']:.1e}, gaps p/T/S "
              f"{'/'.join(f'{g:.3e}' for g in four15['gaps'])}; rank 0 wall "
              f"{r0['wall_s']:.3f} s; dry run "
              f"{dry15['run']['steps']} steps, newton {dry15['run']['newton']}, ksp "
              f"{dry15['run']['ksp']} == undecomposed, resume bitwise; (e) "
              f"{len(opt15['options'])} runs, (f) {len(fam15['options'])} runs and (g) "
              f"{len(rest15['options'])} runs 2x2 f64 == CPU, "
              f"(f) adjoint gaps {max(fam15['adjoint_gaps']):.1e}, ensemble adjoint gaps "
              f"{max(fam15['ensemble_gaps']):.1e}; full width 2x2 "
              + ", ".join(f"{w['label']} ({w['ranks'][0]['newton']}, {w['ranks'][0]['fgmres']})"
                          for w in four15["wide"])
              + f" under the Newton test ((a) {t_a:.1f} s, (b), (e), (f) and (g) "
              f"{t_bd:.1f} s, (c) {t_c:.1f} s more)")

    if refs is not None:
        refs["pool"].close()
        refs["pool"].join()
    if phases is not None:
        if args.json:
            part = {"device": smi, "kernel_rows": ROWS, "ptxas": ptxas,
                    "total_s": time.perf_counter() - t_all}
            if want(12):
                part.update(pc_dtype_batch_pt=pc12)
            if want(13):
                part.update(transfers_bgmg_recycle_adjoint=p13)
            if want(14):
                part.update(ensemble_examples=p14)
            if want(15):
                part.update(decomposition=p15)
            if want(2):
                part.update(fuse_apply_ms=fuse_times, barrier_latencies=barriers)
            if want(10):
                part.update(w_cycle_cases=wrec, line_smoother_ms=LINE_TIMES,
                            inner_cases=irec, inner_pt_cases=irec_pt,
                            inner_steps=[r.as_dict() for r in irecs], inner_apply_ms=apply_ms,
                            inner_launches=ilaunches, inner_launches_by_columns=inner_cols,
                            inner_cell_updates_per_s=icu_s, inner_peak_gib=ipeak,
                            solver_options=opts)
            if want(11):
                part.update(cli=cli, blocked=blocked, schedule=sched)
            with open(args.json, "w") as fh:
                json.dump(part, fh, indent=1)
        print(f"partial run (phases {sorted(phases)}): no kernels line, no ok line")
        return 0

    # each kernel's launches in its path's run
    path_launches = {k: launches[k] for k in FLAGSHIP_KERNELS}
    path_launches.update(block_rbgs_half_sweep=small2["launches"]["block_rbgs_half_sweep"],
                         fused_residual_sp=sp_launches["fused_residual_sp"],
                         fused_jvp=jlaunches["fused_jvp"],
                         fused_jvp_sp=sj_launches["fused_jvp_sp"])
    kernels = [{"name": k, "route": "cuda", "source": KERNEL_SOURCES[k][0],
                "replaces": KERNEL_SOURCES[k][1], "launches": path_launches[k],
                "max_abs_err": krec[k]["max_abs_err"], "ms": krec[k]["ms"],
                "plain_ms": krec[k]["plain_ms"], "bound_ms": krec[k]["bound_ms"],
                "bound_by": krec[k]["bound_by"], "library_ms": krec[k]["library_ms"]}
               for k in KERNEL_SOURCES]
    # phase 10: the W-cycle form of the subtree (its launches in the W
    # option's run of phase 10(c)), and tp_spe10_inner's kernels (launches in
    # phase 10(b); the shapes that path adds measured in phase 10, the others
    # are phase 2's flagship records)
    inner = [("deep_correction (W-cycle)", "deep_correction", wrec["deep_correction"],
              opts["W fused"]["launches"]["deep_correction"])]
    for k in ("matvec", "chebyshev_smooth", "fused_residual"):
        inner.append((f"{k} (tp_spe10_inner)", k, krec[k], ilaunches[k]))
    inner += [("block_matvec nc=3 (tp_spe10_inner)", "block_matvec", krec["block_matvec"],
               inner_cols["block_matvec nc=3 k=3"]),
              ("block_matvec nc=2 (tp_spe10_inner)", "block_matvec", irec_pt["block_matvec"],
               inner_cols["block_matvec nc=2 k=2"]),
              ("fused_stage2_rbgs k=3 (tp_spe10_inner)", "fused_stage2_rbgs",
               irec["fused_stage2_rbgs"], inner_cols["fused_stage2_rbgs k=3"]),
              ("deep_correction (tp_spe10_inner)", "deep_correction", irec["deep_correction"],
               ilaunches["deep_correction"])]
    # phase 12: the bf16 instantiations (f32 vectors, the flagship's shapes;
    # launches in the bf16 flagship run, the bf16 bench step and the
    # options that reach them) and the batched ones (launches in the
    # batch_pt flagship run)
    gs = "x".join(map(str, SPE10_FULL))
    row = lambda label: brec["bf16"][label]
    inner += [
        ("block_matvec (bf16 coefficients)", "block_matvec",
         row(f"block_matvec nc=3 k=2 bf16 coefficients {gs}"),
         bench12["variants"]["block_matvec bf16"]),
        ("block_matvec nc=2 (bf16 coefficients)", "block_matvec",
         row(f"block_matvec nc=k=2 (p, T) bf16 coefficients {gs}"),
         opts12["batch_pt pc_dtype=bf16 inner"]["variants"]["block_matvec bf16"]),
        ("matvec (bf16 coefficients)", "matvec", row(f"matvec T<-p bf16 coefficients {gs}"),
         bvar["matvec bf16"]),
        ("chebyshev_smooth (bf16 coefficients)", "chebyshev_smooth",
         row(f"chebyshev fine bf16 coefficients deg=4 x0 {gs}"), bvar["chebyshev_smooth bf16"]),
        ("fused_stage2_rbgs (bf16 coefficients)", "fused_stage2_rbgs",
         row(f"fused_stage2_rbgs k=2 bf16 coefficients {gs}"), bvar["fused_stage2_rbgs bf16"]),
        ("block_rbgs_half_sweep (bf16 coefficients)", "block_rbgs_half_sweep",
         row(f"block_rbgs_half_sweep red bf16 coefficients {gs}"),
         opts12["pc_dtype=bf16_s2 sweeps=2"]["variants"]["block_rbgs_half_sweep bf16"]),
        ("deep_correction (bf16 coefficients)", "deep_correction",
         next(r for c, r in brec["bf16"].items() if c.startswith("deep_correction p")),
         bvar["deep_correction bf16"]),
        ("chebyshev_smooth (batch_pt)", "chebyshev_smooth",
         next(r for c, r in batch_rows.items() if c.startswith("chebyshev batch_pt")),
         dvar["chebyshev_smooth batched"]),
        ("deep_correction (batch_pt)", "deep_correction",
         next(r for c, r in batch_rows.items() if c.startswith("deep_correction batch_pt")),
         dvar["deep_correction batched"]),
    ]
    # phase 13: the stage-2 kernel at k = 0 and the half-sweep as the bgmg
    # levels run them (launches at that level in phase 13(b)'s run; the
    # finest level's rows are phase 2's flagship ones, the coarse levels'
    # phase 2's random-stencil rows at those shapes), and the CPTR kernels
    # on the transposed hierarchy of the full-size adjoint (phase 2's
    # flagship rows; launches in phase 13(d)'s sweep)
    row_of = lambda case: next(r for r in ROWS if r["dtype"] == "f32" and r["case"] == case)
    for g in ((60, 220, 85), (8, 28, 11), (4, 14, 6)):
        gs13 = "x".join(map(str, g))
        lab = "no x1" if g == (60, 220, 85) else "random nc=3"
        hlab = "flagship" if g == (60, 220, 85) else "random nc=3"
        inner += [(f"fused_stage2_rbgs k=0 (bgmg level {gs13})", "fused_stage2_rbgs",
                   row_of(f"fused_stage2_rbgs k=0 {lab} {gs13}"),
                   by_level.get(f"fused_stage2_rbgs {gs13}", 0)),
                  (f"block_rbgs_half_sweep (bgmg level {gs13})", "block_rbgs_half_sweep",
                   row_of(f"block_rbgs_half_sweep red {hlab} {gs13}"),
                   by_level.get(f"block_rbgs_half_sweep {gs13}", 0))]
    for k in ("chebyshev_smooth", "matvec", "deep_correction", "fused_stage2_rbgs"):
        inner.append((f"{k} (adjoint, transposed hierarchy)", k, krec[k],
                      adj_full["launches"][k]))
    # phase 14: the flagship's kernels on the ensemble's path (phase 2's
    # flagship records; launches in phase 14(a)'s ensemble step at 12x22x9)
    for k in FLAGSHIP_KERNELS:
        inner.append((f"{k} (ensemble of {len(ENS_BHP)}, 12x22x9)", k, krec[k],
                      ens14["launches"][k]))
    # phase 15: the flagship's kernels on the 2x2 decomposed path (phase 2's
    # flagship records; launches on rank 0 in phase 15(b)'s step)
    for k in DECOMP_KERNELS:
        inner.append((f"{k} (2x2 decomposition, rank 0)", k, krec[k],
                      p15["four_ranks"]["ranks"][0]["launches"][k]))
    # phase 15(e): tp_spe10_inner's kernels on the 2x2 path (phase 2's and
    # phase 10(b)'s records at the flagship's shapes; launches on rank 0 of
    # (e)'s run of its configuration at 12x22x9 in f64), and the red-black
    # kernels the lifted options add there (phase 2's flagship records of
    # the stage 2 at k = 0 and the half-sweep; launches on rank 0 of (e)'s
    # bgmg and two-sweep runs)
    d0 = p15["options"]["options"]["tp_spe10_inner"]["ranks"][0]
    cols, dl = d0["by_columns"], d0["launches"]
    inner += [("block_matvec nc=3 (2x2 tp_spe10_inner, rank 0)", "block_matvec",
               krec["block_matvec"], cols.get("block_matvec nc=3 k=3", 0)),
              ("block_matvec nc=2 (2x2 tp_spe10_inner, rank 0)", "block_matvec",
               irec_pt["block_matvec"], cols.get("block_matvec nc=2 k=2", 0)),
              ("fused_stage2_rbgs k=3 (2x2 tp_spe10_inner, rank 0)", "fused_stage2_rbgs",
               irec["fused_stage2_rbgs"], cols.get("fused_stage2_rbgs k=3", 0))]
    for k in ("matvec", "chebyshev_smooth", "fused_residual"):
        inner.append((f"{k} (2x2 tp_spe10_inner, rank 0)", k, krec[k], dl[k]))
    # phase 15(f): B7 under krylov_op="jvp" over 2x2 (phase 15(a)'s f32 row
    # on the odd-origin extended block; launches on rank 0 of (f)'s jvp
    # run), and the CPTR kernels on the transposed decomposed hierarchy of
    # (f)'s adjoint (phase 2's flagship records; launches on rank 0 in the
    # sweep alone)
    jv = p15["kernel_blocks"]["fused_jvp"]["f32"]
    inner.append(("fused_jvp (2x2 krylov_op=jvp, rank 0)", "fused_jvp", jv,
                  p15["family"]["options"]["krylov_op=jvp"]["ranks"][0]["launches"]["fused_jvp"]))
    # phase 15, PR 15: the bf16 and batched forms on the decomposed path
    # (15(a)'s f32 rows on the odd-origin extended block; the bf16
    # half-sweep phase 12's flagship row), launches on rank 0 of the
    # full-width 2x2 runs of (b) and of (g)'s runs at 14x14x9 f64
    vb = p15["variant_blocks"]["f32"]
    vrow = lambda prefix: next(r for c, r in vb.items() if c.startswith(prefix))
    wide_r0 = {w["label"]: w["ranks"][0]["variants"] for w in p15["four_ranks"]["wide"]}
    rest_r0 = {lab: o["ranks"][0]["variants"] for lab, o in p15["rest"]["options"].items()}
    bf_w, bat_w = wide_r0[DECOMP_WIDE[0][0]], wide_r0[DECOMP_WIDE[1][0]]
    bf_g, bat_g = rest_r0["pc_dtype=bf16 stage2_sweeps=2"], rest_r0["batch_pt"]
    for label, k, r, var in (
            ("block_matvec nc=3 k=2 (bf16 coefficients", "block_matvec",
             vrow("block_matvec nc=3 k=2 bf16"), "block_matvec bf16"),
            ("matvec T<-p (bf16 coefficients", "matvec", vrow("matvec T<-p bf16"), "matvec bf16"),
            ("chebyshev_smooth (bf16 coefficients", "chebyshev_smooth",
             vrow("chebyshev+residual fine bf16"), "chebyshev_smooth bf16"),
            ("fused_stage2_rbgs k=2 (bf16 coefficients, odd parity", "fused_stage2_rbgs",
             vrow("fused_stage2_rbgs k=2 bf16"), "fused_stage2_rbgs bf16"),
            ("block_rbgs_half_sweep (bf16 coefficients", "block_rbgs_half_sweep",
             row(f"block_rbgs_half_sweep red bf16 coefficients {gs}"),
             "block_rbgs_half_sweep bf16")):
        inner += [(f"{label}, 2x2 full width, rank 0)", k, r, bf_w.get(var, 0)),
                  (f"{label}, 2x2 14x14x9, rank 0)", k, r, bf_g.get(var, 0))]
    batched = vrow("chebyshev batch_pt")
    inner += [("chebyshev_smooth (batch_pt, 2x2 full width, rank 0)", "chebyshev_smooth", batched,
               bat_w.get("chebyshev_smooth batched", 0)),
              ("chebyshev_smooth (batch_pt, 2x2 14x14x9, rank 0)", "chebyshev_smooth", batched,
               bat_g.get("chebyshev_smooth batched", 0))]
    adj_l = p15["family"]["adjoint"]["launches"]
    for k in ("matvec", "chebyshev_smooth", "fused_stage2_rbgs"):
        inner.append((f"{k} (2x2 adjoint, transposed hierarchy, rank 0)", k, krec[k], adj_l[k]))
    e_bgmg = p15["options"]["options"]["stage2=bgmg inner richardson"]["ranks"][0]
    e_sweeps = p15["options"]["options"]["stage2=rbgs sweeps=2 s_stage=rbgs"]["ranks"][0]
    k0_row = row_of(f"fused_stage2_rbgs k=0 no x1 {gs}")
    half_row = row_of(f"block_rbgs_half_sweep red flagship {gs}")
    inner += [("fused_stage2_rbgs k=0 (2x2 bgmg levels, rank 0)", "fused_stage2_rbgs",
               k0_row, e_bgmg["by_columns"].get("fused_stage2_rbgs k=0", 0)),
              ("block_rbgs_half_sweep (2x2 bgmg levels, rank 0)", "block_rbgs_half_sweep",
               half_row, e_bgmg["launches"]["block_rbgs_half_sweep"]),
              ("block_rbgs_half_sweep (2x2 stage2_sweeps=2, rank 0)", "block_rbgs_half_sweep",
               half_row, e_sweeps["launches"]["block_rbgs_half_sweep"])]
    kernels += [{"name": label, "route": "cuda", "source": KERNEL_SOURCES[k][0],
                 "replaces": KERNEL_SOURCES[k][1], "launches": n_launch,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"]}
                for label, k, r, n_launch in inner]
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"device": smi, "kernels": kernels, "kernel_cases": krec,
                       "fuse_apply_ms": fuse_times, "barrier_latencies": barriers,
                       "slice_counts": counts,
                       "main_steps": recs, "main_launches": bench_launches,
                       "cell_updates_per_s": cu_s, "flagship_small": small,
                       "flagship_small_sweeps2": small2,
                       "flagship_steps": [r.as_dict() for r in frecs],
                       "flagship_newton_all_attempts": attempts,
                       "flagship_cell_updates_per_s": fcu_s, "flagship_peak_gib": peak,
                       "flagship_layers": layers, "kernel_rows": ROWS,
                       "sp_small": sp_small, "sp_geothermal_steps": [r.as_dict() for r in sp_recs],
                       "sp_geothermal_launches": sp_launches,
                       "sp_geothermal_cell_updates_per_s": sp_cu_s, "sp_geothermal_rates": sp_rates,
                       "flagship_small_jvp": small_jvp,
                       "flagship_jvp_steps": [r.as_dict() for r in jrecs],
                       "flagship_jvp_launches": jlaunches, "flagship_jvp_cell_updates_per_s": jcu_s,
                       "flagship_operator_turns": turns, "ptxas": ptxas,
                       "sp_geothermal_jvp_steps": [r.as_dict() for r in sj_recs],
                       "sp_geothermal_jvp_launches": sj_launches,
                       "w_cycle_cases": wrec, "line_smoother_ms": LINE_TIMES,
                       "inner_cases": irec, "inner_pt_cases": irec_pt,
                       "inner_steps": [r.as_dict() for r in irecs], "inner_apply_ms": apply_ms,
                       "inner_launches": ilaunches, "inner_launches_by_columns": inner_cols,
                       "inner_newton_all_attempts": iattempts,
                       "inner_cell_updates_per_s": icu_s, "inner_peak_gib": ipeak,
                       "solver_options": opts, "cli": cli, "blocked": blocked,
                       "schedule": sched, "pc_dtype_batch_pt": pc12,
                       "transfers_bgmg_recycle_adjoint": p13, "ensemble_examples": p14,
                       "decomposition": p15,
                       "total_s": time.perf_counter() - t_all}, fh, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
