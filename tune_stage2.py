"""Time the stage-2 kernel (csrc/rbgs.cu) under other launch bounds, plans
and shared-memory carveouts on one GPU, against its plain version.

    python3 tune_stage2.py

Each variant is a copy of csrc/rbgs.cu with its kStage2MaxThreads, its
__launch_bounds__ minimum of blocks per SM or its carveout preference
edited, built with the port's nvcc flags into out/<variant>/ (which git
ignores) and called through ctypes on a random block stencil at the
flagship's 60x220x85 and at 1024x1024, k = 2, f32 and f64.  Each line:
the plan, the card's milliseconds (behind a spinning kernel) and whether
the result is bitwise equal to fused_stage2_rbgs_plain.
"""

import ctypes
import pathlib
import subprocess
import sys

import torch

import chip_smoke as cs
from thermalporous_torch.kernels import _lib
from thermalporous_torch.kernels import stencil as kst

# (name, kStage2MaxThreads, min blocks per SM, carveout percent or None)
VARIANTS = (("b384x1", 384, 1, None), ("b320x2", 320, 2, None), ("b256x2", 256, 2, None),
            ("b320x3", 320, 3, None), ("b224x3", 224, 3, None), ("b384x1_l1", 384, 1, 0),
            ("b384x1_c25", 384, 1, 25))
LAUNCH = "    stage2_kernel<T, NC, K, {d}><<<blocks, threads, smem, st>>>(c_, d_, r_, x_, o_, p);"


def build(name, max_threads, min_blocks, carveout):
    out_dir = pathlib.Path("out") / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_lib.CSRC / "rbgs.cu").read_text()
    src = src.replace("constexpr int kStage2MaxThreads = 384;",
                      f"constexpr int kStage2MaxThreads = {max_threads};")
    src = src.replace("__launch_bounds__(kStage2MaxThreads, 1)",
                      f"__launch_bounds__(kStage2MaxThreads, {min_blocks})")
    src = src.replace('#include "common.cuh"', f'#include "{_lib.CSRC}/common.cuh"')
    if carveout is not None:
        for d in (3, 2):
            line = LAUNCH.format(d=d)
            assert line in src
            src = src.replace(line, (
                f"  {{ static bool set = false; if (!set) {{ cudaFuncSetAttribute("
                f"stage2_kernel<T, NC, K, {d}>, cudaFuncAttributePreferredSharedMemoryCarveout, "
                f"{carveout}); set = true; }}\n{line} }}"))
    (out_dir / "rbgs.cu").write_text(src)
    proc = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o",
                           str(out_dir / "lib.so"), str(out_dir / "rbgs.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    for row in cs.ptxas_summary(proc.stdout + proc.stderr):
        if "(int)3, (int)2, (int)3>" in row[0]:
            print(f"  {name} ptxas {row}", flush=True)
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tp_stage2_rbgs.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_stage2: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    libs = {v[0]: build(*v) for v in VARIANTS}
    for dtype in (torch.float32, torch.float64):
        for shape in ((60, 220, 85), (1024, 1024)):
            st = cs.random_block_stencil(shape, 3, dtype, "cuda", 1)
            dinv = st.diag_inverse()
            g = torch.Generator(device="cuda").manual_seed(2)
            r, x0 = (torch.randn((3,) + shape, generator=g, dtype=dtype, device="cuda")
                     for _ in range(2))
            x1 = x0[:2].contiguous()
            ref = kst.fused_stage2_rbgs_plain(st.coef, dinv, r, x1)
            for name, max_threads, min_blocks, _ in VARIANTS:
                for bps in sorted({min_blocks, 1}):
                    kst.STAGE2_MAX_THREADS, kst.STAGE2_BLOCKS_PER_SM = max_threads, bps
                    kst.stage2_plan.cache_clear()
                    plan = kst.stage2_plan(shape, 132)
                    out = torch.empty_like(r)

                    def kern(lib=libs[name], plan=plan, out=out):
                        err = lib.tp_stage2_rbgs(
                            _lib.dtype_code(r), st.coef.data_ptr(), dinv.data_ptr(),
                            r.data_ptr(), x1.data_ptr(), out.data_ptr(), 3, 2, len(shape),
                            *_lib.dims3(shape), plan.ty, plan.tz, plan.lx, 0, _lib.stream_of(r))
                        if err:
                            raise SystemExit(f"{name}: CUDA error {err}")
                        return out

                    kern()
                    torch.cuda.synchronize()
                    print(f"{dtype} {shape} {name} blocks/SM {bps}: ty={plan.ty} tz={plan.tz} "
                          f"lx={plan.lx} blocks={plan.blocks} threads={plan.threads}: card "
                          f"{cs.time_device_ms(kern):.4f} ms, bitwise {torch.equal(out, ref)}",
                          flush=True)
            kst.STAGE2_MAX_THREADS, kst.STAGE2_BLOCKS_PER_SM = 384, 1
            kst.stage2_plan.cache_clear()
            del st, dinv, r, x0, x1, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
