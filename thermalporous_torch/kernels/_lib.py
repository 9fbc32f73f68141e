"""Build and load the CUDA kernels of ``thermalporous_torch/csrc``.

The sources are compiled with ``nvcc`` into one shared library with a plain C
interface, at first use, into ``thermalporous_torch/_build/<hash>/``, where
the hash covers the sources and the flags (a changed source gets a new
directory).  The library is loaded with ``ctypes``; every C entry takes raw
device pointers plus PyTorch's current stream and returns the
``cudaGetLastError()`` of its launches.

``--fmad=false`` keeps the compiler from contracting a·b + c into one
rounding: the kernels then round like the plain PyTorch versions op by op,
which is what lets the card hold them to ulp-level tolerances.  The stencil
kernels are bandwidth-bound and the deep-cycle kernel is bound by its chain
of grid-wide barriers, so the lost FMAs cost nothing measurable.

The Chebyshev smooth and the fused coarse subtree are cooperative launches
(``cudaLaunchCooperativeKernel``, ``cooperative_groups``' ``grid.sync()``):
their grids must be co-resident, so the wrappers size them from
:func:`device_limits` (at most one block per SM), and a grid the card
refuses comes back as a nonzero error, which :func:`launch` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

from thermalporous_torch.tracing import span

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
SOURCES = ("common.cuh", "dual.cuh", "rbgs.cuh", "stencil.cu", "residual.cu", "rbgs.cu",
           "rbgs_bf16.cu", "deep_cycle.cu", "device.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)
LIB_NAME = "libthermalporous_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

_MODEL_ARGS = (_I, _P, _P, _P, _P, _D, _P, _I, _I, _I, _I, _I, _I, _I, _P)

# C entry points: name -> argtypes (every entry returns a cudaError_t as int;
# the first argument is the dtype code of :func:`dtype_code` unless noted)
_SIGNATURES = {
    # coef, v, y, nc, k, dim, n0, n1, n2, stream
    "tp_block_matvec": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # packed, v, y, dim, n0, n1, n2, blocks, threads, vec, stream
    "tp_scalar_matvec": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # packed, b, x (nullable), lam, out, out2 (nullable), y_a, y_b, d_buf,
    # degree, lam_min_frac, safety, dim, n0, n1, n2, blocks, threads,
    # per_block, iters, cached_quads, smem, vec, second, batch, stream
    "tp_chebyshev_smooth": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _D, _D, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # u, u_old (residual) or v (jvp), fields, out, dt, params (host double*),
    # dim, n0, n1, n2, ty, tz, lx, stream
    "tp_twophase_residual": _MODEL_ARGS,
    "tp_singlephase_residual": _MODEL_ARGS,
    "tp_twophase_jvp": _MODEL_ARGS,
    "tp_singlephase_jvp": _MODEL_ARGS,
    # coef, dinv, r, x1 (nullable when k = 0), out, nc, k, dim, n0, n1, n2,
    # ty, tz, lx, par, stream
    "tp_stage2_rbgs": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # coef, dinv, b, x, out, colour, par, nc, dim, n0, n1, n2, stream
    "tp_block_rbgs_half": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # desc (host int64*, DEEP_DESC_PER_LEVEL per level), n_levels, inv,
    # partials, barriers (nullable), degree, lam_min_frac, safety, blocks,
    # threads, batch, stream
    "tp_deep_correction": (_I, _P, _I, _P, _P, _P, _I, _D, _D, _I, _I, _I, _P),
    # device, sms (host int*), smem_optin (host int*)      [no dtype code]
    "tp_device_limits": (_I, _P, _P),
    # kind (0 grid, 1 cluster), blocks, threads, iters, stream  [no dtype code]
    "tp_barrier_probe": (_I, _I, _I, _I, _P),
}

#: int64 entries per level of tp_deep_correction's descriptor
#: (csrc/deep_cycle.cu: kDescPerLevel) and its level limit (kMaxLevels)
DEEP_DESC_PER_LEVEL = 20
DEEP_MAX_LEVELS = 16
#: largest Chebyshev degree of tp_deep_correction (kMaxDegree)
DEEP_MAX_DEGREE = 16

#: length of the params array of the residual and JVP entries
#: (csrc/residual.cu: kNumParams)
MODEL_NUM_PARAMS = 28


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


@functools.cache
def build() -> tuple[pathlib.Path, float, str]:
    """Compile the library if this source hash has not been built yet: one
    ``nvcc -c`` per source, all started together, then one link.

    Returns (library path, build seconds — 0.0 when already built, the
    compiler's output)."""
    with span("setup.kernel_library"):
        out_dir = BUILD_ROOT / _source_hash()
        lib_path = out_dir / LIB_NAME
        log_path = out_dir / "nvcc.log"
        if lib_path.exists():
            return lib_path, 0.0, log_path.read_text() if log_path.exists() else ""
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        nvcc = _nvcc()
        units = [n for n in SOURCES if n.endswith(".cu")]
        objs = [out_dir / (n[:-3] + ".o") for n in units]
        procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / n)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True), n)
                 for n, o in zip(units, objs)]
        log, failed = "", []
        for proc, name in procs:
            out = proc.communicate()[0]
            log += f"== {name}\n{out}"
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp,
               *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
        return lib_path, time.perf_counter() - t0, log


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library with argtypes/restype set for every entry."""
    with span("setup.kernel_library"):
        lib = ctypes.CDLL(str(build()[0]))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        return lib


def dtype_code(t: torch.Tensor, coef: torch.Tensor | None = None) -> int:
    """The entries' dtype code of vectors ``t`` and, where the kernel reads
    preconditioner coefficients, their tensor ``coef``: 0 = float32, 1 =
    float64, each with coefficients of the same dtype; 2 = float32 and 3 =
    float64 with bfloat16 coefficients (``CPRConfig.pc_dtype``)."""
    code = {torch.float32: 0, torch.float64: 1}[t.dtype]
    return code + 2 if coef is not None and coef.dtype == torch.bfloat16 else code


def launch(name: str, *args) -> None:
    """Call C entry ``name`` and raise on a nonzero cudaError_t."""
    err = getattr(load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


@functools.cache
def device_limits(index: int) -> tuple[int, int]:
    """(number of SMs, largest dynamic shared memory in bytes a block may
    opt in to) of CUDA device ``index``."""
    sms, smem = ctypes.c_int(), ctypes.c_int()
    launch("tp_device_limits", index, ctypes.byref(sms), ctypes.byref(smem))
    return sms.value, smem.value


def limits_of(t: torch.Tensor) -> tuple[int, int]:
    """:func:`device_limits` of the CUDA device that holds ``t``."""
    index = t.device.index
    return device_limits(torch.cuda.current_device() if index is None else index)


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dims3(shape: tuple[int, ...]) -> tuple[int, int, int]:
    """Grid extents padded to three axes (n2 = 1 in 2D)."""
    return (shape[0], shape[1], shape[2] if len(shape) == 3 else 1)
