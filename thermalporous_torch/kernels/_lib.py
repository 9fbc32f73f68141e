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
kernels are bandwidth-bound and the deep-cycle kernel latency-bound, so the
lost FMAs cost nothing measurable.
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

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"
SOURCES = ("common.cuh", "stencil.cu", "residual.cu", "rbgs.cu", "deep_cycle.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
)
LIB_NAME = "libthermalporous_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

# C entry points: name -> argtypes (every entry returns a cudaError_t as int;
# the first argument is the dtype code, 0 = float32, 1 = float64)
_SIGNATURES = {
    # coef, v, y, nc, k, dim, n0, n1, n2, stream
    "tp_block_matvec": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # packed, v, y, dim, n0, n1, n2, stream
    "tp_scalar_matvec": (_I, _P, _P, _P, _I, _I, _I, _I, _P),
    # packed, b, x (nullable), lam, out, d_a, d_b, x_a, x_b,
    # degree, lam_min_frac, safety, dim, n0, n1, n2, stream
    "tp_chebyshev_smooth": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _D, _D, _I, _I, _I, _I, _P),
    # u, u_old, fields, out, dt, params (host double*), dim, n0, n1, n2, stream
    "tp_twophase_residual": (_I, _P, _P, _P, _P, _D, _P, _I, _I, _I, _I, _P),
    # coef, dinv, b, out, nc, dim, n0, n1, n2, stream
    "tp_block_rbgs_zero": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # desc (host int64*, DEEP_DESC_PER_LEVEL per level), n_levels, inv,
    # degree, lam_min_frac, safety, stream
    "tp_deep_correction": (_I, _P, _I, _P, _I, _D, _D, _P),
}

#: int64 entries per level of tp_deep_correction's descriptor
#: (csrc/deep_cycle.cu: kDescPerLevel) and its level limit (kMaxLevels)
DEEP_DESC_PER_LEVEL = 20
DEEP_MAX_LEVELS = 16

#: length of the params array of tp_twophase_residual (csrc/residual.cu)
TWOPHASE_NUM_PARAMS = 28


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
    lib = ctypes.CDLL(str(build()[0]))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def dtype_code(t: torch.Tensor) -> int:
    return {torch.float32: 0, torch.float64: 1}[t.dtype]


def launch(name: str, *args) -> None:
    """Call C entry ``name`` and raise on a nonzero cudaError_t."""
    err = getattr(load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dims3(shape: tuple[int, ...]) -> tuple[int, int, int]:
    """Grid extents padded to three axes (n2 = 1 in 2D)."""
    return (shape[0], shape[1], shape[2] if len(shape) == 3 else 1)
