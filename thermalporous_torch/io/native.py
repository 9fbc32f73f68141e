"""ctypes bindings for the native I/O runtime (built at first use, optional)
(counterpart of ``thermalporous_tpu/io/native.py``).

The C++ source ``native_src/tp_io.cc`` is compiled with the host's C++
compiler (``$CXX``, else ``c++``) at first use into
``thermalporous_torch/_build/io-<hash>/libtp_io.so``, the hash covering the
source and the flags; the source tree is never written.  Every consumer
falls back to its pure-Python path when no compiler is present or the build
fails, and writes the same bytes either way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "native_src" / "tp_io.cc"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_LIB_NAME = "libtp_io.so"

_lib = None
_load_attempted = False


def lib_path() -> pathlib.Path:
    """Where this source and these flags build to."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_ROOT / f"io-{h}" / _LIB_NAME


def _build(path: pathlib.Path) -> None:
    """Compile into a temporary file beside ``path``, then rename it into
    place (processes that build at once never load a torn library)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "c++"), *_FLAGS, "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    path = lib_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.tp_parse_floats.restype = ctypes.c_long
    lib.tp_parse_floats.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                    ctypes.c_long]
    lib.tp_write_vti.restype = ctypes.c_int
    lib.tp_write_vti.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_char_p),
                                 ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                                 ctypes.c_char_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_floats(path: str, n: int) -> np.ndarray | None:
    """Up to ``n`` whitespace-separated floats of a text file; None if the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(n, dtype=np.float64)
    got = lib.tp_parse_floats(str(path).encode(),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got < 0:
        raise IOError(f"native parser could not open {path!r}")
    return out[:got]


def write_vti_raw(path: str, header: bytes, arrays: list[bytes], footer: bytes) -> bool:
    """Write a VTI file natively; False if the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    n = len(arrays)
    arr_ptrs = (ctypes.c_char_p * n)(*arrays)
    sizes = (ctypes.c_uint64 * n)(*[len(a) for a in arrays])
    rc = lib.tp_write_vti(str(path).encode(), header, arr_ptrs, sizes, n, footer)
    if rc != 0:
        raise IOError(f"native VTI writer failed with code {rc} for {path!r}")
    return True
