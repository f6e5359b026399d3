"""Build and bind the port's CUDA kernels.

The sources in ``fractalrenderer_tpu_torch/csrc/*.cu`` are compiled at first
use by ``nvcc`` into one shared library with a plain C interface, which is
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
library lands in ``fractalrenderer_tpu_torch/_build/`` under a name keyed by
a hash of the sources and flags, written through a temporary file and
``os.replace`` so a concurrent build never loads a partial file.

Importing this module needs no CUDA toolkit; building without ``nvcc``
raises.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# -fmad=false: no multiply-add contraction (the reference counts depend on
# the shaders' unfused operation order).  No --use_fast_math: it flushes
# subnormals and approximates division and logf.  -Xptxas=-v writes each
# kernel's registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit (set CUDA_HOME)")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfr_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/ unless a library for these sources exists; returns its
    path.  The compiler's output is kept beside it as ``<name>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources() if s.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    with open(path[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared (pointers and the stream as c_void_p,
    so 64-bit addresses are not cut to 32 bits)."""
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fr_escape_mandelbrot.argtypes = [vp, vp] + [ci] * 10 + [vp] * 4
    lib.fr_escape_mandelbrot.restype = ci
    lib.fr_cuda_error_string.argtypes = [ci]
    lib.fr_cuda_error_string.restype = ctypes.c_char_p
    return lib
