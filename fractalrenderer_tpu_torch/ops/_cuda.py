"""Build and bind the port's CUDA kernels.

The sources in ``fractalrenderer_tpu_torch/csrc/*.cu`` are compiled at first
use by ``nvcc``, one process per source, all started together, and linked
into one shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library
lands in the build directory (``FRACTAL_TORCH_BUILD_DIR``, read at each
build, or ``fractalrenderer_tpu_torch/_build/``) under a name keyed by a
hash of the sources and flags, written through a temporary file and
``os.replace`` so a concurrent build never loads a partial file.

``compile_probe`` builds the salted kernel K6 (``csrc/probe/``, outside the
library) afresh on every call: the fresh-compile probe of bench config 0.

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
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")  # unless FRACTAL_TORCH_BUILD_DIR
PROBE_SRC = os.path.join(CSRC_DIR, "probe", "compile_probe.cu")

# -fmad=false: no multiply-add contraction (the reference counts depend on
# the shaders' unfused operation order, and the dd error terms on no
# contraction at all).  No --use_fast_math: it flushes subnormals and
# approximates division and logf.  -Xptxas=-v writes each kernel's
# registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit (set CUDA_HOME)")


def build_dir() -> str:
    """The directory builds go to: ``FRACTAL_TORCH_BUILD_DIR`` as it is
    now, or ``BUILD_DIR``."""
    return os.environ.get("FRACTAL_TORCH_BUILD_DIR") or BUILD_DIR


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir(), f"libfr_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/ unless a library for these sources exists; returns its
    path.  The compilers' output is kept beside it as ``<name>.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(path)) as tmpdir:
        cus = [s for s in sources() if s.endswith(".cu")]
        objs = [os.path.join(tmpdir, os.path.basename(s)[:-3] + ".o")
                for s in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cus, objs)]
        logs, failed = [], []
        for s, proc in zip(cus, procs):
            out, _ = proc.communicate()
            logs.append(f"== {os.path.basename(s)}\n{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(s))
        if not failed:
            so = os.path.join(tmpdir, "lib.so")
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                                   *objs], capture_output=True, text=True)
            logs.append(f"== link\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                               + "".join(logs))
        with open(path[:-3] + ".log", "w") as f:
            f.write("".join(logs))
        os.replace(so, path)
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared (pointers and the stream as c_void_p,
    so 64-bit addresses are not cut to 32 bits)."""
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # fr_escape(family, params, table, width, height, map_height, row0,
    #           max_iter_cap, flags, interior_style, out0..out6, stream)
    lib.fr_escape.argtypes = [ci, vp, vp] + [ci] * 7 + [vp] * 8
    lib.fr_escape.restype = ci
    # fr_dd_escape(params, width, height, map_height, row0, n, zx, zy,
    #              stream)
    lib.fr_dd_escape.argtypes = [vp] + [ci] * 4 + [vp] * 4
    lib.fr_dd_escape.restype = ci
    # fr_perturbation(family, tier, form, params, 6 orbit streams, width,
    #                 height, map_height, max_passes, spp, float_cont, n,
    #                 zx, zy, glitch, want, rounds, errx, stream)
    lib.fr_perturbation.argtypes = [ci] * 3 + [vp] * 7 + [ci] * 6 + [vp] * 8
    lib.fr_perturbation.restype = ci
    # fr_bulb_cone(power, params, coarse_w, coarse_h, width, map_height,
    #              t0, stream)
    lib.fr_bulb_cone.argtypes = [ci, vp] + [ci] * 4 + [vp] * 2
    lib.fr_bulb_cone.restype = ci
    # fr_bulb_march(power, params, tc, coarse_w, cone, width, height,
    #               map_height, shade, hit, t, d, esc, nx, ny, nz, ao,
    #               msteps, work, stream)
    lib.fr_bulb_march.argtypes = [ci, vp, vp] + [ci] * 6 + [vp] * 11
    lib.fr_bulb_march.restype = ci
    # fr_fma_peak(x, out, n, k, chains, stream)
    lib.fr_fma_peak.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.fr_fma_peak.restype = ci
    lib.fr_cuda_error_string.argtypes = [ci]
    lib.fr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cuda_device(device):
    """The CUDA device a kernel wrapper launches on (with its index), or a
    raise: a wrapper never falls back to the plain version."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA device, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (use device='cpu' for the plain "
                           "PyTorch path)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check(lib, rc: int, what: str) -> None:
    """Raise on a refused launch (the cudaError_t an entry point returns)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.fr_cuda_error_string(rc).decode())


def compile_probe_plain(x, salt: float):
    """K6 as plain PyTorch: ``x * salt + 1`` in f32 (one multiply, one add,
    as the kernel issues them under -fmad=false)."""
    return x * salt + 1.0


def build_compile_probe(salt: float) -> ctypes.CDLL:
    """Build K6 (``csrc/probe/compile_probe.cu``) with ``salt`` baked in,
    into a fresh temporary directory under the build directory, and load
    it.  Raises when nvcc is missing or the build fails."""
    nvcc = find_nvcc()
    root = build_dir()
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmpdir:
        so = os.path.join(tmpdir, "probe.so")
        out = subprocess.run(
            [nvcc, *NVCC_FLAGS, f"-DFR_PROBE_SALT={int(salt)}.0f", "-shared",
             "-o", so, PROBE_SRC], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed (compile probe):\n{out.stdout}"
                               f"{out.stderr}")
        lib = ctypes.CDLL(so)  # stays mapped after the file is removed
    lib.fr_compile_probe.argtypes = [ctypes.c_void_p] * 3
    lib.fr_compile_probe.restype = ctypes.c_int
    lib.fr_probe_error_string.argtypes = [ctypes.c_int]
    lib.fr_probe_error_string.restype = ctypes.c_char_p
    return lib


def compile_probe_cuda(lib: ctypes.CDLL, x):
    """Launch the K6 instance ``lib`` (from build_compile_probe) on the
    (16, 128) f32 CUDA tensor ``x``; returns the output tensor.  Counts its
    launches in ``compile_probe_cuda.launches``."""
    import torch

    dev = cuda_device(x.device)
    if x.shape != (16, 128) or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("the compile probe takes a contiguous (16, 128) "
                         f"f32 tensor, got {tuple(x.shape)} {x.dtype}")
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        rc = lib.fr_compile_probe(x.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("compile probe kernel launch failed: "
                           + lib.fr_probe_error_string(rc).decode())
    compile_probe_cuda.launches += 1
    return out


compile_probe_cuda.launches = 0


def compile_probe(device="cuda") -> dict:
    """The fresh-compile probe (K6, bench config 0): draw a random 24-bit
    salt, build the probe kernel with it (an object no cache has seen),
    launch it on ones((16, 128)) and fetch out[0, 0].  Returns ``seconds``
    (the call to the fetched scalar: build, load, launch, fetch),
    ``build_seconds`` (nvcc and the load), ``salt`` and ``lib`` (the loaded
    instance, for compile_probe_cuda).  Raises on a missing nvcc, a failed
    build or an output not bit-equal to ``x * salt + 1``."""
    import torch

    dev = cuda_device(device)
    salt = float(int.from_bytes(os.urandom(3), "big"))
    t0 = time.perf_counter()
    lib = build_compile_probe(salt)
    build_s = time.perf_counter() - t0
    x = torch.ones((16, 128), dtype=torch.float32, device=dev)
    out = compile_probe_cuda(lib, x)
    float(out[0, 0])
    seconds = time.perf_counter() - t0
    if not torch.equal(out, compile_probe_plain(x, salt)):
        raise RuntimeError(f"compile probe (salt {salt:.0f}): the output is "
                           "not x * salt + 1")
    return {"seconds": seconds, "build_seconds": build_s, "salt": salt,
            "lib": lib}
