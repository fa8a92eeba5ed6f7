"""Build and load the hand-written CUDA kernels in `csrc/`.

At first use, `library()` compiles every `csrc/*.cu` (the flow-step chains,
whose products run on the wgmma/TMA GEMM core `gemm_sm90.cuh`, the core
alone `gemm_sm90.cu`, the LU 1x1 conv `invconv.cu` and the anatomy variants
`anatomy.cu`) with nvcc for sm_90a (`wgmma` exists only for the `a`
target), one nvcc process per source, all started together, then
links the objects into a shared library with a plain C interface under
`_build/<hash>/` in this package (the hash covers the sources, headers and
flags, so an edited kernel rebuilds), and loads it with ctypes.  The core
fetches the driver's cuTensorMapEncodeTiled through the runtime's
cudaGetDriverEntryPoint, so nothing links against libcuda.  A missing nvcc
or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
_LIB_NAME = "libglow_kernels.so"


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): cannot build the CUDA kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.glow_flowstep.argtypes = [i32] * 7 + [ptr] * 20 + [ptr]
    lib.glow_flowstep.restype = i32
    lib.glow_flowstep_bwd_workspace.argtypes = [i32] * 6
    lib.glow_flowstep_bwd_workspace.restype = ctypes.c_size_t
    lib.glow_flowstep_bwd.argtypes = [i32] * 6 + [ptr] * 33
    lib.glow_flowstep_bwd.restype = i32
    lib.glow_flowstep_band.argtypes = [i32] * 9 + [ptr] * 23 + [ptr]
    lib.glow_flowstep_band.restype = i32
    lib.glow_flowstep_band_bwd_workspace.argtypes = [i32] * 8
    lib.glow_flowstep_band_bwd_workspace.restype = ctypes.c_size_t
    lib.glow_flowstep_band_bwd.argtypes = [i32] * 8 + [ptr] * 33
    lib.glow_flowstep_band_bwd.restype = i32
    lib.glow_invconv_forward.argtypes = [i32] * 3 + [ptr] * 8 + [ptr]
    lib.glow_invconv_forward.restype = i32
    lib.glow_invconv_mix.argtypes = [i32] * 3 + [ptr] * 3 + [ptr]
    lib.glow_invconv_mix.restype = i32
    lib.glow_anatomy_forward.argtypes = [i32] * 6 + [ptr] * 20 + [ptr]
    lib.glow_anatomy_forward.restype = i32
    lib.glow_anatomy_reverse.argtypes = [i32] * 6 + [ptr] * 20 + [ptr]
    lib.glow_anatomy_reverse.restype = i32
    lib.glow_anatomy_bwd_workspace.argtypes = [i32] * 6
    lib.glow_anatomy_bwd_workspace.restype = ctypes.c_size_t
    lib.glow_anatomy_backward.argtypes = [i32] * 7 + [ptr] * 33 + [ptr]
    lib.glow_anatomy_backward.restype = i32
    lib.glow_gemm_sm90_workspace.argtypes = [i32] * 4
    lib.glow_gemm_sm90_workspace.restype = ctypes.c_size_t
    lib.glow_gemm_sm90.argtypes = [i32] * 4 + [ptr, i32, ptr, i32, ptr, ptr, ptr]
    lib.glow_gemm_sm90.restype = i32
    lib.glow_gemm_sm90_actnorm_relu.argtypes = [i32] * 3 + [ptr, i32, ptr, i32] + [ptr] * 4
    lib.glow_gemm_sm90_actnorm_relu.restype = i32
    lib.glow_error_string.argtypes = [i32]
    lib.glow_error_string.restype = ctypes.c_char_p
    return lib


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side, wait for all, raise on the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


@functools.cache
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / _LIB_NAME
    if not lib_path.exists():
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            cu = sorted(SRC_DIR.glob("*.cu"))
            objs = [os.path.join(tmp, src.stem + ".o") for src in cu]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                      for obj, src in zip(objs, cu)])
            so = os.path.join(tmp, _LIB_NAME)
            _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", so, *objs]])
            os.replace(so, lib_path)
    return _declare(ctypes.CDLL(str(lib_path)))


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if status != 0:
        msg = lib.glow_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
