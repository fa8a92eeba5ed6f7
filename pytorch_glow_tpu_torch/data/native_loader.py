"""ctypes bindings for the native batch decoder (`csrc/dataloader.cc`).

Counterpart of `pytorch_glow_tpu/data/native_loader.py`, with the same C
ABI.  At first use the library is built with g++ (-O3, linking libjpeg
and libpng) into `_build/glowdata-<hash>/` in this package, the hash
covering the source and the flags, and loaded.  Where it cannot be built
(no g++, or no libjpeg/libpng headers), `available()` is False and the
folder datasets decode with Pillow instead (data/folder.py); so do they
where the built library cannot be loaded.  Nothing else falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "dataloader.cc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_LIBS = ["-ljpeg", "-lpng", "-lz", "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"glowdata-{h.hexdigest()[:16]}" / "libglowdata.so"


def _build(so: Path) -> str | None:
    """Compile into a temporary file and move it into place, so that
    concurrent builds never load a half-written library.  -> the error, or
    None."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        out = os.path.join(tmp, so.name)
        try:
            proc = subprocess.run(["g++", *_FLAGS, "-o", out, str(_SRC), *_LIBS],
                                  capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:  # no toolchain
            return f"{type(e).__name__}: {e}"
        if proc.returncode != 0:
            return proc.stderr[-2000:]
        os.replace(out, so)
    return None


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = _lib_path()
        if not so.is_file():
            _build_error = _build(so)
            if _build_error is not None:
                return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:  # built against libraries this machine lacks
            _build_error = f"{type(e).__name__}: {e}"
            return None
        lib.gdl_decode_batch.restype = ctypes.c_int
        lib.gdl_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.gdl_image_dims.restype = ctypes.c_int
        lib.gdl_image_dims.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
        ]
        lib.gdl_version.restype = ctypes.c_char_p
        lib.gdl_version.argtypes = []
        lib.gdl_pool_create.restype = ctypes.c_void_p
        lib.gdl_pool_create.argtypes = [ctypes.c_int]
        lib.gdl_pool_destroy.restype = None
        lib.gdl_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.gdl_pool_submit.restype = ctypes.c_int
        lib.gdl_pool_submit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.gdl_pool_wait.restype = ctypes.c_int
        lib.gdl_pool_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _default_threads(threads: int) -> int:
    return threads or min(16, max(1, os.cpu_count() or 1))


def decode_batch(paths: list[str], size: int, threads: int = 0) -> np.ndarray:
    """Decode, centre-crop and resize `paths` into one (N, size, size, 3)
    uint8 batch.  Failed images are zero-filled with a warning; raises only
    when the library is missing."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    n = len(paths)
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    err = ctypes.create_string_buffer(512)
    failures = lib.gdl_decode_batch(arr, n, size, _default_threads(threads),
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                                    err, len(err))
    if failures:
        warnings.warn(f"native decode: {failures}/{n} images failed "
                      f"({err.value.decode(errors='replace')}); slots zero-filled")
    return out


class DecodePool:
    """Persistent asynchronous decode pool (`gdl_pool_*`).

    `submit(paths)` queues a batch on the C++ worker threads and returns a
    job id at once; `wait(job)` blocks until that batch's uint8 NHWC array
    is ready.  Submitting batch i+1 before waiting on batch i overlaps
    decode with consumption."""

    def __init__(self, size: int, threads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self.size = size
        self._handle = lib.gdl_pool_create(_default_threads(threads))
        self._bufs: dict[int, np.ndarray] = {}  # job id -> output, kept alive until waited

    def submit(self, paths: list[str]) -> int:
        if not self._handle:
            raise RuntimeError("the decode pool is closed")
        n = len(paths)
        out = np.empty((n, self.size, self.size, 3), dtype=np.uint8)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        job = self._lib.gdl_pool_submit(self._handle, arr, n, self.size,
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if job < 0:
            raise RuntimeError("gdl_pool_submit failed")
        self._bufs[job] = out
        return job

    def wait(self, job: int) -> np.ndarray:
        out = self._bufs.pop(job)
        failures = self._lib.gdl_pool_wait(self._handle, job)
        if failures:
            warnings.warn(f"native decode: {failures}/{out.shape[0]} images failed; "
                          "slots zero-filled")
        return out

    def close(self) -> None:
        if self._handle:
            for job in list(self._bufs):  # the buffers must outlive the work
                self.wait(job)
            self._lib.gdl_pool_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def image_dims(path: str) -> tuple[int, int] | None:
    lib = _load()
    if lib is None:
        return None
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.gdl_image_dims(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value
