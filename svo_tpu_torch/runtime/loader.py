"""ctypes binding of the native async stereo prefetcher (native/loader.cpp).

The port's counterpart of svo_tpu/runtime/loader.py: N C++ decoder
threads keep a bounded, ordered ring of decoded grayscale frames ahead of
the consumer, so the host loop only copies ready frames while the device
computes. The library is built from native/loader.cpp with g++ and the
flags of native/Makefile (libpng, zlib, pthreads) into
build/svo_tpu_torch/ at the repository root on first use, named by a hash
of the source and the command, as _build.py does for the kernels.
Callers check available() and read with io.kitti.SequenceReader where the
library cannot be built (no g++ or no libpng headers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from svo_tpu_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lpng", "-lz", "-pthread")

_lib: ctypes.CDLL | None = None
_unavailable: str | None = None  # why the last build failed


def library_path() -> Path:
    """Path of the built library, compiling it first if the source or the
    command changed. Raises RuntimeError with the compiler's output."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found")
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libsvoloader_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / "lib.so"
        cmd = [cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE), *LIBS]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            errors = [ln for ln in done.stderr.splitlines() if "error" in ln] or ["(no message)"]
            raise RuntimeError(
                f"g++ could not build {SOURCE.name}: {errors[0].strip()}\n"
                f"{' '.join(cmd)}\n{done.stderr[-2000:]}"
            )
        os.replace(lib, out)
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        lib.svo_loader_create.restype = ctypes.c_void_p
        lib.svo_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.svo_loader_next.restype = ctypes.c_int
        lib.svo_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.svo_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library is built or can be built here (one build
    attempt per process; unavailable_reason() says why it failed)."""
    global _unavailable
    if _lib is not None:
        return True
    if _unavailable is None:
        try:
            _load_lib()
        except (RuntimeError, OSError) as e:
            _unavailable = str(e)
    return _lib is not None


def unavailable_reason() -> str | None:
    return _unavailable


class AsyncStereoLoader:
    """Iterate (idx, left, right) uint8 frames decoded ahead by C++ threads.

    Layout: <root>/image_2/%06d.png + <root>/image_3/%06d.png (KITTI), or
    explicit left/right dirs; frames are cropped or zero-padded to
    (height, width)."""

    def __init__(
        self,
        root: str,
        start: int,
        end: int,
        height: int,
        width: int,
        threads: int = 2,
        capacity: int = 8,
        left_dir: str | None = None,
        right_dir: str | None = None,
    ):
        lib = _load_lib()
        ld = left_dir or os.path.join(root, "image_2")
        rd = right_dir or os.path.join(root, "image_3")
        self.height, self.width = height, width
        self._handle = lib.svo_loader_create(
            ld.encode(), rd.encode(), start, end, capacity, threads, width, height
        )
        self._lib = lib

    def __iter__(self):
        while True:
            left = np.empty((self.height, self.width), np.uint8)
            right = np.empty((self.height, self.width), np.uint8)
            idx = self._lib.svo_loader_next(
                self._handle,
                left.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                right.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            if idx < 0:
                return
            yield idx, left, right

    def close(self):
        if self._handle:
            self._lib.svo_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
