"""Build and load the port's CUDA kernels.

The kernels in csrc/*.cu (KLT patch extraction, the fused LK tracker, the
threefry PnP noise, RANSAC-PnP, FAST with its NMS, the capability probes) are compiled with
nvcc for Hopper (sm_90a), one nvcc process per source and all started
together, and linked into one shared library with a plain C interface,
loaded with ctypes. The library goes to build/svo_tpu_torch/ at the
repository root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing library. Nothing
is built at import: the first call that launches a kernel builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "svo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME"
    )


def library_path() -> Path:
    """Path of the built library, compiling it first if the sources or
    flags changed. Raises RuntimeError with nvcc's output on failure."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libsvo_tpu_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)] for s, o in zip(srcs, objs)]
        procs = [
            subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for c in cmds
        ]
        results = [(c, p, *p.communicate()) for c, p in zip(cmds, procs)]
        lib = str(Path(tmp) / "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        for cmd, proc, stdout, stderr in results:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}"
                )
        done = subprocess.run(link, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({done.returncode}): {' '.join(link)}\n"
                f"{done.stdout}\n{done.stderr}"
            )
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, with every function's C signature set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.svo_klt_patches.argtypes = [
            p, p, p, p, i, i, i, p, p, p, p, p, i, i, i, p, p,
        ]
        lib.svo_klt_patches.restype = i
        # eps2 and min_eig_threshold are C floats: without c_float ctypes
        # refuses a Python float (or, under c_int, would cut it)
        lib.svo_lk_level.argtypes = [
            p, p, p, p, i, i, i, p, p, p, i, i, i, i, i, i, f, f, p, p,
        ]
        lib.svo_lk_level.restype = i
        # the level table: host arrays of device pointers and of ints
        lib.svo_lk_track.argtypes = [
            ctypes.POINTER(p), ctypes.POINTER(i), i, i, p, p, p, i, i, i, i,
            f, f, f, f, p, p,
        ]
        lib.svo_lk_track.restype = i
        lib.svo_threefry_split_gumbel.argtypes = [p, i, i, p, p, p, p]
        lib.svo_threefry_split_gumbel.restype = i
        # the LO gates: host arrays of C floats
        fp = ctypes.POINTER(f)
        lib.svo_ransac_pnp.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, fp, i, fp, i, f, f, i, i, i, i, i, i, p, p, p, p, p,
            p, p, p, p, p,
        ]
        lib.svo_ransac_pnp.restype = i
        lib.svo_fast_nms.argtypes = [p, p, p, i, i, i, f, p]
        lib.svo_fast_nms.restype = i
        lib.svo_probe.argtypes = [i, p, p, p, i, p]
        lib.svo_probe.restype = i
        lib.svo_cuda_error_string.argtypes = [i]
        lib.svo_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.svo_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
