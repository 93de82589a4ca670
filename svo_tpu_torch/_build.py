"""Build and load the port's CUDA kernels.

The kernels in csrc/*.cu (KLT patch extraction, the fused LK tracker, the
threefry PnP noise, RANSAC-PnP, FAST with its NMS, the capability probes) are compiled with
nvcc for Hopper (sm_90a), one nvcc process per source and all started
together, and linked into one shared library with a plain C interface,
loaded with ctypes. The library goes to build/svo_tpu_torch/ at the
repository root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing library. Nothing
is built at import: the first call that launches a kernel builds.

This module owns the kernel set. A wrapper module declares each C entry it
calls with entry() at import, beside the code that calls it, and calls it
through launch(), which counts it. The counters live here, one name each,
"<kernel>.<what>" with <kernel> the csrc/<kernel>.cu stem: "<kernel>.launches"
for every kernel, and ransac_pnp.slots, fast_nms.pixels. The captured steps,
the tracer and the tools read and set them through counters(),
set_counters() and reset_counters().
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

import torch

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


class Entry(NamedTuple):
    symbol: str       # the C function, returning a CUDA error code (0: none)
    argtypes: tuple   # its ctypes parameters, the stream's handle last
    kernel: str       # the csrc/<kernel>.cu stem, which names its counters


_entries: dict = {}   # symbol -> Entry, as the wrapper modules declare them
_counters: dict = {}  # "<kernel>.<what>" -> count since the last reset


def entry(symbol: str, argtypes, kernel: str, counts=("launches",)) -> Entry:
    """Declare the C function `symbol` of csrc/<kernel>.cu with its ctypes
    parameters (the stream's handle last, which launch() appends) and the
    counters "<kernel>.<what>" for each `what` in counts, at 0. A wrapper
    module calls it at import; nothing is built or loaded."""
    e = Entry(symbol, tuple(argtypes), kernel)
    if _entries.get(symbol, e) != e:
        raise ValueError(f"{symbol} is declared twice, differently")
    _entries[symbol] = e
    for what in counts:
        _counters.setdefault(f"{kernel}.{what}", 0)
    if _lib is not None:
        _bind(_lib, e)
    return e


def _bind(lib: ctypes.CDLL, e: Entry) -> None:
    fn = getattr(lib, e.symbol)
    fn.argtypes = list(e.argtypes)
    fn.restype = ctypes.c_int


def entries() -> dict:
    """Every declared entry by its C name."""
    return dict(_entries)


def load() -> ctypes.CDLL:
    """The loaded kernel library, with every declared entry's C signature
    set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        lib.svo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.svo_cuda_error_string.restype = ctypes.c_char_p
        for e in _entries.values():
            _bind(lib, e)
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.svo_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


def launch(e: Entry, device, *args, what: str | None = None, launches: int = 1) -> None:
    """Call entry e with args and the current stream of `device`, under a
    torch.cuda.device guard so it launches on that card, building the
    library at the first launch; raise RuntimeError (led by `what`, else the
    kernel's name) on a CUDA error code; count `launches` kernel launches
    into "<kernel>.launches"."""
    lib = load()
    with torch.cuda.device(device):
        code = getattr(lib, e.symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, code, what or e.kernel)
    count(f"{e.kernel}.launches", launches)


def count(name: str, n: int = 1) -> None:
    """Add n to a declared counter (an undeclared name raises KeyError)."""
    _counters[name] += n


def counters() -> dict:
    """A copy of every declared counter, by name."""
    return dict(sorted(_counters.items()))


def set_counters(values: dict) -> None:
    """Set the named counters (each one declared) to the given values."""
    unknown = set(values) - set(_counters)
    if unknown:
        raise KeyError(f"undeclared counters {sorted(unknown)}")
    _counters.update(values)


def reset_counters() -> None:
    """Every counter back to 0."""
    for name in _counters:
        _counters[name] = 0


def launches() -> dict:
    """Each declared kernel's launches, by its csrc stem. A kernel whose
    wrapper module is not imported yet is not declared: a reader of a
    difference counts it from 0."""
    return {name[: -len(".launches")]: n for name, n in counters().items()
            if name.endswith(".launches")}
