"""Capability probes of the card.

    python3 -m svo_tpu_torch.probe

The Hopper counterpart of scripts/probe_mosaic.py, which asks the TPU's
Mosaic compiler what it accepts (docs/mosaic_limits.md). Each probe is a
tiny hand-written kernel (csrc/probe.cu) on that script's inputs, x
(32, 48, 64) and o (32, 8) f32 made with numpy from a seed, writing
(32, 1); the result is held against a plain PyTorch version, and each
probe asks the card for something the port's kernels rely on or will need
(see the table PROBES). One line per probe: OK, or FAIL (expected) where
the card's refusal is the answer and the wrapper raised it. A probe that
should pass and does not raises.

On CPU tensors run_probe runs the plain version (the CPU tests' path); on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from svo_tpu_torch import _build

ROWS = 32
CORNER_MARGIN, CORNER_HI = 6, 1177  # a temporal level-0 corner's clamp, lk_level.cu
WIDE_GRID_X = 8 * 8192 + 4464       # 70,000 blocks in x, past 65,535
SMEM_OK = 100 * 1024                # above the 48 KB a block gets without opting in
SMEM_TOO_MUCH = 256 * 1024          # above the 227 KB a Hopper block can opt in to


def make_inputs(seed: int = 0, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """x (32, 48, 64) in [0, 1) and o (32, 8) in [0, 5), as the Mosaic
    probe draws them; o[0:3, 0] are NaN, +inf, -inf for the cast probe."""
    rng = np.random.default_rng(seed)
    x = rng.random((ROWS, 48, 64)).astype(np.float32)
    o = (rng.random((ROWS, 8)) * 5).astype(np.float32)
    o[0:3, 0] = [np.nan, np.inf, -np.inf]
    return torch.from_numpy(x).to(device), torch.from_numpy(o).to(device)


def _window_sum(x, o, param):
    return torch.sum(x[:, 0:34, 3:24], dim=(1, 2))[:, None]


def _warp_butterfly(x, o, param):
    return torch.sum(x[:, 0, 0:32], dim=1)[:, None]


def _float2int(x, o, param):
    # the port's plain corner (ops/lk_fused._corner): clamp after the cast.
    # What the cast makes of NaN and inf differs between the CPU and the
    # card, so the probe states the card's answers: NaN -> 0, +inf -> the
    # upper clamp, -inf -> 0.
    v = o[:, 0] * 300.0 - 100.0  # [0, 5) spread over both ends of the clamp
    out = torch.clamp(torch.floor(torch.nan_to_num(v, nan=0.0)) - CORNER_MARGIN, 0, CORNER_HI)
    return out[:, None]


def _dyn_smem(x, o, param):
    n = param // 4
    row = x.reshape(ROWS, -1)
    size = row.shape[1]
    return (row[:, 0] + row[:, (n // 2) % size] + row[:, (n - 1) % size])[:, None]


def _wide_grid(x, o, param):
    first = param - ROWS
    return (o[:, 3] + torch.arange(first, param, dtype=torch.float32, device=o.device))[:, None]


class Probe(NamedTuple):
    name: str
    which: int                # the kernel's number in csrc/probe.cu
    plain: Callable           # (x, o, param) -> (32, 1)
    param: int
    atol: float               # |kernel - plain| allowed, with its reason in `note`
    refusal_expected: bool
    note: str


PROBES = (
    Probe("3d-window-unaligned", 0, _window_sum, 0, 1e-3, False,
          "x[:, 0:34, 3:24] summed from global memory; 714 terms in another order"),
    Probe("warp-butterfly-sum", 1, _warp_butterfly, 0, 1e-4, False,
          "__shfl_xor_sync sum equal on all 32 lanes, second launch bit-identical"),
    Probe("float2int-clamp", 2, _float2int, 0, 0.0, False,
          "__float2int_rd of NaN/+inf/-inf then clamp lands in range"),
    Probe("dyn-smem-100KB", 3, _dyn_smem, SMEM_OK, 0.0, False,
          "dynamic shared memory above 48 KB after cudaFuncSetAttribute"),
    Probe("dyn-smem-256KB", 3, _dyn_smem, SMEM_TOO_MUCH, 0.0, True,
          "above the opt-in limit: an error code, not a crash"),
    Probe("wide-grid-x", 4, _wide_grid, WIDE_GRID_X, 0.0, False,
          f"grid ({WIDE_GRID_X}, 4): x past 65,535"),
)


_p, _i = ctypes.c_void_p, ctypes.c_int
_PROBE = _build.entry("svo_probe", [_i, _p, _p, _p, _i, _p], "probe")


def run_probe(probe: Probe, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The probe's (32, 1) result: the kernel on CUDA tensors, the plain
    version on CPU tensors. Raises RuntimeError with the CUDA error where
    the card refuses the launch."""
    if tuple(x.shape) != (ROWS, 48, 64) or tuple(o.shape) != (ROWS, 8):
        raise ValueError(f"x {tuple(x.shape)} / o {tuple(o.shape)}: expected (32, 48, 64) / (32, 8)")
    if x.dtype != torch.float32 or o.dtype != torch.float32 or x.device != o.device:
        raise ValueError("x and o must be float32 tensors on one device")
    if x.device.type == "cpu":
        return probe.plain(x, o, probe.param)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.zeros((ROWS, 1), dtype=torch.float32, device=x.device)
    _build.launch(_PROBE, x.device, probe.which, x.contiguous().data_ptr(),
                  o.contiguous().data_ptr(), out.data_ptr(), probe.param,
                  what=f"probe {probe.name}")
    return out


def run_all(device="cuda", seed: int = 0, out=sys.stdout) -> list[dict]:
    """Run every probe on `device`, print one line each, and return the
    rows. Raises if a probe that should pass fails or disagrees with its
    plain version, or if an expected refusal does not come."""
    x, o = make_inputs(seed, device)
    rows = []
    for p in PROBES:
        try:
            got = run_probe(p, x, o)
            again = run_probe(p, x, o)
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
        except RuntimeError as e:
            if not p.refusal_expected:
                raise
            print(f"{p.name}: FAIL (expected) ({p.note}) -> {str(e).splitlines()[0][:90]}", file=out)
            rows.append(dict(name=p.name, ok=False, expected=True, max_abs_err=None))
            continue
        if p.refusal_expected:
            raise AssertionError(f"probe {p.name}: the card took what it should refuse ({p.note})")
        want = p.plain(x, o, p.param)
        err = float((got - want).abs().max())
        if not (torch.isfinite(got).all() and err <= p.atol):
            raise AssertionError(f"probe {p.name}: kernel differs from plain by {err} (> {p.atol})")
        if not torch.equal(got, again):
            raise AssertionError(f"probe {p.name}: a second launch differs")
        print(f"{p.name}: OK   ({p.note}) max|diff| {err:.3g}", file=out)
        rows.append(dict(name=p.name, ok=True, expected=True, max_abs_err=err))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("svo_tpu_torch.probe: torch.cuda.is_available() is False; the "
              "probes need a CUDA device", file=sys.stderr)
        return 1
    run_all("cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
