"""The port's kernel set has one owner, svo_tpu_torch/_build.py.

Every `extern "C"` svo_* function that csrc/*.cu defines (but the error
string) is declared by exactly one wrapper's _build.entry, with as many
ctypes parameters as the C function has; every counter is named
"<kernel>.<what>" with <kernel> a csrc stem; counters() and set_counters()
round-trip. Plain Python on the CPU: nothing is built or loaded.
"""

from __future__ import annotations

import importlib
import re

import pytest

from svo_tpu_torch import _build

WRAPPERS = ("svo_tpu_torch.ops.klt_patches", "svo_tpu_torch.ops.klt_track",
            "svo_tpu_torch.ops.lk_fused",
            "svo_tpu_torch.ops.random", "svo_tpu_torch.geometry.pnp",
            "svo_tpu_torch.ops.fast", "svo_tpu_torch.probe")

# an extern "C" definition (not a declaration): `int svo_x(...) {`
_DEF = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(svo_\w+)\s*\(([^)]*)\)\s*\{')


def _c_functions() -> dict:
    """{name: (csrc stem, parameter count)} of every extern "C" svo_*
    function defined in csrc/*.cu."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
        for name, params in _DEF.findall(text):
            params = params.strip()
            n = 0 if params in ("", "void") else params.count(",") + 1
            assert name not in out, f"{name} is defined twice"
            out[name] = (src.stem, n)
    return out


@pytest.fixture(scope="module")
def entries() -> dict:
    for m in WRAPPERS:
        importlib.import_module(m)
    return _build.entries()


def test_every_c_entry_is_declared_once_with_its_arity(entries):
    c = _c_functions()
    assert "svo_cuda_error_string" in c
    del c["svo_cuda_error_string"]
    assert len(c) >= 7
    assert set(entries) == set(c)
    for name, e in entries.items():
        stem, n = c[name]
        assert e.symbol == name and e.kernel == stem, (e, stem)
        assert len(e.argtypes) == n, f"{name}: {len(e.argtypes)} argtypes, {n} C parameters"
    e = entries["svo_probe"]
    assert _build.entry(e.symbol, e.argtypes, e.kernel) == e  # the same again: no change
    with pytest.raises(ValueError, match="declared twice"):
        _build.entry("svo_probe", e.argtypes[:-1], "probe")
    assert _build.entries() == entries


def test_counters_are_named_by_kernel_and_round_trip(entries):
    stems = {p.stem for p in _build.CSRC.glob("*.cu")}
    saved = _build.counters()
    assert {f"{e.kernel}.launches" for e in entries.values()} <= set(saved)
    assert {"ransac_pnp.slots", "fast_nms.pixels"} <= set(saved)
    for name in saved:
        kernel, what = name.split(".")
        assert kernel in stems and what, name
    try:
        _build.reset_counters()
        assert set(_build.counters().values()) == {0}
        _build.count("ransac_pnp.launches", 2)
        _build.count("ransac_pnp.slots", 8 * 2048)
        moved = _build.counters()
        assert moved["ransac_pnp.launches"] == 2 and moved["ransac_pnp.slots"] == 8 * 2048
        assert _build.launches()["ransac_pnp"] == 2
        assert set(_build.launches()) == {e.kernel for e in entries.values()}
        with pytest.raises(KeyError):
            _build.count("ransac_pnp.hypotheses")
        with pytest.raises(KeyError):
            _build.set_counters({"nope.launches": 1})
        _build.set_counters(saved)
        assert _build.counters() == saved
        _build.set_counters(moved)
        assert _build.counters() == moved
    finally:
        _build.set_counters(saved)
