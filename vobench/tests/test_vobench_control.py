"""The output check's control on the card, at the cells' own size over a
2 s window (at the CPU tests' 96x320 the fleet's bfloat16 control moves a
pose by ~2 cm, under the full-size limits): the reference computed one
precision step below float32 in the program's place (TF32; bfloat16 in
the FAST fleet cells, where TF32 changes no bit) fails at least one of the
numbers the cell compares, while the program itself passes them. The control at each
cell's own size, on its seeds, is `python3 -m vobench.calibrate` (PERF.md
gives the readings). Needs the card: skips without one."""

import pytest

from conftest import need_card

from vobench import harness, spec


@pytest.mark.chip
@pytest.mark.parametrize("name,control", [("kitti00-fast.fleet8", "bf16"),
                                          ("kitti00-orb-ba.live1", "tf32"),
                                          ("kitti00-orb-ba.fleet8-ba", "tf32")])
def test_control_is_not_correct(name, control):
    need_card()
    cell = spec.load_cell(name)
    r = harness.run(cell, 20261017, 2.0, False, "cuda", control=True)
    assert r["correct"] is True, r["_readings"]
    ctl = r["_control"][control]
    assert any(ctl[k] > lim for k, lim in cell.limits.items()), ctl
