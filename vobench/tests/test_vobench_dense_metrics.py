"""The dense cell's per-layer metrics (kitti00-orb2k.fleet8): the PnP
kernel's device time a lockstep step and its share of its roofline, read
from a recorded slice worked out by hand; none where the slice ran no PnP
kernel (a cell whose program lacks it, or the parent's)."""

import pytest

from vobench import spec
from vobench.pnp_bound import bound_pnp_ms, cell_shape

# two lockstep steps: each a hypotheses launch (300 ns, 250 ns) and a
# selection launch (100 ns, 150 ns) of the wide path, beside an lk_level
# launch; the third pnp activity lies in a refine span and is left out
REC = {
    "cell": "kitti00-orb2k.fleet8",
    "slice": {
        "t0": 0, "t1": 10_000, "steps": 2,
        "activities": [["pnp_hypotheses_wide_kernel", 100, 400],
                       ["pnp_select_wide_kernel", 400, 500],
                       ["lk_level_kernel", 500, 900],
                       ["(anonymous namespace)::pnp_hypotheses_wide_kernel(Args)", 1000, 1250],
                       ["pnp_select_wide_kernel", 1250, 1400],
                       ["pnp_select_kernel", 5000, 5100]],
        "spans": [["refine", 4900, 6000]],
    },
}


def test_the_cell_shape_is_the_configuration_s():
    assert cell_shape(REC) == (8, 2048, 128, 1)


def test_pnp_kernel_ms():
    assert spec.metric_reader("pnp_kernel_ms.dense")(REC) == pytest.approx(800 / 1e6 / 2)


def test_pnp_roofline_is_the_bound_over_the_device_time():
    bound, by = bound_pnp_ms(8, 2048, 128, 1)
    assert by == "bytes"
    want = 100.0 * 2 * bound / (800 / 1e6)
    assert spec.metric_reader("pnp_roofline.dense")(REC) == pytest.approx(want, rel=1e-12)


def test_nothing_to_read_is_none():
    for name in ("pnp_kernel_ms.dense", "pnp_roofline.dense"):
        read = spec.metric_reader(name)
        assert read(dict(REC, slice=None)) is None
        assert read(dict(REC, slice=dict(REC["slice"], activities=[["lk_level_kernel", 0, 9]]))) \
            is None
