"""The RANSAC-PnP kernel's share of its roofline in the profiled slice, %:
the least time of its calls (vobench/pnp_bound.py at the cell's S, N, H,
P: bytes at 3.35 TB/s or operations at 67 TFLOP/s, whichever is larger;
one call a pnp_select launch) over the device time of its launches. None
where the slice ran none."""

from vobench.pnp_bound import bound_pnp_ms, cell_shape, pnp_activities


def read(rec):
    if not rec["slice"]:
        return None
    acts = pnp_activities(rec)
    calls = sum(1 for name, _, _ in acts if "pnp_select" in name)
    ns = sum(e - s for _, s, e in acts)
    if not calls or not ns:
        return None
    return 100.0 * calls * bound_pnp_ms(*cell_shape(rec))[0] / (ns / 1e6)
