"""lk_level's share of its roofline in the profiled slice, %: the least time
its launches' live features need (vobench/peaks.py, each level's bound by
bytes at 3.35 TB/s or operations at 67 TFLOP/s, whichever is larger; live
counts are lower bounds, see harness._lk_launches) over lk_level_kernel's
device time. None where the slice ran no lk_level launch."""

from vobench.peaks import bound_lk_level_ms
from vobench.trace import step_activities


def read(rec):
    if not rec["slice"] or not rec["lk_launches"]:
        return None
    ns = sum(e - s for name, s, e in step_activities(rec) if "lk_level_kernel" in name)
    if not ns:
        return None
    bound_ms = sum(levels * bound_lk_level_ms(slots, live, w, mx, my, it)[0]
                   for slots, live, w, mx, my, it, levels in rec["lk_launches"])
    return 100.0 * bound_ms / (ns / 1e6)
