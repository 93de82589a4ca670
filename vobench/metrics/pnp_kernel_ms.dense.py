"""Device time of the RANSAC-PnP kernel's launches (pnp_hypotheses*,
pnp_select*) of the frame steps in the profiled slice, per lockstep step
of all streams, ms. None where the slice ran none."""

from vobench.pnp_bound import pnp_activities


def read(rec):
    sl = rec["slice"]
    if not sl or not sl["steps"]:
        return None
    acts = pnp_activities(rec)
    if not acts:
        return None
    return sum(e - s for _, s, e in acts) / 1e6 / sl["steps"]
