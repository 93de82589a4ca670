"""Device activities (kernels, copies, fills) of the frame steps in the
profiled slice, per lockstep step of all streams."""

from vobench.trace import step_activities


def read(rec):
    sl = rec["slice"]
    if not sl or not sl["steps"]:
        return None
    return len(step_activities(rec)) / sl["steps"]
