"""Device busy time (the union of activity intervals) of the frame steps in
the profiled slice, per lockstep step of all streams, ms."""

from vobench.trace import busy_ns, step_activities


def read(rec):
    sl = rec["slice"]
    if not sl or not sl["steps"]:
        return None
    return busy_ns(step_activities(rec), sl["t0"], sl["t1"]) / 1e6 / sl["steps"]
