"""Scheduler and KV pool: host wall of an engine step's scheduling, the
program's ``repro_torch.core.schedule`` span (the scheduler's step plus
the expired and preempted handling), on average over the spans of the
traced slice.  None where the program opens no such span."""

SPAN = "repro_torch.core.schedule"


def read(run):
    if run.trace is None:
        return None
    walls = [h.end - h.start for h in run.trace.host if h.name == SPAN]
    return sum(walls) / len(walls) * 1e-6 if walls else None
