"""``idle.serve``: the share of the wall time of the engine's ``admit``
and ``step`` calls inside the profiler's device window in which no
operation ran on the card, in %."""

from portbench import profiling


def read(run):
    if run.trace is None:
        return None
    busy, total = profiling.busy_within(run.trace,
                                        run.data["traced_spans"])
    if total <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / total)
