"""Host ms a step spends inside the program's step function (its ``step``
span, from entry to return): the median over the traced steps. The step
returns once its work is enqueued, so this is the host's enqueue time; a
step whose host time exceeds the device's leaves the device idle."""

import statistics

from portbench import spans


def read(t):
    got = spans.of_window(t)
    if got is None:
        return None
    return statistics.median(s.end - s.start for s in spans.steps(got)) / 1e3
