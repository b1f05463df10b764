"""Device-idle ms a step while the host was inside the program's step
function: the traced window's idle intervals (where no kernel, copy or
fill runs on any stream) that fall inside the ``step`` spans' host
intervals, summed over the window, over the steps. The rest of the
window's idle falls between steps, in the harness (which makes each
step's draws on the device before it calls the step, so the window's
first activity precedes the first span). None unless the last step span
starts before the window's last device activity ends: the device cannot
finish a step the host has not begun, which a clock shared by host and
device must show."""

from portbench import spans
from portbench.trace import covered, exposed, merged


def read(t):
    got = spans.of_window(t)
    busy = merged((a.start, a.end) for a in t.traces[0].device) if got else []
    if not busy:
        return None
    host = [(s.start, s.end) for s in spans.steps(got)]
    if host[-1][0] >= busy[-1][1]:
        return None
    idle = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    return (covered(idle) - exposed(idle, host)) / 1e3 / t.steps
