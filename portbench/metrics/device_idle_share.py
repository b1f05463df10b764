"""Share of the traced window in which nothing ran on the device: 100 x
(1 - the union of every kernel, copy and fill interval over the window),
averaged over the cards."""

from portbench.trace import covered


def read(t):
    shares = [100.0 * (1.0 - covered((a.start, a.end) for a in tr.device) / tr.window_us)
              for tr in t.traces if tr.window_us > 0]
    return sum(shares) / len(shares) if shares else None
