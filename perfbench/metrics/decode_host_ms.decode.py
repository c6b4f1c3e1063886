"""decode_host_ms.decode: the host's milliseconds a decode step before it waits for
the step's tokens, the mean over the window's decode steps (``serve.decode``)
that no profiler touched: each step's host time less its ``.tolist()``
(``serve.tokens``).  That is the host issuing the step's launches: its own
work, and, where the device runs behind, its waits for room in the launch
queue.  One reading does not tell the two apart; ``tools/decode_diag.py``
measures the first alone."""

from ._spans import window


def read(record, ctx):
    spans = window(record, ctx)
    if spans is None:
        return None
    steps = [s.self_ns for s in spans if s.name == "serve.decode" and not s.profiled]
    return sum(steps) / len(steps) / 1e6 if steps else None
