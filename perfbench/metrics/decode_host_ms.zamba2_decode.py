"""decode_host_ms.zamba2_decode: the host's milliseconds a decode step before it
waits for the step's tokens, the mean over the window's decode steps
(``serve.decode``) that no profiler touched: each step's host time less its
``.tolist()`` (``serve.tokens``) only.  The model's own spans inside the step
(``zamba2.shared``, ``zamba2.mamba``) stay in, where a step's self time would
leave them out."""

from ._spans import window


def read(record, ctx):
    spans = window(record, ctx)
    if spans is None:
        return None
    steps = {s: s.host_ns for s in spans if s.name == "serve.decode" and not s.profiled}
    for s in spans:
        if s.name == "serve.tokens" and s.parent in steps:
            steps[s.parent] -= s.host_ns
    return sum(steps.values()) / len(steps) / 1e6 if steps else None
