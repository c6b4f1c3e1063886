"""prefill_share.decode: percent of the window's waves' host time (``serve.wave``)
spent in their prefill (``serve.prefill``: the prompts' forward through
the first tokens on the host).  The steps a profiler touched (the traced
decode steps, and the profiler's stop inside the last of them) are left
out of both sums."""

from ._spans import window


def read(record, ctx):
    spans = window(record, ctx)
    if spans is None:
        return None
    whole = {s: s.host_ns for s in spans if s.name == "serve.wave"}
    prefill = 0
    for s in spans:
        if s.parent in whole and s.profiled:
            whole[s.parent] -= s.host_ns
        elif s.parent in whole and s.name == "serve.prefill":
            prefill += s.host_ns
    total = sum(whole.values())
    return 100.0 * prefill / total if total > 0 else None
