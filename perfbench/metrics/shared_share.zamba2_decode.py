"""shared_share.zamba2_decode: percent of the traced decode steps' device time in
the shared blocks' sites (``zamba2.shared``: the attention over [h | e] through
K5, the GeGLU MLP with the site's adapter, the site's linear), over the device
time of their whole steps (``serve.decode``; CUDA events on the card)."""

from ._spans import window


def read(record, ctx):
    spans = window(record, ctx)
    if spans is None:
        return None
    steps = {s for s in spans if s.name == "serve.decode" and s.profiled}
    whole = sum(s.device_ns for s in steps)
    shared = sum(s.device_ns for s in spans if s.name == "zamba2.shared" and s.parent in steps)
    return 100.0 * shared / whole if whole > 0 and shared > 0 else None
