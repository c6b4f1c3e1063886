"""decode_tokens_per_s: output tokens of real requests emitted in the window,
over the window's seconds (the window holds whole waves)."""

from .. import stats


def read(record, ctx):
    if record["window_s"] <= 0:
        return None
    return stats.tokens_after(record, -1.0) / record["window_s"]
