"""tpot_p95_ms: the 95th percentile of every gap between consecutive output
tokens of a wave, over all waves of the window."""

from .. import stats


def read(record, ctx):
    v = stats.percentile(stats.token_gaps(record), 95)
    return None if v is None else v * 1e3
