"""mfu.zamba2_decode: model flops of the output tokens emitted after the traced
decode steps (2 x the parameters a token passes through, ``flops_hybrid``: each
site's shared block, adapter and linear once per site), over the rest of the
window's seconds and the H100's bf16 peak, in percent."""

from .. import flops_hybrid, stats
from ._common import BF16_PEAK


def read(record, ctx):
    t0 = record.get("traced_until") or 0.0
    if record["window_s"] <= t0:
        return None
    model = flops_hybrid.decode(ctx.config["arch"], stats.tokens_after(record, t0))
    return 100.0 * model / ((record["window_s"] - t0) * BF16_PEAK)
