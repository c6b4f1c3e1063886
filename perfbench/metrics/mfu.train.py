"""mfu.train: model flops (6 x the parameters a token passes through x tokens)
of the window's steps after the traced ones, over their seconds and the
H100's bf16 peak, in percent."""

from .. import flops
from ._common import BF16_PEAK


def read(record, ctx):
    t0 = record.get("traced_until") or 0.0
    ends = [e for e in record.get("step_ends") or [] if e > t0]
    if not ends:
        return None
    model = flops.train_step(ctx.config["arch"], len(ends) * record["tokens_per_step"])
    return 100.0 * model / ((ends[-1] - t0) * BF16_PEAK)
