"""idle_share.decode: percent of the traced decode steps' wall time with no kernel on the device."""

from ._common import idle_share


def read(record, ctx):
    return idle_share(ctx.trace)
