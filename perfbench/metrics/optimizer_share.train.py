"""optimizer_share.train: percent of the traced steps' device time in the
optimizer (``train.optimizer``: global-norm clipping and the AdamW update),
over the device time of their whole steps (``train.step``)."""

from ._spans import step_share


def read(record, ctx):
    return step_share(record, ctx, "train.optimizer")
