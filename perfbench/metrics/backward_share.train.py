"""backward_share.train: percent of the traced steps' device time in the backward
(``train.backward``: ``torch.autograd.grad``, remat's recompute included),
over the device time of their whole steps (``train.step``)."""

from ._spans import step_share


def read(record, ctx):
    return step_share(record, ctx, "train.backward")
