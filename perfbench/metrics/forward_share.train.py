"""forward_share.train: percent of the traced steps' device time in the forward
(``train.forward``: the loss, from the embedding through the cross-entropy),
over the device time of their whole steps (``train.step``)."""

from ._spans import step_share


def read(record, ctx):
    return step_share(record, ctx, "train.forward")
