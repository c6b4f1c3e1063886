"""Multi-rank training and serving on ``torch.distributed``.

Mirrors ``repro.parallel``: ``ctx`` (the ambient mesh), ``sharding`` (the
DP / TP / EP / ZeRO-1 rules, as specs turned into DTensor placements),
``compress`` (int8 error-feedback gradient compression), plus ``spmd``,
the differentiable collectives the model's mesh paths are written with.
Importing any of them touches no process-group state.
"""
