"""flash_roofline.train: K1 and K1-bwd (flash attention forward, backward) in the
traced steps, percent of their bound: the bound of one call at the cell's
shapes (``perfbench.work``) times the calls the profiler counted, over the
device time of their kernels."""

from .. import work
from ..reference.layout import head_dim
from ._common import FLASH_BWD, FLASH_FWD, roofline


def read(record, ctx):
    a, mix = ctx.config["arch"], ctx.traffic
    b, t, kv, hd = mix["batch"], mix["seq_len"], a["n_kv_heads"], head_dim(a)
    g = a["n_heads"] // kv
    fwd = work.bound_s(*work.flash_fwd_work(b, t, t, kv, g, hd, 0, 0, 2), "bf16")
    bwd = work.bound_s(*work.flash_bwd_work(b, t, t, kv, g, hd, 0, 0, 2), "bf16")
    return roofline(ctx.trace, [("flash_attention_fwd", FLASH_FWD, fwd),
                                ("flash_attention_bwd", FLASH_BWD, bwd)])
