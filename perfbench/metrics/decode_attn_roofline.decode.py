"""decode_attn_roofline.decode: K5 (the decode-attention kernel, ``decode_attn_tiles``)
in the traced decode steps, percent of its bound: the bound of each traced call at
its step's valid slots (the first wave's longest prompt plus the decode steps so
far; ``work_decode``, the frozen count) over the device time of its kernels.  The
traced steps are decode steps ``trace_decode_from`` .. of the window's first wave,
each calling the kernel the same number of times (once an attention layer or site)."""

from ..reference.layout import head_dim
from ..work import bound_s
from ..work_decode import decode_attention_work
from ._common import kernel_seconds, op_calls


def read(record, ctx):
    trace, cell = ctx.trace, ctx.cell
    if not trace or not record.get("waves"):
        return None
    calls, busy = op_calls(trace, "decode_attention"), kernel_seconds(trace, ("decode_attn_tiles",))
    steps = cell["trace_decode_steps"]
    if calls == 0 or busy <= 0 or calls % steps:
        return None
    a, b = ctx.config["arch"], ctx.traffic["batch"]
    kv, hd = a["n_kv_heads"], head_dim(a)
    g = a["n_heads"] // kv
    max_p = record["waves"][0]["max_p"]
    first = cell["trace_decode_from"]
    bound = sum(bound_s(*decode_attention_work(b, max_p + k, kv, g, hd, 2), "fp32")
                for k in range(first, first + steps))
    return 100.0 * bound * (calls // steps) / busy
