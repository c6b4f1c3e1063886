"""Roofline counts of one call of the port, taken at the dispatcher, and its
bound on an H100.

The reference (``repro.launch.roofline``) parses XLA's optimized HLO.
Eager PyTorch has no HLO: ``Count``, a ``TorchDispatchMode``, sees every
operator as the call runs, on real tensors or on fake ones alike, and adds
up, for the rank it runs on:

  * ``dot_flops``: matmul, bmm, convolution and attention flops by
    ``torch.utils.flop_counter``'s formulas, and the hand-written kernels'
    operators by theirs (``kernels.work``), split by the rate they run at
    (``dot_flops_by_peak``: the inputs' dtype, TF32 for the scans);
  * ``traffic_bytes``: every operator that is not a view reads its input
    tensors once (an expanded dim's elements once) and writes its outputs
    once (eager PyTorch writes each result to device memory); a kernel's
    operator counts its bytes formula.  Copies (``clone``: ``contiguous``,
    a reshape that cannot view, a buffer copied before an in-place
    collective) are counted apart, as ``copy_bytes``: a layout is not work
    the function needs, and whether a copy happens depends on strides, which
    fake tensors take from the meta functions and real ones from the
    kernels (they differ where a layout is ambiguous, as ``softplus_backward``
    of two operands laid out differently);
  * collectives (c10d's and the functional ones): the payload bytes and
    the count by kind, in the reference's kind names, and ``wire_bytes``
    from each one's group size by ``_wire_bytes`` (the reference's per-kind
    factors, verbatim), split into groups within one 8-GPU node and groups
    that span nodes;
  * the peak of live device bytes (storages that operators made, plus
    those registered before the call), split into params, optimizer state,
    gradients (made by the backward with grad mode off), all-gathers'
    results (``gathered``: in a train step, the parameters a layer gathers),
    a serving call's cache (registered as ``cache``) and the rest; and each
    category's own peak.

What of the reference has no counterpart, and why: ``fold_totals`` and the
trip counts (nothing is folded: every layer runs in Python, and each of its
operators is seen each time it runs); ``parse_hlo``, ``build_defs`` and
``_COLL_RE`` (there is no text to parse: operators come typed, with their
tensors); ``_group_size`` (a collective's process group gives its size and
ranks); the TPU fusion model of traffic (eager PyTorch fuses nothing, so
every operator's result is counted as written).

``roofline_terms`` bounds the counts on an H100 SXM 80GB at 700 W, by its
published peaks (NVIDIA's data sheet):

  compute    = sum over rates of dot flops / that rate's peak
  memory     = traffic_bytes / 3.35e12
  collective = wire bytes in one node / 450e9 + wire bytes across nodes / 50e9

These are bounds from counts, not measurements.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only
from torch.utils.flop_counter import flop_registry

from ..kernels.work import KERNEL_OPS

TARGETS = "H100 SXM 80GB, 700 W, published peaks"
# dense peaks of one H100 SXM (NVIDIA's data sheet), by the rate an operation runs at:
# bf16 on the tensor cores; TF32 (the scans' 3xTF32 products, counted once); fp32
# outside the tensor cores (PyTorch's default for fp32 matmuls, the SIMT flash kernels)
PEAK_FLOPS = {"bf16": 989e12, "tf32": 494.7e12, "fp32": 67e12}
HBM_BW = 3.35e12             # bytes/s, HBM3 (data sheet)
NVLINK_BW = 450e9            # bytes/s each way per GPU, NVLink 4, within an 8-GPU node
IB_BW = 50e9                 # bytes/s per GPU across nodes: one 400 Gb/s NDR InfiniBand port
NODE_GPUS = 8

_PEAK_OF_DTYPE = {torch.bfloat16: "bf16", torch.float32: "fp32"}

c10d = torch.ops.c10d
funcol = torch.ops._c10d_functional
# operator -> (kind, what its payload is: "in" the input tensors, "out" the outputs)
_COLLECTIVES = {
    c10d.allreduce_: ("all-reduce", "in"), c10d.allreduce_coalesced_: ("all-reduce", "in"),
    c10d.allgather_: ("all-gather", "out"), c10d._allgather_base_: ("all-gather", "out"),
    c10d.allgather_into_tensor_coalesced_: ("all-gather", "out"),
    c10d.reduce_scatter_: ("reduce-scatter", "out"),
    c10d._reduce_scatter_base_: ("reduce-scatter", "out"),
    c10d.reduce_scatter_tensor_coalesced_: ("reduce-scatter", "out"),
    c10d.alltoall_: ("all-to-all", "in"), c10d.alltoall_base_: ("all-to-all", "in"),
    c10d.send: ("collective-permute", "in"), c10d.recv_: ("collective-permute", "in"),
    c10d.broadcast_: ("broadcast", "in"),
    funcol.all_reduce: ("all-reduce", "in"), funcol.all_reduce_: ("all-reduce", "in"),
    funcol.all_gather_into_tensor: ("all-gather", "out"),
    funcol.reduce_scatter_tensor: ("reduce-scatter", "out"),
    funcol.all_to_all_single: ("all-to-all", "in"), funcol.broadcast: ("broadcast", "in"),
}
# allocations that write nothing, a waited collective, and _unsafe_view (a view whose
# schema does not say so, for autograd's sake)
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided, funcol.wait_tensor,
               torch.ops.aten._unsafe_view}


def _wire_bytes(kind: str, payload: float, g: int) -> float:
    """Per-device bytes over the busiest link."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * payload * (g - 1) / g
    if kind == "all-gather":
        return payload * (g - 1) / g       # payload = gathered result
    if kind == "reduce-scatter":
        return payload * (g - 1)           # payload = scattered result
    if kind == "all-to-all":
        return payload * (g - 1) / g
    if kind == "collective-permute":
        return payload
    return payload


def _peak_of(func, dtype) -> str:
    if dtype not in _PEAK_OF_DTYPE:
        raise ValueError(f"{func} on {dtype}: no peak rate for its flops in PEAK_FLOPS")
    return _PEAK_OF_DTYPE[dtype]


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's own block (its operators' local work is what a rank does)."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list:
    return [_local(x) for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements take, each distinct one once: an expanded
    (stride-0) dim reads the same elements again."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else min(size, 1)
    return n


def _group(args, kwargs, func):
    """The process group a collective runs on."""
    if func.overloadpacket in (funcol.all_reduce, funcol.all_reduce_, funcol.broadcast,
                               funcol.all_gather_into_tensor, funcol.reduce_scatter_tensor,
                               funcol.all_to_all_single):
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = [a for a in args if isinstance(a, str)][-1]
        return _resolve_process_group(name)
    for a in (*args, *(kwargs or {}).values()):
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in a._type().qualified_name():
            return dist.ProcessGroup.unbox(a)
    raise ValueError(f"{func}: no process group among its arguments")


class Count(TorchDispatchMode):
    """Counts, for this rank, every operator run inside the block (see the
    module's docstring).  ``device_type`` names the tensors that stand for
    device memory ("cuda" on the card; "cpu" for CPU or fake CPU tensors).
    ``track(tree, category)`` registers tensors that exist before the call
    (params, optimizer state, inputs) as live device bytes."""

    CATEGORIES = ("params", "opt_state", "grads", "gathered", "cache", "other")

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type
        self.flops_by_peak: Dict[str, float] = defaultdict(float)
        self.traffic_bytes = 0
        self.copy_bytes = 0
        self.kernel_calls: Dict[str, int] = defaultdict(int)
        self.coll_payload: Dict[str, float] = defaultdict(float)
        self.coll_count: Dict[str, int] = defaultdict(int)
        self.wire = {"in_node": 0.0, "across_nodes": 0.0}
        self.wire_by_kind: Dict[str, float] = defaultdict(float)
        self._live: Dict[int, tuple] = {}           # storage key -> (bytes, category, weakref)
        self.live_by_cat: Dict[str, int] = dict.fromkeys(self.CATEGORIES, 0)
        self.peak = 0
        self.peak_by_cat: Dict[str, int] = dict(self.live_by_cat)
        self.peak_of_cat: Dict[str, int] = dict(self.live_by_cat)

    # ---------------------------------------------------------------- memory
    def track(self, tree, category: str) -> None:
        for t in _tensors(tree):
            self._add(t, category)
        self._note_peak()

    def _add(self, t: torch.Tensor, category: str) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, category, weakref.ref(st, lambda _, key=key: self._drop(key)))
        self.live_by_cat[category] += n

    def _drop(self, key) -> None:
        n, category, _ = self._live.pop(key)
        self.live_by_cat[category] -= n

    def _retag(self, t: torch.Tensor, category: str) -> None:
        key = t.untyped_storage()._cdata
        if key in self._live:
            n, old, ref = self._live[key]
            self.live_by_cat[old] -= n
            self.live_by_cat[category] += n
            self._live[key] = (n, category, ref)

    def _note_peak(self) -> None:
        total = sum(self.live_by_cat.values())
        if total > self.peak:
            self.peak, self.peak_by_cat = total, dict(self.live_by_cat)
        for c, n in self.live_by_cat.items():
            self.peak_of_cat[c] = max(self.peak_of_cat[c], n)

    # ------------------------------------------------------------ operators
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.namespace == "prim":
            return out
        args, kwargs = tree_map_only(torch.Tensor, _local, (args, kwargs))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if packet in _COLLECTIVES:
            self._collective(func, args, kwargs, ins, outs)
        elif packet in KERNEL_OPS:
            w = KERNEL_OPS[packet]
            flops, nbytes = w.count(*args, **kwargs)
            if flops:
                self.flops_by_peak[w.peak(*args, **kwargs)] += flops
            self.traffic_bytes += nbytes
            self.kernel_calls[packet._qualified_op_name.split("::")[-1]] += 1
        elif packet is torch.ops.aten.clone:
            self.copy_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        elif not _is_view(func) and packet not in _NO_TRAFFIC:
            self.traffic_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if packet in flop_registry:
                flops = flop_registry[packet](*args, **kwargs,
                                              out_val=tree_map_only(torch.Tensor, _local, out))
                if flops:
                    self.flops_by_peak[_peak_of(func, ins[0].dtype)] += flops
        # gradients: what the backward makes with grad mode off (a checkpointed
        # layer's recompute runs inside the backward with grad mode on)
        grads = torch._C._current_graph_task_id() != -1 and not torch.is_grad_enabled()
        for t in outs:
            self._add(t, "grads" if grads else "other")
        self._note_peak()
        return out

    def _collective(self, func, args, kwargs, ins, outs) -> None:
        kind, side = _COLLECTIVES[func.overloadpacket]
        payload = sum(map(_nbytes, ins if side == "in" else outs))
        pg = _group(args, kwargs, func)
        nodes = {r // NODE_GPUS for r in dist.get_process_group_ranks(pg)}
        self.coll_payload[kind] += payload
        self.coll_count[kind] += 1
        wire = _wire_bytes(kind, payload, pg.size())
        self.wire["in_node" if len(nodes) == 1 else "across_nodes"] += wire
        self.wire_by_kind[kind] += wire
        if kind == "all-gather":
            for t in outs:
                if t.device.type == self.device_type:
                    self._retag(t, "gathered")

    # --------------------------------------------------------------- results
    def totals(self) -> Dict[str, float]:
        return {"dot_flops": float(sum(self.flops_by_peak.values())),
                "dot_flops_by_peak": {k: float(v) for k, v in sorted(self.flops_by_peak.items())},
                "traffic_bytes": float(self.traffic_bytes),
                "copy_bytes": float(self.copy_bytes),
                "wire_bytes": self.wire["in_node"] + self.wire["across_nodes"],
                "wire_bytes_in_node": self.wire["in_node"],
                "wire_bytes_across_nodes": self.wire["across_nodes"],
                **{f"wire_{k}": v for k, v in sorted(self.wire_by_kind.items())},
                **{f"coll_{k}": v for k, v in sorted(self.coll_payload.items())}}

    def memory(self) -> Dict[str, object]:
        return {"peak_bytes": self.peak, "peak_by_category": dict(self.peak_by_cat),
                "peak_of_category": dict(self.peak_of_cat)}

    def collectives(self):
        return dict(sorted(self.coll_payload.items())), dict(sorted(self.coll_count.items()))


def roofline_terms(totals: Dict[str, float]) -> Dict[str, object]:
    by_peak = totals.get("dot_flops_by_peak") or {"bf16": totals["dot_flops"]}
    unknown = set(by_peak) - set(PEAK_FLOPS)
    if unknown:
        raise ValueError(f"flops at rates with no peak in PEAK_FLOPS: {sorted(unknown)}")
    compute_s = sum(f / PEAK_FLOPS[k] for k, f in by_peak.items())
    memory_s = totals["traffic_bytes"] / HBM_BW
    coll_s = (totals.get("wire_bytes_in_node", 0.0) / NVLINK_BW
              + totals.get("wire_bytes_across_nodes", totals["wire_bytes"]) / IB_BW)
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", coll_s), key=lambda kv: kv[1])
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dom[0],
        "bound_s": dom[1],
        "targets": TARGETS,
    }


def model_flops_per_device(cfg, shape, n_devices: int = 256) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), per device."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens / n_devices
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch / n_devices
