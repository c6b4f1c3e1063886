"""Simulated cluster substrate: discrete-event clock, network, disks.

CFS is a multi-node system; this container is one CPU box.  The protocols
(raft, chain replication, committed offsets, placement) run as real code —
only the transport is simulated.  Pieces:

* ``SimClock`` — a virtual clock in microseconds.
* ``EventScheduler`` — a discrete-event loop on a ``SimClock``: a stable
  min-heap of ``(time, seq, callback)`` events.  Benchmarks schedule op
  dispatches here; firing order is deterministic (time, then insertion
  order) so same-seed runs replay bit-identically.
* ``Resource`` — a work-conserving single-server service queue (one per
  NIC, one per disk).  ``acquire(t, service)`` grants the earliest idle
  interval at or after ``t`` and returns when the job leaves the server,
  so overlapping requests from concurrent ops pay real queueing delay
  (FIFO head-of-line when saturated) instead of the old bottleneck bound.
* ``Network`` — routes RPCs between node ids.  Every call charges latency to
  the *current operation context* (an ``OpTimer``), records traffic, and can
  inject faults: dropped messages, partitions, dead nodes.  Calls are
  synchronous Python calls (deterministic, easy to test).  Untimed ops keep
  the seed's additive cost model; ops opened with ``begin_op(at=t)`` are
  *timed*: their virtual completion frontier advances through per-node NIC
  and disk service queues, which is what produces queueing delay, packet
  pipelining, and tail latency under contention.
* ``Disk`` — capacity + IO cost accounting per node; timed ops queue on the
  disk's ``Resource``.

Timer-driven protocols (raft elections/heartbeats) are tick-driven, the same
way etcd-raft is tested: the driver calls ``tick()`` explicitly.
"""

from __future__ import annotations

import bisect
import heapq
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..analysis import knobs
from ..analysis import sanitizer as _san

__all__ = [
    "SimClock",
    "EventScheduler",
    "Resource",
    "WfqResource",
    "NetError",
    "NodeDown",
    "Partitioned",
    "MessageDropped",
    "Network",
    "Disk",
    "OpTimer",
    "LatencyModel",
]


class NetError(Exception):
    """Base class for injected network faults."""


class NodeDown(NetError):
    pass


class Partitioned(NetError):
    pass


class MessageDropped(NetError):
    pass


class DiskFull(Exception):
    pass


class SimClock:
    """Virtual clock, microsecond resolution."""

    def __init__(self) -> None:
        self.now_us: float = 0.0

    def advance(self, dt_us: float) -> None:
        assert dt_us >= 0
        self.now_us += dt_us

    def now(self) -> float:
        return self.now_us


class EventScheduler:
    """Deterministic discrete-event loop over a :class:`SimClock`.

    Events are ``(time, seq, fn, args)``; ``seq`` is a monotonically
    increasing insertion counter, so ties in virtual time fire in schedule
    order — stable, seed-independent tie-breaking.  Callbacks receive the
    fire time as their first argument and may schedule further events."""

    def __init__(self, clock: Optional[SimClock] = None):
        self.clock = clock or SimClock()
        self._heap: List[Tuple[float, int, Callable[..., Any], tuple]] = []
        self._seq = 0
        self.fired = 0
        if _san.SAN is not None:
            # a fresh scheduler restarts virtual time: everything recorded
            # so far happened on an earlier timeline
            _san.SAN.on_new_timeline()

    def at(self, t_us: float, fn: Callable[..., Any], *args: Any) -> None:
        """Schedule ``fn(t, *args)`` at absolute virtual time ``t_us``."""
        heapq.heappush(self._heap, (t_us, self._seq, fn, args))
        self._seq += 1

    def after(self, dt_us: float, fn: Callable[..., Any], *args: Any) -> None:
        self.at(self.clock.now() + dt_us, fn, *args)

    def __len__(self) -> int:
        return len(self._heap)

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def run(self, until_us: Optional[float] = None) -> float:
        """Fire events in (time, seq) order; returns the final clock time.

        The clock never moves backwards: an event scheduled in the past
        (e.g. at a resource's earlier free slot) fires at the current time."""
        while self._heap:
            if until_us is not None and self._heap[0][0] > until_us:
                break
            t, _, fn, args = heapq.heappop(self._heap)
            self.clock.now_us = max(self.clock.now_us, t)
            self.fired += 1
            fn(t, *args)
        return self.clock.now_us


class Resource:
    """Single-server service queue — one NIC port, one disk spindle.

    Jobs arrive at time ``t`` with a service demand; the server is
    work-conserving: the job occupies the *earliest idle interval* of
    length ``service_us`` at or after ``t`` (earliest-fit).  When the
    server is saturated this degenerates to FIFO head-of-line blocking;
    when it is idle around ``t`` the job backfills into the gap, so an
    op dispatched earlier on the event heap cannot serialize a whole
    call chain's worth of *propagation* time into the server — only real
    occupancy queues.  Busy intervals are kept as a sorted disjoint list
    (merged when touching); every operation is deterministic.

    Tracks total busy and queueing time so benchmarks can name the
    bottleneck resource."""

    __slots__ = ("name", "_starts", "_ends", "busy_us", "queued_us", "jobs")

    def __init__(self, name: str = ""):
        self.name = name
        self._starts: List[float] = []   # busy intervals [start, end)
        self._ends: List[float] = []
        self.busy_us = 0.0
        self.queued_us = 0.0
        self.jobs = 0

    @property
    def free_at(self) -> float:
        """End of the last scheduled busy interval (diagnostics)."""
        return self._ends[-1] if self._ends else 0.0

    def acquire(self, t_arrive: float, service_us: float,
                tenant: Optional[Tuple[str, str]] = None) -> float:
        """Occupy the server for ``service_us`` starting no earlier than
        ``t_arrive``; returns the departure time.  ``tenant`` is accepted
        (and ignored) so call sites can pass the op's flow unconditionally;
        only :class:`WfqResource` schedules by it."""
        self.jobs += 1
        self.busy_us += service_us
        if service_us <= 0:
            return t_arrive
        starts, ends = self._starts, self._ends
        # first busy interval ending after the arrival
        i = bisect.bisect_right(ends, t_arrive)
        cand = t_arrive
        while i < len(starts) and starts[i] < cand + service_us:
            cand = ends[i]           # gap too small — skip past this interval
            i += 1
        end = cand + service_us
        self.queued_us += cand - t_arrive
        merge_left = i > 0 and ends[i - 1] == cand
        merge_right = i < len(starts) and starts[i] == end
        if merge_left and merge_right:
            ends[i - 1] = ends[i]
            del starts[i], ends[i]
        elif merge_left:
            ends[i - 1] = end
        elif merge_right:
            starts[i] = cand
        else:
            starts.insert(i, cand)
            ends.insert(i, end)
        return end

    def reset(self) -> None:
        self._starts.clear()
        self._ends.clear()
        self.busy_us = 0.0
        self.queued_us = 0.0
        self.jobs = 0


def parse_qos_weights(spec: str) -> Dict[str, float]:
    """Parse a ``CFS_QOS_WEIGHTS`` spec ("volA=4,volB=1") into a weight
    map; unlisted volumes weigh 1.0, malformed entries are skipped."""
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition("=")
        try:
            out[name.strip()] = max(float(w), 1e-9)
        except ValueError:
            continue
    return out


# WFQ fairness accounting window: per-flow share budgets reset every
# epoch, and a flow idle for a full epoch stops counting as a competitor
QOS_EPOCH_US = 500.0


class WfqResource(Resource):
    """Weighted-fair-queueing variant of :class:`Resource`: per-tenant
    flows keyed by volume (``CFS_QOS``).

    Single-flow traffic delegates verbatim to the FIFO earliest-fit
    machinery, so a run where every job carries the same tenant (or none)
    is byte-identical to a plain :class:`Resource` — that is what keeps
    every single-volume baseline unchanged with QoS on.

    With two or more recently-active flows, each flow's service budget
    per :data:`QOS_EPOCH_US` window is its weighted share ``w / W``:

    * A flow **under budget** is exactly the flow WFQ would serve next
      (smallest virtual finish time).  The FIFO backlog ahead of it was
      already booked with committed departure times, so the preemption
      is modelled as a private lane at full rate: the job books
      earliest-fit on the flow's own interval list, so concurrent
      streams of one volume still serialize on the single server while
      out-of-order arrivals (ops book at their own op-clock times) fill
      lane gaps exactly like the seed scheduler.
    * A flow **over budget** keeps the real earliest-fit booking (work
      stays on the interval list) but is paced by its virtual-finish
      frontier: each job floors at ``flow_pace[f]`` and advances it by
      ``service * W / w`` — the canonical WFQ finish-tag increment — so
      a bursting tenant converges to its weighted share and leaves gaps
      the other flows' bookings (and the light lane) ride in.

    Work conservation: a competitor idle for a full epoch is pruned, and
    the surviving flow re-enters the plain FIFO path, backfilling the
    leftover capacity via ordinary earliest-fit."""

    __slots__ = ("net", "flow_lane", "flow_pace", "flow_epoch", "flow_used",
                 "flow_booked", "flow_jobs", "flow_busy_us",
                 "flow_queued_us")

    def __init__(self, name: str, net: "Network"):
        super().__init__(name)
        self.net = net
        self.flow_lane: Dict[str, Resource] = {}  # light-lane intervals
        self.flow_pace: Dict[str, float] = {}     # heavy-lane VFT frontier
        self.flow_epoch: Dict[str, int] = {}      # last arrival epoch
        self.flow_used: Dict[str, float] = {}     # service used this epoch
        self.flow_booked: Dict[str, float] = {}   # main-list booked frontier
        self.flow_jobs: Dict[str, int] = {}
        self.flow_busy_us: Dict[str, float] = {}
        self.flow_queued_us: Dict[str, float] = {}

    def _weight(self, flow: str) -> float:
        return self.net.qos_weights.get(flow, 1.0)

    def acquire(self, t_arrive: float, service_us: float,
                tenant: Optional[Tuple[str, str]] = None) -> float:
        if tenant is None or not self.net.qos:
            return super().acquire(t_arrive, service_us)
        flow = tenant[0]
        epoch = int(t_arrive // QOS_EPOCH_US)
        epochs = self.flow_epoch
        booked = self.flow_booked
        # a flow competes while it arrived recently OR still owns booked
        # backlog on the main interval list ahead of this arrival; flows
        # with neither are pruned
        for f in [f for f, fe in epochs.items()
                  if fe < epoch - 1 and booked.get(f, 0.0) <= t_arrive]:
            del epochs[f]
            self.flow_used.pop(f, None)
            self.flow_pace.pop(f, None)
            self.flow_lane.pop(f, None)
            booked.pop(f, None)
        others_w = sum(self._weight(f) for f in epochs if f != flow)
        if epochs.get(flow) != epoch:
            epochs[flow] = epoch
            self.flow_used[flow] = 0.0           # budget resets per window
        self.flow_jobs[flow] = self.flow_jobs.get(flow, 0) + 1
        self.flow_busy_us[flow] = self.flow_busy_us.get(flow, 0.0) + service_us
        used = self.flow_used[flow]
        self.flow_used[flow] = used + service_us
        if others_w <= 0.0:
            # alone on the queue: the seed FIFO path, verbatim
            end = super().acquire(t_arrive, service_us)
            booked[flow] = max(booked.get(flow, 0.0), end)
            self.flow_queued_us[flow] = self.flow_queued_us.get(flow, 0.0) \
                + max(0.0, end - t_arrive - service_us)
            return end
        w = self._weight(flow)
        share = w / (w + others_w)
        if used + service_us <= QOS_EPOCH_US * share:
            # under its share: WFQ serves this job ahead of the heavy
            # backlog (whose departures are already committed) — book it
            # earliest-fit on the flow's private lane at full rate
            lane = self.flow_lane.get(flow)
            if lane is None:
                lane = self.flow_lane[flow] = Resource(f"{self.name}/{flow}")
            end = lane.acquire(t_arrive, service_us)
            self.jobs += 1
            self.busy_us += service_us
            queued = max(0.0, end - t_arrive - service_us)
            self.queued_us += queued
            self.flow_queued_us[flow] = \
                self.flow_queued_us.get(flow, 0.0) + queued
            return end
        # over its share: real earliest-fit booking, floored at the flow's
        # virtual-finish frontier which advances by service/share — the
        # burst converges to w/W of the server
        floor = max(t_arrive, self.flow_pace.get(flow, t_arrive))
        end = super().acquire(floor, service_us)
        booked[flow] = max(booked.get(flow, 0.0), end)
        self.flow_pace[flow] = max(self.flow_pace.get(flow, t_arrive),
                                   t_arrive) + service_us / share
        self.queued_us += floor - t_arrive
        self.flow_queued_us[flow] = self.flow_queued_us.get(flow, 0.0) \
            + max(0.0, end - t_arrive - service_us)
        return end

    def reset(self) -> None:
        super().reset()
        self.flow_lane.clear()
        self.flow_pace.clear()
        self.flow_epoch.clear()
        self.flow_used.clear()
        self.flow_booked.clear()
        self.flow_jobs.clear()
        self.flow_busy_us.clear()
        self.flow_queued_us.clear()


@dataclass
class LatencyModel:
    """Cost model for one network hop / one disk op (all microseconds)."""

    rtt_us: float = 200.0            # per-RPC round trip (LAN ~0.2ms)
    bw_bytes_per_us: float = 125.0   # 1000 Mbps == 125 B/us (paper's NIC)
    disk_seek_us: float = 50.0       # SSD access latency
    disk_bw_bytes_per_us: float = 500.0  # ~500 MB/s SSD
    # client-cache tier costs (the tiered extent cache): a RAM hit is
    # a memcpy at DRAM bandwidth, an SSD hit queues on the client's local
    # "ssd:<client>" Resource with this latency + size/bandwidth service time
    ram_lat_us: float = 0.5              # DRAM access + copy setup
    ram_bw_bytes_per_us: float = 20000.0  # ~20 GB/s memory bandwidth
    ssd_lat_us: float = 80.0             # NVMe read latency
    ssd_bw_bytes_per_us: float = 2000.0  # ~2 GB/s local NVMe

    def net_cost(self, nbytes: int) -> float:
        return self.rtt_us + nbytes / self.bw_bytes_per_us

    def disk_cost(self, nbytes: int) -> float:
        return self.disk_seek_us + nbytes / self.disk_bw_bytes_per_us

    def ram_cost(self, nbytes: int) -> float:
        return self.ram_lat_us + nbytes / self.ram_bw_bytes_per_us

    def ssd_cost(self, nbytes: int) -> float:
        return self.ssd_lat_us + nbytes / self.ssd_bw_bytes_per_us


class OpTimer:
    """The modeled latency of one logical operation as a point on the
    virtual timeline.

    An op starts at ``start_us`` and its completion frontier ``now_us``
    advances as it consumes network hops and service time; ``us`` (the
    seed's additive accumulator) is now the derived elapsed time.  Untimed
    ops (``begin_op()`` with no start) behave exactly like the seed: costs
    add, nothing queues.  *Timed* ops (``begin_op(at=t)``) additionally
    queue on per-node :class:`Resource` timelines inside ``Network.call``
    and ``Disk.write_cost``/``read_cost``, which is where queueing delay
    and pipelining overlap come from.

    Sequential costs add; parallel fan-out (raft leader -> followers) takes
    the max of the branches via ``parallel()`` or a ``fork()``.
    """

    def __init__(self, start_us: float = 0.0, timed: bool = False,
                 tenant: Optional[Tuple[str, str]] = None) -> None:
        self.start_us: float = start_us
        self.now_us: float = start_us
        self.timed = timed
        # (volume, client) flow identity for QoS scheduling; sub-ops inherit
        # it from the enclosing op in ``Network.begin_op`` and fork branches
        # share the OpTimer, so one tag at the client RPC funnel covers the
        # whole call tree
        self.tenant: Optional[Tuple[str, str]] = tenant
        self.msgs: int = 0
        self.bytes: int = 0
        self.disk_ops: int = 0
        # departure time of this op's outermost request from its source NIC
        # (a pipelined client is free to send the next packet at this point,
        # long before the chain ack arrives)
        self.tx_done_us: float = start_us
        self._depth: int = 0            # net.call nesting depth

    @property
    def us(self) -> float:
        return self.now_us - self.start_us

    def add(self, us: float) -> None:
        self.now_us += us

    def advance_to(self, t_us: float) -> None:
        if t_us > self.now_us:
            self.now_us = t_us

    def parallel(self, branch_costs: List[float]) -> None:
        if branch_costs:
            self.now_us += max(branch_costs)

    def fork(self) -> "_OpFork":
        """Split the timeline: branches recorded with ``branch_done()`` all
        start at the current frontier; ``join()`` resumes at the max."""
        f = _OpFork(self)
        if _san.SAN is not None:
            f.san = _san.SAN.on_fork(self)
        return f


class _OpFork:
    """Helper for concurrent branches of one op (local disk write happening
    while the packet is forwarded down the chain, fan-out RPCs, hedged
    request races, ...)."""

    __slots__ = ("op", "t0", "ends", "san")

    def __init__(self, op: OpTimer):
        self.op = op
        self.t0 = op.now_us
        self.ends: List[float] = []
        self.san = None          # sanitizer fork record when CFS_SANITIZE=1

    def branch_done(self, record: bool = True) -> None:
        """Record the current branch's end; rewind to the fork point.
        ``record=False`` rewinds without recording — a branch that failed
        (e.g. a hedge attempt that NAKed) must not win a race join, though
        the resources it consumed stay consumed."""
        if record:
            self.ends.append(self.op.now_us)
        self.op.now_us = self.t0
        if self.san is not None and _san.SAN is not None:
            _san.SAN.on_branch_done(self.san)

    def join(self) -> None:
        """Resume the op at the latest branch end (the running timeline is
        the final implicit branch) — an all-branches barrier (fan-out)."""
        self.op.now_us = max([self.op.now_us] + self.ends)
        if self.san is not None and _san.SAN is not None:
            _san.SAN.on_join(self.op, self.san)

    def join_first(self) -> None:
        """Resume the op at the EARLIEST recorded branch end — a race: the
        winner defines the op's completion (hedged reads charge only the
        winner), while every branch's resource occupancy stays real.  A
        race with no recorded ends leaves the op at the fork point."""
        if self.ends:
            self.op.now_us = min(self.ends)
        if self.san is not None and _san.SAN is not None:
            _san.SAN.on_join(self.op, self.san)


class Disk:
    """Per-node disk: capacity accounting + IO cost model.

    When ``owner``+``net`` are set, IO time also accrues to the node's busy
    ledger (the disk is the node's own resource)."""

    def __init__(self, capacity_bytes: int, model: Optional[LatencyModel] = None,
                 owner: str = "", net: Optional["Network"] = None):
        self.capacity = capacity_bytes
        self.used = 0
        self.model = model or LatencyModel()
        self.owner = owner
        self.net = net
        self.reads = 0
        self.writes = 0
        self.read_bytes = 0
        self.write_bytes = 0

    @property
    def free(self) -> int:
        return self.capacity - self.used

    @property
    def utilization(self) -> float:
        return self.used / self.capacity if self.capacity else 1.0

    def alloc(self, nbytes: int) -> None:
        if self.used + nbytes > self.capacity:
            raise DiskFull(f"disk full: used={self.used} req={nbytes} cap={self.capacity}")
        self.used += nbytes

    def release(self, nbytes: int) -> None:
        self.used = max(0, self.used - nbytes)

    def _charge(self, nbytes: int, op: Optional[OpTimer]) -> float:
        c = self.model.disk_cost(nbytes)
        if op is not None:
            if op.timed and self.net is not None and self.owner:
                # the disk is a FIFO resource separate from the node's NIC:
                # concurrent ops queue here instead of overlapping for free
                res = self.net.resource(f"disk:{self.owner}")
                op.now_us = res.acquire(op.now_us, c)
            else:
                op.add(c)
            op.disk_ops += 1
        if self.net is not None and self.owner:
            self.net.charge_busy(self.owner, c)
        return c

    def write_cost(self, nbytes: int, op: Optional[OpTimer] = None) -> float:
        self.writes += 1
        self.write_bytes += nbytes
        return self._charge(nbytes, op)

    def read_cost(self, nbytes: int, op: Optional[OpTimer] = None) -> float:
        self.reads += 1
        self.read_bytes += nbytes
        return self._charge(nbytes, op)


@dataclass
class NetStats:
    msgs: int = 0
    bytes: int = 0
    # (src, dst) -> count; used to demonstrate raft-set heartbeat reduction.
    per_pair: Dict[Tuple[str, str], int] = field(default_factory=dict)
    per_kind: Dict[str, int] = field(default_factory=dict)

    def record(self, src: str, dst: str, nbytes: int, kind: str) -> None:
        self.msgs += 1
        self.bytes += nbytes
        self.per_pair[(src, dst)] = self.per_pair.get((src, dst), 0) + 1
        self.per_kind[kind] = self.per_kind.get(kind, 0) + 1


class Network:
    """Synchronous RPC fabric with fault injection and cost accounting."""

    # process-wide creation counter: (net_serial, timeline_epoch) names one
    # virtual timeline uniquely, so observers (the sanitizer's async-commit
    # records) can tell entries from a previous cluster's clock apart from
    # live ones.  Deterministic: depends only on construction order.
    _created = 0

    def __init__(self, model: Optional[LatencyModel] = None, seed: int = 0):
        self.net_serial = Network._created
        Network._created += 1
        self.model = model or LatencyModel()
        self.stats = NetStats()
        self.rng = random.Random(seed)
        self.dead_nodes: Set[str] = set()
        # partition groups: nodes can only talk within their group. None = no partition.
        self._partition_of: Optional[Dict[str, int]] = None
        self.drop_prob: float = 0.0
        # per-destination extra latency (straggler injection), us
        self.slow_nodes: Dict[str, float] = {}
        self._op_stack: List[OpTimer] = []
        # per-node accumulated service time (kept for reports/expansion; the
        # timed engine's real contention state lives in ``resources``)
        self.busy_us: Dict[str, float] = {}
        self.cpu_cost_us: float = 2.0      # per-RPC server-side CPU cost
        # FIFO service queues, created on demand: "nic:<node>", "disk:<node>",
        # "fuse:<client>" — the discrete-event engine's shared state
        self.resources: Dict[str, Resource] = {}
        # ---- multi-tenant QoS ----
        # CFS_QOS=0 keeps the seed FIFO path byte-identical; weights come
        # from CFS_QOS_WEIGHTS ("volA=4,volB=1", unlisted volumes weigh 1)
        self.qos: bool = knobs.get_bool("CFS_QOS")
        self.qos_weights: Dict[str, float] = \
            parse_qos_weights(knobs.get_str("CFS_QOS_WEIGHTS"))
        # resource names scheduled by WfqResource (meta-leader NICs register
        # themselves at node construction)
        self.qos_nics: Set[str] = set()
        # volume -> {"rpcs", "queued_us"} over timed, tenant-tagged RPCs:
        # the attribution substrate for per-volume client stats
        self.tenant_stats: Dict[str, Dict[str, float]] = {}
        # monotonic timeline epoch, bumped by reset_accounting(): virtual
        # times parked across a reset (e.g. async-commit ack windows held by
        # clients) belong to the OLD timeline and must not advance ops on
        # the new one — holders stamp parked times with the epoch and drop
        # entries whose epoch no longer matches
        self.timeline_epoch = 0

    def resource(self, name: str) -> Resource:
        res = self.resources.get(name)
        if res is None:
            if name in self.qos_nics:
                res = self.resources[name] = WfqResource(name, self)
            else:
                res = self.resources[name] = Resource(name)
        return res

    def register_qos_nic(self, name: str) -> None:
        """Route this NIC's service queue through the per-tenant WFQ
        variant.  Meta nodes register at construction — before traffic —
        so the eager swap below only ever replaces an idle resource."""
        self.qos_nics.add(name)
        res = self.resources.get(name)
        if res is not None and not isinstance(res, WfqResource) \
                and res.jobs == 0:
            self.resources[name] = WfqResource(name, self)

    def charge_busy(self, node: str, us: float) -> None:
        self.busy_us[node] = self.busy_us.get(node, 0.0) + us

    def reset_accounting(self) -> None:
        self.busy_us.clear()
        self.stats = NetStats()
        self.tenant_stats.clear()
        self.timeline_epoch += 1
        for res in self.resources.values():
            res.reset()

    # ---- fault injection ------------------------------------------------
    def kill(self, node_id: str) -> None:
        self.dead_nodes.add(node_id)

    def revive(self, node_id: str) -> None:
        self.dead_nodes.discard(node_id)

    def partition(self, *groups: List[str]) -> None:
        m: Dict[str, int] = {}
        for gi, g in enumerate(groups):
            for n in g:
                m[n] = gi
        self._partition_of = m

    def heal(self) -> None:
        self._partition_of = None

    def set_straggler(self, node_id: str, extra_us: float) -> None:
        if extra_us <= 0:
            self.slow_nodes.pop(node_id, None)
        else:
            self.slow_nodes[node_id] = extra_us

    # ---- op context -----------------------------------------------------
    def begin_op(self, at: Optional[float] = None,
                 tenant: Optional[Tuple[str, str]] = None) -> OpTimer:
        """Open an op context.  ``at=None`` (the seed behaviour) gives an
        additive, queue-blind timer; ``at=t`` gives a *timed* op whose RPCs
        and disk IO queue on per-node resources starting at virtual time t.
        ``tenant=None`` inherits the enclosing op's ``(volume, client)``
        flow, so nested sub-ops (pipelined packets, async-commit raft
        rounds, readahead) stay in their volume's QoS flow."""
        if tenant is None and self._op_stack:
            tenant = self._op_stack[-1].tenant
        op = OpTimer(start_us=at or 0.0, timed=at is not None, tenant=tenant)
        if _san.SAN is not None:
            _san.SAN.on_begin_op(op)
        self._op_stack.append(op)
        return op

    def end_op(self) -> OpTimer:
        return self._op_stack.pop()

    @property
    def current_op(self) -> Optional[OpTimer]:
        return self._op_stack[-1] if self._op_stack else None

    # ---- transport ------------------------------------------------------
    def check_reachable(self, src: str, dst: str) -> None:
        if dst in self.dead_nodes:
            raise NodeDown(dst)
        if src in self.dead_nodes:
            raise NodeDown(src)
        if self._partition_of is not None:
            if self._partition_of.get(src, -1) != self._partition_of.get(dst, -2):
                raise Partitioned(f"{src} !~ {dst}")
        if self.drop_prob > 0 and self.rng.random() < self.drop_prob:
            raise MessageDropped(f"{src} -> {dst}")

    def charge(self, src: str, dst: str, nbytes: int, kind: str = "rpc") -> float:
        """Account one message; returns its modeled latency (not yet added)."""
        self.stats.record(src, dst, nbytes, kind)
        lat = self.model.net_cost(nbytes)
        lat += self.slow_nodes.get(dst, 0.0)
        lat += self.slow_nodes.get(src, 0.0)
        return lat

    def call(
        self,
        src: str,
        dst: str,
        fn: Callable[..., Any],
        *args: Any,
        nbytes: int = 256,
        reply_bytes: int = 64,
        kind: str = "rpc",
        **kwargs: Any,
    ) -> Any:
        """Synchronous RPC src -> dst.  Charges request+reply latency to the
        current op (if any), applies fault rules, then invokes ``fn``.

        Timed ops decompose the same total cost into schedulable stages —
        src NIC transmit → propagation → dst NIC receive+service queue →
        handler (nested calls/disk advance the frontier) → dst NIC reply
        transmit → propagation — so concurrent ops contend for the NICs
        instead of overlapping for free."""
        self.check_reachable(src, dst)
        op = self.current_op
        if op is not None and op.timed:
            return self._timed_call(op, src, dst, fn, args, kwargs,
                                    nbytes, reply_bytes, kind)
        lat = self.charge(src, dst, nbytes, kind)
        service = self.cpu_cost_us + nbytes / self.model.bw_bytes_per_us
        self.charge_busy(dst, service)
        result = fn(*args, **kwargs)
        lat += self.charge(dst, src, reply_bytes, kind + ".reply")
        if op is not None:
            op.add(lat + service)
            op.msgs += 2
            op.bytes += nbytes + reply_bytes
        return result

    def _timed_call(self, op: OpTimer, src: str, dst: str,
                    fn: Callable[..., Any], args: tuple, kwargs: dict,
                    nbytes: int, reply_bytes: int, kind: str) -> Any:
        bw = self.model.bw_bytes_per_us
        prop = self.model.rtt_us + self.slow_nodes.get(dst, 0.0) \
            + self.slow_nodes.get(src, 0.0)
        self.stats.record(src, dst, nbytes, kind)
        service = self.cpu_cost_us + nbytes / bw
        self.charge_busy(dst, service)
        # 1. the request occupies the source's own NIC until fully sent
        t = self.resource(f"nic:{src}").acquire(op.now_us, nbytes / bw,
                                                tenant=op.tenant)
        if op._depth == 0:
            # outermost request: a pipelined sender may continue from here
            op.tx_done_us = t
        # 2. propagation, then service at the destination NIC (FIFO, or the
        #    volume's WFQ flow when the NIC is QoS-registered)
        t_req = t + prop
        t = self.resource(f"nic:{dst}").acquire(t_req, service,
                                                tenant=op.tenant)
        op.now_us = t
        if op.tenant is not None:
            ts = self.tenant_stats.setdefault(
                op.tenant[0], {"rpcs": 0, "queued_us": 0.0})
            ts["rpcs"] += 1
            wait = t - t_req - service
            if wait > 0:
                ts["queued_us"] += wait
        # 3. the handler runs at the service point; its own calls and disk
        #    IO advance the frontier further
        op._depth += 1
        try:
            result = fn(*args, **kwargs)
        except Exception:
            # a NAK is still a reply: the error travels back over the wire
            # before the caller can react to it
            op._depth -= 1
            self.stats.record(dst, src, 64, kind + ".err")
            op.now_us = self.resource(f"nic:{dst}").acquire(
                op.now_us, 64 / bw, tenant=op.tenant) + prop
            op.msgs += 2
            op.bytes += nbytes + 64
            raise
        op._depth -= 1
        # 4. reply: dst NIC transmit + propagation back
        self.stats.record(dst, src, reply_bytes, kind + ".reply")
        t = self.resource(f"nic:{dst}").acquire(op.now_us, reply_bytes / bw,
                                                tenant=op.tenant)
        op.now_us = t + prop
        op.msgs += 2
        op.bytes += nbytes + reply_bytes
        return result

    def parallel_calls(
        self,
        src: str,
        targets: List[Tuple[str, Callable[..., Any], tuple]],
        nbytes: int = 256,
        reply_bytes: int = 64,
        kind: str = "rpc",
    ) -> List[Any]:
        """Fan-out the same logical RPC to several nodes 'in parallel': the
        op pays max(branch latencies).  Unreachable branches yield the
        exception instance instead of a result."""
        results: List[Any] = []
        op = self.current_op
        if op is not None and op.timed:
            # timed fan-out: branches share the fork point; transmissions
            # still serialize on the source NIC (one port), service queues
            # per destination are independent
            fork = op.fork()
            for dst, fn, args in targets:
                try:
                    results.append(self.call(src, dst, fn, *args,
                                             nbytes=nbytes,
                                             reply_bytes=reply_bytes,
                                             kind=kind))
                except NetError as e:
                    results.append(e)
                fork.branch_done()
            fork.join()
            return results
        branch_costs: List[float] = []
        for dst, fn, args in targets:
            try:
                self.check_reachable(src, dst)
                lat = self.charge(src, dst, nbytes, kind)
                results.append(fn(*args))
                lat += self.charge(dst, src, reply_bytes, kind + ".reply")
                branch_costs.append(lat)
                if op is not None:
                    op.msgs += 2
                    op.bytes += nbytes + reply_bytes
            except NetError as e:
                results.append(e)
        if op is not None:
            op.parallel(branch_costs)
        return results
