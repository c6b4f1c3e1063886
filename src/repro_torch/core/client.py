"""CFS client (paper §2.4, §2.6, §2.7) — the FUSE-process analogue.

Runs "in user space with its own cache":

* partition-routing cache — fetched from the RM at mount, refreshed by
  explicit ``sync_partitions()`` (non-persistent connections, §2.5.2) and
  rate-limited per virtual-time window on the routing-miss path so a burst
  of misses costs one RM round-trip;
* inode/dentry cache — filled on create/lookup/readdir, governed by the
  :class:`~repro_torch.core.meta_session.MetaSession` lease/version contract:
  TTL leases with mvcc revalidation and negative dentries replace the
  paper's force-sync-on-open (``CFS_META_TTL=0`` restores the seed path);
* leader cache — last identified PB/raft WRITE leader per partition group,
  learned only from accepted mutations and NotLeader hints (§2.4);
* read affinity — the replica that last served a read per group; reads try
  it first, then the cached leader, then walk the replicas.  A read served
  by a follower must never redirect the next write, so the two caches are
  disjoint.

Metadata workflows follow Figure 3 exactly — inode first, dentry second, and
on failure the inode goes to a *local orphan list* that is evicted later; all
mutations are retried with a (client_id, seq) session so raft dedup keeps them
exactly-once (§2.1.3).

File I/O follows §2.7: sequential writes stream 128 KB packets to the PB
leader of a randomly chosen writable data partition; random writes split into
an overwrite part (raft, in-place, Fig. 5) and an append part (PB, Fig. 4);
small files (≤128 KB at close) take the aggregated-extent path; deletes are
asynchronous (mark, evict, punch holes / drop extents).

The read path mirrors the append window on the event engine: extent fetches
split into ≤128 KB packets issued as concurrent timed branches under a
bounded window (``CFS_READ_WINDOW``, 0 = the serial seed path), each packet
hedged against a p99-derived per-partition-group budget (EWMA from the
event timeline, ``CFS_HEDGE_READS=0`` disables), and ``CfsFile.read``
detects forward scans and keeps a window of readahead chunks prefetched —
invalidated on seek/write/truncate, drained at the fsync/close barriers.
"""

from __future__ import annotations

import bisect
import math
import random
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import knobs
from ..analysis import sanitizer as _san
from ..cache.extent_cache import TieredExtentCache
from .data_node import Busy
from .extent_store import ExtentError
from .meta_node import (DentryExists, MetaError, NoSuchDentry, NoSuchInode,
                        PartitionFull, RangeExhausted, WrongRange)
from .raft import NotCommitted, NotLeader
from .simnet import NetError, Network, OpTimer
from .types import (MAX_UINT64, PACKET_SIZE, ROOT_INODE,
                    SMALL_FILE_THRESHOLD, ExtentKey, InodeType)

__all__ = ["CfsClient", "CfsFile", "FsError", "NotFound", "Exists",
           "NotADirectory", "IsADirectory", "DirNotEmpty"]

MAX_RETRIES = 4

# Routing-miss resyncs of the partition table are rate-limited to one RM
# round-trip per this virtual-time window (µs); 0 disables the limiter
# (every miss syncs — the seed path).  Recovery paths always force a sync.
SYNC_WINDOW_US = knobs.get_float("CFS_SYNC_WINDOW_US")

# Sequential-write pipelining (§2.7): how many ≤128 KB packets a client
# keeps in flight down the replica chain before it must wait for the oldest
# ack.  0 disables the window (the seed's one-synchronous-round-trip-per-
# packet path, kept for A/B benchmarking via CFS_PIPELINE_DEPTH=0).
PIPELINE_DEPTH = knobs.get_int("CFS_PIPELINE_DEPTH")

# Read-path mirror of the append window: how many ≤128 KB extent fetches a
# client keeps in flight at once (and how many packets of readahead a
# sequential scan keeps prefetched).  0 disables the window: one synchronous
# fetch per extent piece, the seed path kept for A/B benchmarking.
READ_WINDOW = knobs.get_int("CFS_READ_WINDOW")

# Slow-replica hedging on the read path: when a fetch's modeled completion
# blows a p99-derived budget (EWMA per data-partition group, learned from
# the event timeline), race the next replica and charge only the winner.
# CFS_HEDGE_READS=0 disables (fetches wait out stragglers, the seed path).
HEDGE_READS = knobs.get_bool("CFS_HEDGE_READS")

# Async metadata commits (the metadata mirror of the append pipeline): the
# partition leader journals the mutation, stamps the next mvcc and acks the
# client after one NIC round + a journal append; the raft round completes in
# the background under a bounded per-partition unacked window.  0 restores
# the seed's synchronous raft-round-per-mutation ack path.
META_ASYNC = knobs.get_bool("CFS_META_ASYNC")

# How many async-acked metadata mutations a client may hold un-durable per
# partition before the next mutation stalls on the oldest background commit
# (mirrors CFS_PIPELINE_DEPTH on the data side).  0 = synchronous commits.
META_JOURNAL_DEPTH = knobs.get_int("CFS_META_JOURNAL_DEPTH")

# A hedge budget needs samples before it means anything: per-group stats
# are trusted after this many reads, the client-wide aggregate (the cold-
# start fallback) after twice as many.  Below both, reads never hedge.
HEDGE_MIN_GROUP_SAMPLES = 4
HEDGE_MIN_GLOBAL_SAMPLES = 8

# Tiered client-side extent cache: committed ≤128 KB extent packets
# cached in RAM with 2Q-style demotion to a simulated per-client SSD,
# guarded by the inode's extent-map mvcc under the lease contract.
# CFS_CLIENT_CACHE=0 (or both byte budgets 0) restores the seed path:
# every packet read is a network fetch.  Untimed ops never touch the cache.
CLIENT_CACHE = knobs.get_bool("CFS_CLIENT_CACHE")
CACHE_RAM_MB = knobs.get_int("CFS_CACHE_RAM_MB")
CACHE_SSD_MB = knobs.get_int("CFS_CACHE_SSD_MB")
CACHE_WRITE_THROUGH = knobs.get_bool("CFS_CACHE_WRITE_THROUGH")


class _LatencyEwma:
    """EWMA mean/variance of observed read latencies (one per data-partition
    group, plus one client-wide aggregate) — the TCP-RTO trick applied to
    hedging: budget ≈ p99 ≈ mean + 3σ, tracked incrementally so the budget
    adapts as the event timeline accumulates.  Pure arithmetic on modeled
    latencies: deterministic, bit-identical across same-seed reruns."""

    __slots__ = ("mean", "var", "n")
    ALPHA = 0.125                    # TCP-style smoothing gain

    def __init__(self) -> None:
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def observe(self, x_us: float) -> None:
        self.n += 1
        if self.n == 1:
            self.mean = x_us
            self.var = 0.0
            return
        d = x_us - self.mean
        self.mean += self.ALPHA * d
        self.var = (1.0 - self.ALPHA) * (self.var + self.ALPHA * d * d)

    @property
    def p99_us(self) -> float:
        """Normal-approximation p99 with a 1 µs floor so a zero-variance
        timeline (identical modeled latencies) never hedges on FP noise."""
        return self.mean + 3.0 * math.sqrt(self.var) + 1.0


class FsError(Exception):
    pass


class NotFound(FsError, FileNotFoundError):
    """No such path, inode or partition.  Also a ``FileNotFoundError``,
    unlike the reference's: ``storage.volume.LocalMount`` raises this same
    class, so the checkpoint catches one class on either mount."""


class Exists(FsError):
    pass


class NotADirectory(FsError):
    pass


class IsADirectory(FsError):
    pass


class DirNotEmpty(FsError):
    pass


@dataclass
class _MetaPartition:
    pid: int
    start: int
    end: int
    replicas: List[str]
    status: str


@dataclass
class _DataPartition:
    pid: int
    replicas: List[str]
    status: str


# arg index of the routing inode per mutation op — used to re-route a
# payload after a WrongRange redirect (mirrors MetaPartitionSM.MUT_ROUTE)
_MUT_ROUTE = {"create_dentry": 0, "delete_dentry": 0, "link_inc": 0,
              "unlink_dec": 0, "evict": 0, "update_extents": 0}


def _route_of(payload: Tuple) -> Optional[int]:
    """The inode a mutation payload routes by, or None if the op is not
    range-routed (create_inode allocates locally, set_end is an RM task)."""
    op = payload[0]
    if op == "batch":
        for sub in payload[1]:
            r = _route_of(sub)
            if r is not None:
                return r
        return None
    idx = _MUT_ROUTE.get(op)
    if idx is None:
        return None
    arg = payload[1 + idx]
    return arg if isinstance(arg, int) else None


def _read_route_of(op: str, args: Tuple) -> Optional[int]:
    """The inode a read routes by (batch_inode_get is best-effort server
    side and never raises WrongRange, so it has no redirect route)."""
    if op in ("lookup", "get_inode", "read_dir"):
        return args[0]
    if op == "stat_version":
        kind, key = args[0], args[1]
        return key if kind == "inode" else tuple(key)[0]
    return None


class CfsClient:
    """One mounted volume from one container's point of view."""

    def __init__(self, client_id: str, net: Network, rm: Any,
                 meta_nodes: Dict[str, Any], data_nodes: Dict[str, Any],
                 volume: str, rng_seed: int = 0, coalesce_meta: bool = True):
        self.client_id = client_id
        self.net = net
        self.rm = rm
        self.meta_nodes = meta_nodes
        self.data_nodes = data_nodes
        self.volume = volume
        self.rng = random.Random(rng_seed)
        self._seq = 0
        self.pipeline_depth = PIPELINE_DEPTH
        # coalesce colocated metadata mutations into one partition round-trip
        # (λFS/AsyncFS-style batched RPCs); off = the scatter path the paper's
        # Fig. 3 workflows describe step by step
        self.coalesce_meta = coalesce_meta
        # ---- read path knobs (window + hedging) ----
        self.read_window = READ_WINDOW
        self.hedge_reads = HEDGE_READS
        # ---- async metadata commits (CFS_META_ASYNC) ----
        self.meta_async = META_ASYNC
        self.meta_journal_depth = META_JOURNAL_DEPTH
        # per-partition unacked window: (timeline_epoch, ack_us, commit_us)
        # of each in-flight async mutation.  A full window stalls on the
        # oldest EARLY ack (leader FIFO ⇒ acks arrive in send order); the
        # background commit stays pending in _meta_commit_hw until the next
        # durability barrier.  Epoch stamps drop entries parked across a
        # benchmark-phase timeline reset
        self._meta_unacked: Dict[int, List[Tuple[int, float, float]]] = {}
        # per-partition high-water of background commit times this epoch:
        # commits are FIFO through the leader's journal, so the latest one
        # covers the whole acked prefix — drain_meta_window waits on it
        self._meta_commit_hw: Dict[int, Tuple[int, float]] = {}
        # ---- caches (§2.4) ----
        # the meta table is kept sorted by range start (bisect routing) and
        # keyed by the RM's routing epoch; -1 = never synced
        self.meta_partitions: List[_MetaPartition] = []
        self._mp_starts: List[int] = []
        self.routing_epoch = -1
        # sibling pid -> old pid whose range a split re-homed onto it; the
        # first mutation routed to the sibling drains the old partition's
        # async journal window first (the barrier discipline extended to
        # split-created partitions)
        self._rehomed_from: Dict[int, int] = {}
        self.data_partitions: List[_DataPartition] = []
        # leader_cache holds WRITE leaders only (PB/raft), learned from
        # accepted mutations and NotLeader hints.  Read-serving replicas go
        # into read_affinity — a follower that happens to serve a read must
        # never redirect the next write (leader-cache poisoning bug).
        self.leader_cache: Dict[str, str] = {}       # group id -> node id
        self.read_affinity: Dict[str, str] = {}      # group id -> node id
        self.dentry_cache: Dict[Tuple[int, str], Dict] = {}
        self.inode_cache: Dict[int, Dict] = {}
        self.orphan_inodes: List[int] = []           # local orphan list (§2.6)
        # per-group + client-wide read-latency EWMAs feeding the hedge budget
        self._read_lat: Dict[str, _LatencyEwma] = {}
        self._read_lat_all = _LatencyEwma()
        # per-inode write version: bumped on every write/truncate through
        # this client so readahead caches on OTHER handles of the same file
        # self-invalidate (cross-CLIENT writes stay relaxed, §2.7 — no
        # leases, like kernel readahead over NFS)
        self._ino_wver: Dict[int, int] = {}
        self.stats = {"rm_calls": 0, "meta_calls": 0, "data_calls": 0,
                      "cache_hits": 0, "retries": 0,
                      "meta_batched_ops": 0, "meta_saved_roundtrips": 0,
                      "hedged_reads": 0, "ra_hits": 0,
                      # ---- metadata session (lease/version) counters ----
                      "meta_cache_hits": 0, "meta_cache_misses": 0,
                      "neg_hits": 0, "lease_revalidations": 0,
                      "meta_stale_max_us": 0.0,
                      "rm_syncs_suppressed": 0,
                      # ---- async metadata commit counters ----
                      "meta_async_acks": 0, "meta_async_stalls": 0,
                      "meta_barriers": 0, "meta_barrier_stalls": 0,
                      "meta_barrier_stall_us": 0.0,
                      # ---- split-aware routing counters ----
                      "wrong_range_redirects": 0,
                      # ---- tiered extent-cache counters ----
                      "data_cache_hits": 0, "data_cache_misses": 0,
                      # ---- multi-tenant QoS counters (CFS_QOS) ----
                      "qos_sheds": 0, "qos_shed_retries": 0,
                      "qos_backoff_us": 0.0}
        # lease/version session over the inode/dentry caches (TTL knobs
        # CFS_META_TTL / CFS_META_NEG_TTL; ttl 0 = seed sync-on-open)
        from .meta_session import MetaSession
        self.session = MetaSession(self)
        # tiered RAM + simulated-SSD extent cache; None = no cache
        self.cache_write_through = CACHE_WRITE_THROUGH
        self.data_cache: Optional[TieredExtentCache] = None
        if CLIENT_CACHE and (CACHE_RAM_MB > 0 or CACHE_SSD_MB > 0):
            self.data_cache = TieredExtentCache(
                client_id, net, volume,
                CACHE_RAM_MB << 20, CACHE_SSD_MB << 20)
        # routing-miss resync limiter (one RM round-trip per window)
        self.sync_window_us = SYNC_WINDOW_US
        self._last_sync_us: Optional[float] = None
        self.sync_partitions(force=True)

    # ------------------------------------------------------------ QoS tenant
    def _tag(self) -> None:
        """Stamp the current op with this client's ``(volume, client)``
        tenant at the RPC funnels.  Sub-ops inherit the tag through
        ``Network.begin_op`` and fork branches share the OpTimer, so one
        stamp covers the whole call tree — the benchmark's outer op is
        opened by the driver, which knows nothing about volumes."""
        op = self.net.current_op
        if op is not None and op.tenant is None:
            op.tenant = (self.volume, self.client_id)

    def qos_volume_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-volume QoS breakdown: timed RPCs and absorbed queueing per
        tenant volume (from the network's attribution ledger, shared by
        every client on the cluster) merged with this client's shed/backoff
        counters, attributed to its own volume.  Refreshed into
        ``stats["per_volume"]`` so benchmark dumps and ``qos_report`` can
        name the offending tenant, not just the saturated resource."""
        per: Dict[str, Dict[str, float]] = {}
        for vol in sorted(self.net.tenant_stats):
            ts = self.net.tenant_stats[vol]
            per[vol] = {"rpcs": ts["rpcs"],
                        "queued_us": round(ts["queued_us"], 3),
                        "sheds": 0, "retries": 0}
        mine = per.setdefault(self.volume, {"rpcs": 0, "queued_us": 0.0,
                                            "sheds": 0, "retries": 0})
        mine["sheds"] = self.stats["qos_sheds"]
        mine["retries"] = self.stats["qos_shed_retries"]
        self.stats["per_volume"] = per
        return per

    # ------------------------------------------------------------------ RM
    def sync_partitions(self, force: bool = False,
                        min_epoch: Optional[int] = None) -> bool:
        """One-shot RPC to the RM (non-persistent connection).

        Unforced calls come from routing misses and are rate-limited to one
        round-trip per ``sync_window_us`` of virtual time: a burst of
        misses (e.g. a split-fresh inode range fanned across many procs)
        costs ONE RM exchange, the rest reuse the just-fetched view.
        Returns False when the sync was suppressed.  A suppressed miss can
        therefore surface a NotFound that a fresh view would have resolved
        — deliberate *bounded routing staleness*, capped at one window
        (default 1 ms of virtual time, three orders of magnitude tighter
        than the 1 s metadata lease TTL the namespace already tolerates);
        recovery paths always ``force`` and are never stale.

        ``min_epoch`` is the WrongRange-redirect channel: the caller needs a
        table at least that new.  If the cached table already satisfies it
        there is nothing to fetch and no RPC happens at all — the epoch gate
        that bounds a post-split burst of redirects across many procs to
        ONE RM exchange per client.  Otherwise the fetch bypasses the
        window (it is a recovery path) but still stamps ``_last_sync_us``."""
        self._tag()
        op = self.net.current_op
        now = op.now_us if op is not None and op.timed else None
        if min_epoch is not None:
            if self.routing_epoch >= min_epoch:
                return False
            force = True
        if (not force and now is not None and self._last_sync_us is not None
                and self.sync_window_us > 0
                and 0.0 <= now - self._last_sync_us < self.sync_window_us):
            # strictly within the window: suppress.  A NEGATIVE delta (this
            # op's timeline starts before the last sync — e.g. a new
            # benchmark phase restarting virtual time) is out-of-window:
            # suppressing there would cap nothing and could starve resyncs
            # for the rest of the phase.
            self.stats["rm_syncs_suppressed"] += 1
            return False
        leader = self.rm.leader_id()
        view = self.net.call(self.client_id, leader, self.rm.client_view,
                             self.volume, self.routing_epoch,
                             kind="client.rm")
        self.stats["rm_calls"] += 1
        if now is not None:
            self._last_sync_us = op.now_us      # the reply's arrival time
        if not view.get("unchanged"):
            self._install_view(view)
        return True

    def _install_view(self, view: Dict[str, Any]) -> None:
        """Swap in a fresh partition table (sorted by range start for the
        bisect router) and reconcile per-partition client state with any
        range changes a split made underneath us."""
        old = {mp.pid: mp for mp in self.meta_partitions}
        mps = sorted((_MetaPartition(**m) for m in view["meta"]),
                     key=lambda m: m.start)
        self.meta_partitions = mps
        self._mp_starts = [m.start for m in mps]
        self.data_partitions = [_DataPartition(**d) for d in view["data"]]
        self.routing_epoch = view.get("epoch", self.routing_epoch)
        new_pids = {m.pid: m for m in mps}
        for m in mps:
            prev = old.get(m.pid)
            if prev is None or m.end >= prev.end:
                continue
            # a split shrank this partition's range: remember which old pid
            # covered each split-created sibling so the first dependent
            # mutation routed there drains the old journal window first
            for q in mps:
                if q.pid not in old and prev.start <= q.start <= prev.end:
                    self._rehomed_from.setdefault(q.pid, m.pid)
        for pid in old:
            if pid not in new_pids:
                # partition left the table (manual migration/teardown):
                # settle its async window and drop its routing caches
                self.drain_meta_window(pid)
                self.leader_cache.pop(f"mp{pid}", None)
                self.read_affinity.pop(f"mp{pid}", None)

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # --------------------------------------------------------- meta routing
    def _mp_lookup(self, ino: int) -> Optional[_MetaPartition]:
        """Bisect the start-sorted table: rightmost partition whose range
        starts at or before ``ino`` is the only possible cover (ranges are
        disjoint) — O(log n) once auto-split yields hundreds of entries."""
        i = bisect.bisect_right(self._mp_starts, ino) - 1
        if i >= 0:
            mp = self.meta_partitions[i]
            if mp.start <= ino <= mp.end:
                return mp
        return None

    def _mp_for_inode(self, ino: int) -> _MetaPartition:
        mp = self._mp_lookup(ino)
        if mp is None and self.sync_partitions():   # miss: resync (rate-limited)
            mp = self._mp_lookup(ino)
        if mp is None:
            raise NotFound(f"no meta partition covers inode {ino}")
        return mp

    def _writable_mps(self) -> List[_MetaPartition]:
        return [mp for mp in self.meta_partitions if mp.status == "rw"]

    def _meta_propose(self, mp: _MetaPartition, payload: Any,
                      seq: Optional[int] = None) -> Any:
        """Mutating op with split-aware routing: a ``WrongRange`` NAK from a
        range-cut partition is followed exactly once — one epoch-gated table
        resync (at most one RM exchange per client per cut, regardless of
        how many procs race the split), one re-route.  A second WrongRange
        is a real routing fault and surfaces as NotFound."""
        seq = self._next_seq() if seq is None else seq
        self._rehome_barrier(mp.pid)
        try:
            return self._meta_propose_once(mp, payload, seq)
        except WrongRange as e:
            route = _route_of(payload)
            if route is None:
                raise FsError(f"unroutable payload after range cut: "
                              f"{payload[0]}") from e
            self.stats["wrong_range_redirects"] += 1
            # the misrouted mutation may depend on acked-but-uncommitted
            # mutations parked on the shrunk partition's journal — settle
            # them before re-homing (cross-partition barrier discipline)
            self.drain_meta_window(mp.pid)
            self.sync_partitions(min_epoch=e.epoch)
            mp2 = self._mp_lookup(route)
            if mp2 is None or mp2.pid == mp.pid:
                raise NotFound(
                    f"no meta partition covers inode {route}") from e
            self._rehome_barrier(mp2.pid)
            return self._meta_propose_once(mp2, payload, seq)

    def _rehome_barrier(self, pid: int) -> None:
        """One-time drain of the old partition's async journal window before
        the FIRST mutation routed to the split-created sibling covering its
        former range (later cross-partition dependencies are handled by the
        explicit drains in create/link/unlink/rename/meta_batch)."""
        src = self._rehomed_from.pop(pid, None)
        if src is not None and src != pid:
            self.drain_meta_window(src)

    def _meta_propose_once(self, mp: _MetaPartition, payload: Any,
                           seq: int) -> Any:
        """Mutating op through the partition's raft leader, with leader cache
        + retry.  Session (client_id, seq) deduplicates retries.

        Under ``meta_async`` (timed ops only) the mutation goes through the
        leader's ``propose_async`` journal path and is pipelined exactly
        like the data path's append window: the RPC runs as a timed sub-op,
        the client continues the moment the request leaves its NIC
        (``tx_done_us``), and the ack/commit times are parked in the
        partition's bounded unacked window.  A full window stalls on the
        oldest in-flight EARLY ack; durability barriers
        (:meth:`drain_meta_window`) wait on the background-commit
        high-water instead."""
        self._tag()
        gid = f"mp{mp.pid}"
        order = self._replica_order(gid, mp.replicas)
        last_err: Exception = NotFound(gid)
        op = self.net.current_op
        window: Optional[List[Tuple[int, float]]] = None
        if (self.meta_async and self.meta_journal_depth > 0
                and op is not None and op.timed):
            window = self._meta_unacked.setdefault(mp.pid, [])
            # entries parked across a timeline reset belong to a dead clock
            window[:] = [e for e in window
                         if e[0] == self.net.timeline_epoch]
            if len(window) >= self.meta_journal_depth:
                # window full: wait for the oldest in-flight early ack
                # (leader FIFO ⇒ acks arrive in send order); its background
                # commit stays pending until the next durability barrier
                _ep, ack, _commit = window.pop(0)
                self.stats["meta_async_stalls"] += 1
                op.advance_to(ack)
        for attempt in range(MAX_RETRIES):
            for nid in order:
                sub: Optional[OpTimer] = None
                try:
                    if window is not None:
                        # timed sub-op: the round's NIC/CPU occupancy is
                        # real, but the client op only pays the request
                        # transmit — the ack and the raft round complete in
                        # the background (mirrors the append pipeline)
                        sub = self.net.begin_op(at=op.now_us)
                        try:
                            env = self.net.call(
                                self.client_id, nid,
                                self.meta_nodes[nid].propose_async,
                                mp.pid, payload, self.client_id, seq,
                                kind="client.meta")
                        finally:
                            self.net.end_op()
                        res = env["v"]
                    else:
                        res = self.net.call(
                            self.client_id, nid, self.meta_nodes[nid].propose,
                            mp.pid, payload, self.client_id, seq,
                            kind="client.meta")
                    self.stats["meta_calls"] += 1
                    self.leader_cache[gid] = nid
                    if window is not None:
                        self.stats["meta_async_acks"] += 1
                        op.advance_to(sub.tx_done_us)
                        ep = self.net.timeline_epoch
                        window.append((ep, sub.now_us, env["commit_us"]))
                        hw = self._meta_commit_hw.get(mp.pid)
                        if (hw is None or hw[0] != ep
                                or env["commit_us"] > hw[1]):
                            self._meta_commit_hw[mp.pid] = \
                                (ep, env["commit_us"])
                        if _san.SAN is not None:
                            _san.SAN.check_mvcc_read(mp.pid, env["mvcc"], op)
                            _san.SAN.note_async_ack(
                                (self.client_id, mp.pid), env["commit_us"],
                                op, (self.net.net_serial, ep))
                    # session write-through: refresh/drop the cached entries
                    # this mutation touched (read-your-writes, zero staleness
                    # for the mutating client)
                    self.session.note_mutation(payload, res)
                    return res
                except WrongRange:
                    if sub is not None:
                        # the NAK is a full round trip on the client clock
                        op.advance_to(sub.now_us)
                    raise
                except NotLeader as e:
                    last_err = e
                    if sub is not None:
                        # a NAK is still a round trip: the client only
                        # learns it must re-route when the error lands
                        op.advance_to(sub.now_us)
                    if e.leader_hint and e.leader_hint in mp.replicas:
                        order = [e.leader_hint]
                    continue
                except (NetError, NotCommitted) as e:
                    last_err = e
                    if sub is not None:
                        op.advance_to(sub.now_us)
                    self.stats["retries"] += 1
                    continue
            order = list(mp.replicas)
        raise last_err

    def _meta_read(self, mp: _MetaPartition, op: str, *args: Any,
                   method: str = "read", reply_bytes: int = 64) -> Any:
        """Routed read with the same one-shot WrongRange redirect as
        :meth:`_meta_propose` — a stale table never turns into a stale
        serve or a spurious ENOENT for an inode the split re-homed."""
        try:
            return self._meta_read_once(mp, op, *args, method=method,
                                        reply_bytes=reply_bytes)
        except WrongRange as e:
            route = _read_route_of(op, args)
            if route is None:
                raise
            self.stats["wrong_range_redirects"] += 1
            self.sync_partitions(min_epoch=e.epoch)
            mp2 = self._mp_lookup(route)
            if mp2 is None or mp2.pid == mp.pid:
                raise NotFound(
                    f"no meta partition covers inode {route}") from e
            return self._meta_read_once(mp2, op, *args, method=method,
                                        reply_bytes=reply_bytes)

    def _meta_read_once(self, mp: _MetaPartition, op: str, *args: Any,
                        method: str = "read", reply_bytes: int = 64) -> Any:
        """Leader-local read with replica failover.  ``method="read_leased"``
        returns the session envelope (value + partition mvcc + TTL grant);
        ``reply_bytes`` sizes the reply on the wire — ``stat_version``
        replies are a fraction of a full inode refetch."""
        self._tag()
        gid = f"mp{mp.pid}"
        order = self._read_order(gid, mp.replicas)
        last_err: Exception = NotFound(gid)
        for nid in order:
            try:
                res = self.net.call(
                    self.client_id, nid, getattr(self.meta_nodes[nid], method),
                    mp.pid, op, *args, reply_bytes=reply_bytes,
                    kind="client.meta")
                self.stats["meta_calls"] += 1
                self.read_affinity[gid] = nid
                return res
            except (NetError, KeyError) as e:
                last_err = e
                continue
        raise last_err

    def _replica_order(self, gid: str, replicas: List[str]) -> List[str]:
        """Write routing: cached WRITE leader first, then the rest (paper
        §2.4 leader cache).  Reads never feed this cache — see
        ``_read_order``."""
        cached = self.leader_cache.get(gid)
        if cached and cached in replicas:
            return [cached] + [r for r in replicas if r != cached]
        return list(replicas)

    def _read_order(self, gid: str, replicas: List[str]) -> List[str]:
        """Read routing: the replica that last served us (read affinity)
        first — after a hedge that is the replica that beat the straggler —
        then the cached write leader, then the rest."""
        order: List[str] = []
        aff = self.read_affinity.get(gid)
        if aff and aff in replicas:
            order.append(aff)
        cached = self.leader_cache.get(gid)
        if cached and cached in replicas and cached not in order:
            order.append(cached)
        order.extend(r for r in replicas if r not in order)
        return order

    # --------------------------------------------------------- data routing
    def _writable_dps(self) -> List[_DataPartition]:
        dps = [dp for dp in self.data_partitions if dp.status == "rw"]
        if not dps:
            self.sync_partitions(force=True)
            dps = [dp for dp in self.data_partitions if dp.status == "rw"]
        if not dps:
            # volume ran out of writable partitions — the RM auto-expands
            # (§2.3.1 "automatically adds a set of new partitions")
            try:
                leader = self.rm.leader_id()
                self.net.call(self.client_id, leader, self.rm.check_volumes,
                              kind="client.rm")
            except (NetError, RuntimeError):
                # RM unreachable or out of allocatable nodes: stay in the
                # client's error channel, don't leak the RM internals
                pass
            self.sync_partitions(force=True)
            dps = [dp for dp in self.data_partitions if dp.status == "rw"]
        if not dps:
            raise FsError("no writable data partitions")
        return dps

    def _pick_dp(self) -> _DataPartition:
        # the client selects partitions RANDOMLY from the RM-allocated set to
        # avoid asking the RM for up-to-date utilization (§2.3.1)
        return self.rng.choice(self._writable_dps())

    def _dp(self, pid: int) -> _DataPartition:
        for dp in self.data_partitions:
            if dp.pid == pid:
                return dp
        if self.sync_partitions():      # miss: resync (rate-limited)
            for dp in self.data_partitions:
                if dp.pid == pid:
                    return dp
        raise NotFound(f"data partition {pid}")

    def _data_call(self, dp: _DataPartition, method: str, *args: Any,
                   nbytes: int = 256) -> Any:
        """Data-partition WRITE (append/small/overwrite): cached write
        leader first (PB leader == replicas[0] by construction when the
        cache is cold), following NotLeader hints.  A stale or poisoned
        cache entry costs a NAK round-trip before the hint redirects —
        which is why read-serving replicas must never land in
        ``leader_cache``."""
        self._tag()
        gid = f"dp{dp.pid}"
        queue = self._replica_order(gid, dp.replicas)
        last_err: Exception = NotFound(gid)
        tried = 0
        while queue and tried < 2 * max(len(dp.replicas), 1):
            nid = queue.pop(0)
            tried += 1
            try:
                res = self.net.call(
                    self.client_id, nid,
                    getattr(self.data_nodes[nid], method),
                    dp.pid, *args, nbytes=nbytes, kind="client.data")
                self.stats["data_calls"] += 1
                self.leader_cache[gid] = nid
                return res
            except NotLeader as e:
                last_err = e
                self.stats["retries"] += 1
                hint = e.leader_hint
                if hint and hint in dp.replicas and hint != nid:
                    queue = [hint] + [n for n in queue if n != hint]
                continue
            except NetError as e:
                last_err = e
                self.stats["retries"] += 1
                continue
        if isinstance(last_err, NotLeader):
            # terminal leaderless state (e.g. mid-election, or a hint outside
            # our partition view): surface it on the callers' error channel —
            # they catch FsError/NetError and run the report-timeout /
            # resync / re-route recovery, not raw raft internals
            raise FsError(f"no write leader for {gid}: {last_err}")
        raise last_err

    # ----------------------------------------------------- batched meta RPCs
    def _batch_propose(self, mp: _MetaPartition, subs: List[Tuple]) -> List[Any]:
        """ONE round-trip applying ``subs`` atomically on one partition."""
        if len(subs) == 1:
            return [self._meta_propose(mp, subs[0])]
        res = self._meta_propose(mp, ("batch", list(subs)))
        self.stats["meta_batched_ops"] += len(subs)
        self.stats["meta_saved_roundtrips"] += len(subs) - 1
        return res

    def meta_batch(self, ops: List[Tuple[int, Tuple]]) -> List[Any]:
        """Batched metadata mutations: ``ops`` is [(route_inode, payload)].

        Ops routed to the SAME partition coalesce into one raft round-trip
        (applied atomically, in order); ops for different partitions are
        pipelined back-to-back, one round-trip per partition.  Results come
        back in input order."""
        groups: Dict[int, Tuple[_MetaPartition, List[int], List[Tuple]]] = {}
        order: List[int] = []
        for i, (route_ino, payload) in enumerate(ops):
            mp = self._mp_for_inode(route_ino)
            if mp.pid not in groups:
                groups[mp.pid] = (mp, [], [])
                order.append(mp.pid)
            groups[mp.pid][1].append(i)
            groups[mp.pid][2].append(payload)
        results: List[Any] = [None] * len(ops)
        prev_pid: Optional[int] = None
        for pid in order:
            if prev_pid is not None:
                # dependent cross-partition sub-ops serialize on the
                # journal: the earlier partition's async window drains
                # before the later partition's mutation is proposed
                self.drain_meta_window(prev_pid)
            mp, idxs, subs = groups[pid]
            for i, res in zip(idxs, self._batch_propose(mp, subs)):
                results[i] = res
            prev_pid = pid
        return results

    # ============================================================ metadata ops
    def create_inode(self, itype: int = InodeType.FILE,
                     link_target: bytes = b"") -> Dict:
        """Fig. 3 step 1: ask an available (random writable) meta partition."""
        seq = self._next_seq()
        mps = self._writable_mps()
        self.rng.shuffle(mps)
        last: Exception = FsError("no writable meta partitions")
        for mp in mps:
            try:
                return self._meta_propose(
                    mp, ("create_inode", itype, link_target, 0.0), seq=seq)
            except (PartitionFull, RangeExhausted) as e:
                last = e
                continue
        # every cached partition is full: ask the RM to split / expand,
        # resync the routing table, then retry across the fresh view
        try:
            leader = self.rm.leader_id()
            self.net.call(self.client_id, leader, self.rm.check_volumes,
                          kind="client.rm")
        except (NetError, RuntimeError):
            pass        # RM can't help; the retry below reports the truth
        self.sync_partitions(force=True)
        mps = self._writable_mps()
        self.rng.shuffle(mps)
        for mp in mps:
            try:
                return self._meta_propose(
                    mp, ("create_inode", itype, link_target, 0.0), seq=seq)
            except (PartitionFull, RangeExhausted) as e:
                last = e
                continue
        raise last

    def create(self, parent: int, name: str,
               itype: int = InodeType.FILE, link_target: bytes = b"") -> Dict:
        """Create-file workflow.

        Fast path (``coalesce_meta``): the dentry must live on the parent's
        partition, so when that partition can also allocate the inode, the
        whole create — inode + dentry (+ parent nlink for a subdirectory) —
        is ONE batched round-trip applied atomically.  No orphan window.

        Fallback = the paper's Fig. 3 scatter workflow: inode on a random
        writable partition, then the dentry; on dentry failure unlink the
        inode and push it to the orphan list."""
        if self.coalesce_meta:
            mp = self._mp_for_inode(parent)
            if mp.status == "rw":
                subs: List[Tuple] = [
                    ("create_inode", itype, link_target, 0.0),
                    ("create_dentry", parent, name, ("ref", 0, "inode"),
                     itype),
                ]
                if itype == InodeType.DIR:
                    subs.append(("link_inc", parent))
                try:
                    res = self._batch_propose(mp, subs)
                except DentryExists:
                    raise Exists(f"{parent}/{name}")
                except (PartitionFull, RangeExhausted):
                    res = None      # partition can't allocate; scatter below
                if res is not None:
                    # the propose hook noted inode + dentry into the session
                    return res[0]
        inode = self.create_inode(itype, link_target)
        ino = inode["inode"]
        # one-directional invariant (§2.6): a dentry may only reference an
        # inode that is durable first — drain the inode partition's async
        # window before the dentry lands on another partition
        self.drain_meta_window(self._mp_for_inode(ino).pid)
        try:
            self._create_dentry(parent, name, ino, itype)
        except Exception:
            # Fig. 3 failure arm: unlink + orphan-list + (later) evict
            try:
                mp = self._mp_for_inode(ino)
                self._meta_propose(mp, ("unlink_dec", ino))
            except Exception:
                pass
            self.orphan_inodes.append(ino)
            raise
        if itype == InodeType.DIR:
            # subdirectory contributes ".." to the parent
            self._meta_propose(self._mp_for_inode(parent), ("link_inc", parent))
        return inode

    def _create_dentry(self, parent: int, name: str, ino: int,
                       dtype: int) -> Dict:
        """The dentry lives on the partition owning the PARENT inode —
        inode and dentry of one file may be on different nodes (§2.6)."""
        mp = self._mp_for_inode(parent)
        try:
            return self._meta_propose(
                mp, ("create_dentry", parent, name, ino, dtype))
        except DentryExists:
            raise Exists(f"{parent}/{name}")

    def link(self, ino: int, parent: int, name: str) -> Dict:
        """Fig. 3 'link': nlink += 1 first, then the dentry; rollback on fail."""
        mp_i = self._mp_for_inode(ino)
        inode = self._meta_propose(mp_i, ("link_inc", ino))
        # the new dentry depends on the nlink bump being durable first
        self.drain_meta_window(mp_i.pid)
        try:
            return self._create_dentry(parent, name, ino, inode["type"])
        except Exception:
            self._meta_propose(mp_i, ("unlink_dec", ino))
            raise

    def unlink(self, parent: int, name: str) -> Optional[int]:
        """Fig. 3 'unlink': delete dentry FIRST; only then unlink the inode.
        Returns the inode id if it reached the orphan/evict threshold."""
        mp_p = self._mp_for_inode(parent)
        try:
            dentry = self._meta_propose(mp_p, ("delete_dentry", parent, name))
        except NoSuchDentry:
            raise NotFound(f"{parent}/{name}")
        ino = dentry["inode"]
        # the nlink decrement must not outrun the dentry delete's durability
        self.drain_meta_window(mp_p.pid)
        try:
            mp_i = self._mp_for_inode(ino)
            inode = self._meta_propose(mp_i, ("unlink_dec", ino))
        except Exception:
            # all retries failed: this inode is now an orphan the admin may
            # need to resolve (§2.6.3); remember it locally regardless
            self.orphan_inodes.append(ino)
            return ino
        thresh = 2 if inode["type"] == InodeType.DIR else 0
        if inode["nlink"] <= thresh:
            self.orphan_inodes.append(ino)
        self.session.forget_inode(ino)
        return ino

    def remove(self, parent: int, name: str, ino: int,
               dec_parent_link: bool = False) -> Optional[Dict]:
        """Coalesced remove for a caller that already resolved ``name`` to
        ``ino`` (the VFS always has): dentry delete, nlink decrement, the
        eviction of a now-orphan inode, and (for rmdir) the parent's ".."
        decrement collapse into as few partition round-trips as possible —
        ONE when inode and dentry colocate.  Falls back to the scatter
        workflow when coalescing is off.  Returns the evict result (with the
        extent keys to free) if the inode was reclaimed, else None."""
        if not self.coalesce_meta:
            self.unlink(parent, name)
            if dec_parent_link:
                mp = self._mp_for_inode(parent)
                self._meta_propose(mp, ("unlink_dec", parent))
            self.evict_orphans()
            return None
        mp_p = self._mp_for_inode(parent)
        mp_i = self._mp_for_inode(ino)
        colocated = mp_i.pid == mp_p.pid
        subs: List[Tuple] = [("delete_dentry", parent, name)]
        if colocated:
            subs.append(("unlink_dec", ino))
            subs.append(("evict", ino))
        if dec_parent_link:
            subs.append(("unlink_dec", parent))
        try:
            res = self._batch_propose(mp_p, subs)
        except NoSuchDentry:
            raise NotFound(f"{parent}/{name}")
        except NoSuchInode:
            # invariant says this can't happen for a live dentry, but a lost
            # inode must not wedge the namespace: scatter path cleans up
            self.unlink(parent, name)
            if dec_parent_link:
                self._meta_propose(mp_p, ("unlink_dec", parent))
            self.evict_orphans()
            return None
        self.session.forget_inode(ino)
        evict_res: Optional[Dict] = None
        if colocated:
            evict_res = res[2]
        else:
            # inode lives elsewhere: one more (batched) round-trip there —
            # serialized behind the dentry delete's background commit
            self.drain_meta_window(mp_p.pid)
            try:
                dec, evict_res = self._batch_propose(
                    mp_i, [("unlink_dec", ino), ("evict", ino)])
            except Exception:
                self.orphan_inodes.append(ino)
                return None
        if evict_res and evict_res.get("ok"):
            self._free_extents(evict_res["extents"], evict_res["size"])
            return evict_res
        return None

    def rename_entry(self, src_parent: int, src_name: str,
                     dst_parent: int, dst_name: str,
                     ino: int, itype: int) -> None:
        """rename(2): move the dentry; the moved inode's nlink ends where it
        started.

        When both parents colocate, the whole move is one atomic batch and
        the inode is never touched.  Across partitions the two dentry ops
        are separate round-trips, so the nlink is BRACKETED (inc before the
        copy, dec after the delete): at every intermediate step nlink still
        equals the number of referencing dentries, and a crash between the
        round-trips leaves an alias, never an undercounted inode whose
        eviction would dangle the surviving dentry.  (The seed's link+unlink
        spelling did this too, but flagged a directory MARK_DELETED at its
        live floor of 2 — fixed in ``_ap_unlink_dec``.)  Directory ".."
        accounting moves between the two parents when they differ."""
        cross_dir = dst_parent != src_parent
        mp_src = self._mp_for_inode(src_parent)
        mp_dst = self._mp_for_inode(dst_parent)
        if self.coalesce_meta and mp_src.pid == mp_dst.pid:
            subs: List[Tuple] = [
                ("create_dentry", dst_parent, dst_name, ino, itype)]
            if itype == InodeType.DIR and cross_dir:
                subs.append(("link_inc", dst_parent))
            subs.append(("delete_dentry", src_parent, src_name))
            if itype == InodeType.DIR and cross_dir:
                subs.append(("unlink_dec", src_parent))
            try:
                self._batch_propose(mp_src, subs)
            except DentryExists:
                raise Exists(f"{dst_parent}/{dst_name}")
            except NoSuchDentry:
                raise NotFound(f"{src_parent}/{src_name}")
        else:
            mp_i = self._mp_for_inode(ino)
            self._meta_propose(mp_i, ("link_inc", ino))
            # each step of the bracket depends on the previous partition's
            # mutation being durable: serialize on the async windows
            self.drain_meta_window(mp_i.pid)
            try:
                self._create_dentry(dst_parent, dst_name, ino, itype)
                if itype == InodeType.DIR and cross_dir:
                    self._meta_propose(mp_dst, ("link_inc", dst_parent))
            except Exception:
                self._meta_propose(mp_i, ("unlink_dec", ino))
                raise
            self.drain_meta_window(mp_dst.pid)
            try:
                self._meta_propose(
                    mp_src, ("delete_dentry", src_parent, src_name))
            except NoSuchDentry:
                raise NotFound(f"{src_parent}/{src_name}")
            if itype == InodeType.DIR and cross_dir:
                self._meta_propose(mp_src, ("unlink_dec", src_parent))
            self.drain_meta_window(mp_src.pid)
            self._meta_propose(mp_i, ("unlink_dec", ino))
        # the propose hook dropped the src dentry (negative entry) and noted
        # the dst dentry into the session as the batch/scatter ops landed

    def evict_orphans(self) -> int:
        """Send evict for locally tracked orphans; free their data (async)."""
        evicted = 0
        remaining: List[int] = []
        for ino in self.orphan_inodes:
            try:
                mp = self._mp_for_inode(ino)
                res = self._meta_propose(mp, ("evict", ino))
                if res["ok"]:
                    evicted += 1
                    self._free_extents(res["extents"], res["size"])
                # not ok => inode still live (e.g. relinked); drop it either way
            except Exception:
                remaining.append(ino)
        self.orphan_inodes = remaining
        return evicted

    def _free_extents(self, extents: List[Tuple], size: int) -> None:
        """§2.7.3 cleanup: large-file extents are deleted outright; small-file
        content is punch-holed out of its shared extent."""
        for (pid, eid, _foff, eoff, esize) in extents:
            try:
                dp = self._dp(pid)
            except NotFound:
                continue
            small = esize <= SMALL_FILE_THRESHOLD and eoff != 0 or (
                esize < SMALL_FILE_THRESHOLD and size <= SMALL_FILE_THRESHOLD)
            if self.data_cache is not None:
                # local invalidation only — peers with the shared extent
                # still cached serve stale bytes until their lease expires
                # (the bounded-staleness contract the sanitizer audits)
                lo, hi = (eoff, eoff + esize) if small else (0, MAX_UINT64)
                self.data_cache.invalidate_extent_range(pid, eid, lo, hi)
            for nid in dp.replicas:
                try:
                    if small:
                        self.net.call(self.client_id, nid,
                                      self.data_nodes[nid].serve_punch_hole,
                                      pid, eid, eoff, esize, kind="client.data")
                    else:
                        self.net.call(self.client_id, nid,
                                      self.data_nodes[nid].serve_delete_extent,
                                      pid, eid, kind="client.data")
                except NetError:
                    continue

    # ---- lookups -------------------------------------------------------------
    # Thin compat shims over the MetaSession surface: the session decides
    # between the lease/version contract (timed op, TTL > 0) and the seed
    # paths (untimed, or CFS_META_TTL=0).  New code — the VFS, benchmarks —
    # talks to ``client.session`` directly.
    def lookup(self, parent: int, name: str, use_cache: bool = True) -> Dict:
        return self.session.lookup(parent, name, authoritative=not use_cache)

    def get_inode(self, ino: int, use_cache: bool = False) -> Dict:
        return self.session.getattr(ino, use_cache=use_cache)

    def readdir(self, parent: int) -> List[Dict]:
        return self.session.readdir(parent)

    def readdir_plus(self, parent: int) -> List[Dict]:
        """DirStat path (§4.2): readdir, then ONE batchInodeGet per meta
        partition instead of per-file inodeGet; results cached client-side."""
        return self.session.readdir_plus(parent)

    def update_extents(self, ino: int, size: int,
                       extents: List[ExtentKey]) -> Dict:
        mp = self._mp_for_inode(ino)
        # the propose hook notes the returned inode view into the session
        return self._meta_propose(
            mp, ("update_extents", ino, size,
                 [e.as_tuple() for e in extents], 0.0))

    # ============================================================== file I/O
    def open(self, ino: int, mode: str = "r") -> "CfsFile":
        """Open used to force the cached metadata synchronous (§2.4); under
        the session contract a READ open is served from a valid lease —
        staleness is bounded by the TTL instead of a per-open round-trip.
        A WRITE open stays server-fresh: the handle snapshots size/extents
        and its close() replaces the server extent map wholesale, so a
        stale view would destroy other clients' committed appends, not
        just serve old bytes.  With ``CFS_META_TTL=0`` (or outside a timed
        op) every open is the seed's force-sync."""
        inode = self.session.getattr(ino, sync=mode != "r")
        if inode["type"] == InodeType.DIR:
            raise IsADirectory(str(ino))
        return CfsFile(self, inode, mode)

    # -- internal write paths used by CfsFile
    def drain_window(self, window: List[float]) -> None:
        """fsync barrier over a pipelined append window: the caller's
        virtual time advances to the last in-flight packet's chain ack (the
        commit point of the highest offset implies every earlier packet's
        prefix is committed, so one wait covers the whole window)."""
        if window:
            op = self.net.current_op
            if op is not None and op.timed:
                op.advance_to(max(window))
            window.clear()

    def drain_meta_window(self, pid: Optional[int] = None) -> None:
        """Durability barrier over the async metadata unacked windows: the
        caller's virtual time advances to the latest background commit
        still in flight for ``pid`` (or for EVERY partition when None).
        This is the client-visible commit point — dir-fsync drains its
        partition, close of a created file drains everything — and the
        serialization point dependent cross-partition ops wait on.  A
        no-op when async commits are off or nothing is in flight."""
        pids = [pid] if pid is not None else \
            sorted(set(self._meta_unacked) | set(self._meta_commit_hw))
        op = self.net.current_op
        for p in pids:
            window = self._meta_unacked.get(p)
            if window:
                window.clear()
            hw = self._meta_commit_hw.pop(p, None)
            if hw is None or hw[0] != self.net.timeline_epoch:
                continue
            self.stats["meta_barriers"] += 1
            t = hw[1]
            if op is not None and op.timed:
                if t > op.now_us:
                    self.stats["meta_barrier_stalls"] += 1
                    self.stats["meta_barrier_stall_us"] += t - op.now_us
                op.advance_to(t)
            if _san.SAN is not None:
                _san.SAN.check_async_barrier(
                    (self.client_id, p), op,
                    (self.net.net_serial, self.net.timeline_epoch))

    def _append_packets(self, data: bytes,
                        state: Optional[Tuple[int, int, int]] = None,
                        window: Optional[List[float]] = None
                        ) -> Tuple[List[ExtentKey], Tuple[int, int, int]]:
        """Stream ``data`` as ≤128 KB packets (Fig. 4).  ``state`` carries
        (partition_id, extent_id, extent_write_offset) across calls so a file
        keeps appending to its current extent.  Returns new extent keys and
        the updated state.  On partition failure the remaining k−p bytes are
        re-sent to a NEW extent on a different partition (§2.2.5).

        Under a *timed* op with ``window`` supplied, packets are pipelined:
        the client's frontier only advances to the moment the request left
        its NIC, the chain ack time is parked in ``window`` (bounded to
        ``pipeline_depth`` in-flight packets), and ``drain_window`` is the
        fsync barrier.  Any failed/short commit stalls the pipeline: the
        client must drain before it can decide what to re-send where."""
        keys: List[ExtentKey] = []
        pos = 0
        if state is None:
            dp = self._pick_dp()
            eid = self._new_extent_id(dp)
            state = (dp.pid, eid, 0)
        pid, eid, eoff = state
        zero_progress = 0
        op = self.net.current_op
        pipelined = (window is not None and op is not None and op.timed
                     and self.pipeline_depth > 0)
        while pos < len(data):
            packet = data[pos : pos + PACKET_SIZE]
            dp = self._dp(pid)
            pkt_op: Optional[Any] = None
            shed: Optional[Busy] = None
            if pipelined:
                send_at = op.now_us
                if len(window) >= self.pipeline_depth:
                    # window full: wait for the oldest in-flight ack (chain
                    # FIFO ⇒ acks arrive in send order)
                    send_at = max(send_at, window.pop(0))
                pkt_op = self.net.begin_op(at=send_at)
            try:
                res = self._data_call(dp, "serve_append", eid, eoff, packet,
                                      True, nbytes=len(packet) + 128)
                accepted = res.accepted
            except Busy as e:
                # admission NAK (CFS_QOS): transient overload, handled below
                # without the RO-reporting failure machinery
                accepted = 0
                shed = e
            except ExtentError as e:
                if "full" in str(e):
                    # extent reached its size cap — healthy; roll to a fresh
                    # extent on the same partition, no fault report
                    if pkt_op is not None:
                        self.net.end_op()
                        op.advance_to(pkt_op.now_us)   # client saw the NAK
                    eid = self._new_extent_id(dp)
                    eoff = 0
                    continue
                accepted = 0
            except (NetError, FsError):
                accepted = 0
            finally:
                if pkt_op is not None and self.net.current_op is pkt_op:
                    self.net.end_op()
            if pkt_op is not None:
                if accepted >= len(packet):
                    # full commit: the client moves on as soon as its NIC is
                    # free; the chain ack completes in the background
                    window.append(pkt_op.now_us)
                    op.advance_to(pkt_op.tx_done_us)
                else:
                    # short/failed commit: pipeline stall — the client only
                    # learns the committed offset from the (late) ack, and
                    # must drain everything in flight before re-routing
                    op.advance_to(pkt_op.now_us)
                    self.drain_window(window)
            if accepted > 0:
                keys.append(ExtentKey(pid, eid, -1, eoff, accepted))
                eoff += accepted
                pos += accepted
                zero_progress = 0
            else:
                zero_progress += 1
                if zero_progress > 2 * MAX_RETRIES:
                    raise FsError(
                        f"append made no progress after {zero_progress} "
                        f"partition switches (committed {pos}/{len(data)})")
            if accepted < len(packet):
                if shed is not None:
                    # Busy shed: back off by the NAK's hint and re-route the
                    # retry to another partition.  No report_timeout — the
                    # partition is healthy, just protecting another tenant's
                    # share, and marking it RO would turn transient overload
                    # into a permanent fault.  The async-meta unacked windows
                    # stay parked untouched across the shed (the durability
                    # contract): only the data window above was drained.
                    self.stats["qos_sheds"] += 1
                    self.stats["qos_shed_retries"] += 1
                    self.stats["qos_backoff_us"] += shed.retry_after_us
                    if op is not None and op.timed:
                        op.add(shed.retry_after_us)
                    dp = self._pick_dp()
                    pid = dp.pid
                    eid = self._new_extent_id(dp)
                    eoff = 0
                    continue
                # partial/failed commit: mark RO via RM and move to a fresh
                # extent on another partition for the remaining bytes
                try:
                    leader = self.rm.leader_id()
                    self.net.call(self.client_id, leader,
                                  self.rm.report_timeout, pid, kind="client.rm")
                except NetError:
                    pass
                self.sync_partitions(force=True)
                dp = self._pick_dp()
                pid = dp.pid
                eid = self._new_extent_id(dp)
                eoff = 0
        return keys, (pid, eid, eoff)

    _extent_counter = 0

    def _new_extent_id(self, dp: _DataPartition) -> int:
        """Client-generated unique extent id (partition-scoped uniqueness is
        what matters; ids are chosen so clients never collide).  crc32, not
        ``hash()``: builtin str hashing is salted per process and would break
        bit-identical same-seed reruns."""
        CfsClient._extent_counter += 1
        return ((zlib.crc32(self.client_id.encode()) & 0xFFFF) * 1_000_000
                + CfsClient._extent_counter)

    def _write_small_file(self, data: bytes) -> List[ExtentKey]:
        for _ in range(2 * MAX_RETRIES):
            dp = self._pick_dp()
            try:
                eid, off, committed = self._data_call(
                    dp, "serve_small_write", data, nbytes=len(data) + 128)
            except Busy as e:
                # admission NAK: transient, not a fault — back off by the
                # hint and retry on another partition without reporting RO
                self.stats["qos_sheds"] += 1
                self.stats["qos_shed_retries"] += 1
                self.stats["qos_backoff_us"] += e.retry_after_us
                op = self.net.current_op
                if op is not None and op.timed:
                    op.add(e.retry_after_us)
                continue
            except (NetError, FsError, ExtentError):
                # replica-local RO/failure: report so the RM flips the hard
                # status (and expands the volume if needed), then retry
                self.stats["retries"] += 1
                try:
                    leader = self.rm.leader_id()
                    self.net.call(self.client_id, leader,
                                  self.rm.report_timeout, dp.pid,
                                  kind="client.rm")
                except NetError:
                    pass
                self.sync_partitions(force=True)
                continue
            if committed >= len(data):
                return [ExtentKey(dp.pid, eid, 0, off, len(data))]
            # failed mid-chain: partition went RO; retry elsewhere (the
            # committed copy is unreferenced garbage reclaimed by punch-hole)
            self.sync_partitions(force=True)
        raise FsError("small write failed on all partitions")

    def read_extents(self, inode: Dict, offset: int, size: int,
                     hedge_us: Optional[float] = None) -> bytes:
        """Read [offset, offset+size) of a file.

        Byte ranges no extent covers — holes from ftruncate-grow or sparse
        writes — read back as zeros; pieces are assembled by file offset,
        never by extent-map order.

        Under a *timed* op with ``read_window > 0`` the fetches are the
        mirror of the append window: extent pieces split into ≤128 KB
        packets issued as concurrent timed branches, at most ``read_window``
        in flight, each packet individually hedged against its partition's
        p99 budget (``_timed_fetch``).  The op completes at the last
        packet's arrival.  ``read_window == 0`` (or an untimed op) keeps the
        seed's one-synchronous-fetch-per-piece path.  ``hedge_us``
        overrides the adaptive budget (the legacy datapipe knob)."""
        size = min(size, inode["size"] - offset)
        if size <= 0:
            return b""
        out = bytearray(size)
        pieces = self._map_pieces(inode, offset, size)
        op = self.net.current_op
        if op is not None and op.timed and self.read_window > 0:
            done = self._windowed_fetch(out, pieces, op.now_us, hedge_us,
                                        cache_ctx=self._cache_ctx(inode))
            op.advance_to(done)
        else:
            for (pos, pid, eid, eoff, ln) in pieces:
                dp = self._dp(pid)
                chunk = self._read_one(dp, eid, eoff, ln, hedge_us=hedge_us)
                out[pos : pos + len(chunk)] = chunk
        return bytes(out)

    def read_extents_at(self, inode: Dict, offset: int, size: int,
                        at: float, hedge_us: Optional[float] = None
                        ) -> Tuple[bytes, float]:
        """Detached windowed fetch anchored at virtual time ``at`` — the
        readahead primitive: resources are genuinely occupied (a wasted
        prefetch is a real cost) but the caller's frontier is NOT advanced.
        Returns ``(data, completion_time)``; the caller parks the
        completion and advances to it on cache hit or at a barrier."""
        size = min(size, inode["size"] - offset)
        if size <= 0:
            return b"", at
        out = bytearray(size)
        done = self._windowed_fetch(out, self._map_pieces(inode, offset, size),
                                    at, hedge_us,
                                    cache_ctx=self._cache_ctx(inode))
        return bytes(out), done

    def _cache_ctx(self, inode: Dict
                   ) -> Optional[Tuple[int, int, Optional[float], float]]:
        """Build the extent-cache validity context ``(ino, mv, granted_us,
        bound_us)`` for a read of ``inode``, or None when the read must
        bypass the cache (cache off, ``CFS_META_TTL=0`` — without leases a
        cached packet has no staleness bound — or a view that carries no
        inode number, e.g. a bare extent list synthesized by a test).

        Freshness is delegated to the lease contract.  An UNEXPIRED
        inode lease is authority as-is: the context is built from a pure
        local peek, zero RPCs, so a cache-enabled client is timing- and
        stats-identical to the seed on every workload whose reads stay
        under live leases (the committed mdtest/largefile baselines).  An
        expired lease revalidates through ``getattr`` — the 16-byte
        ``stat_version`` read that renews an unchanged lease in place or
        drops the stale inode view (and, via ``forget_inode``, this
        inode's cached packets).  Either way a cached packet is never
        served staler than one ``CFS_META_TTL`` behind the last committed
        extent-map mvcc."""
        cache = self.data_cache
        ino = inode.get("inode")
        if cache is None or ino is None or self.session.ttl_us <= 0:
            return None
        op = self.net.current_op
        if op is None or not op.timed:
            return None             # untimed ops stay on the seed path
        lease = self.session.inode_lease(ino)
        if lease is not None and op.now_us < lease[2]:
            return (ino, lease[0], lease[1], self.session.ttl_us)
        try:
            self.session.getattr(ino, use_cache=True)
        except NotFound:            # unlinked under us: no bytes either
            cache.drop_inode(ino)
            return None
        lease = self.session.inode_lease(ino)
        if lease is None:
            return None
        return (ino, lease[0], lease[1], self.session.ttl_us)

    @staticmethod
    def _map_pieces(inode: Dict, offset: int, size: int
                    ) -> List[Tuple[int, int, int, int, int]]:
        """Map a byte range onto extent pieces:
        [(out_pos, partition_id, extent_id, extent_offset, length)]."""
        need_lo, need_hi = offset, offset + size
        pieces: List[Tuple[int, int, int, int, int]] = []
        for (pid, eid, foff, eoff, esize) in inode["extents"]:
            seg_lo, seg_hi = foff, foff + esize
            lo, hi = max(need_lo, seg_lo), min(need_hi, seg_hi)
            if lo >= hi:
                continue
            pieces.append((lo - need_lo, pid, eid, eoff + (lo - seg_lo),
                           hi - lo))
        return pieces

    def _windowed_fetch(self, out: bytearray,
                        pieces: List[Tuple[int, int, int, int, int]],
                        at: float, hedge_us: Optional[float] = None,
                        cache_ctx: Optional[
                            Tuple[int, int, Optional[float], float]] = None
                        ) -> float:
        """Issue the pieces as ≤128 KB packet fetches with a bounded
        in-flight window starting at ``at``; fill ``out``; return the last
        completion time.  The send frontier advances to each request's NIC
        departure (``tx_done``), so requests stream out back-to-back while
        earlier replies are still in flight — when the window is full, the
        next send waits for the EARLIEST outstanding completion (replies
        from different partitions arrive out of order, unlike the append
        chain's FIFO acks).

        With ``cache_ctx`` set, each packet first consults the tiered
        extent cache: a hit is served at RAM/SSD cost and never enters the
        fetch window — it reaches neither the hedge machinery nor the
        latency EWMAs / ``read_affinity`` (a zero-cost local copy says
        nothing about replica speed and must not dilute the p99 budget).
        Misses fetch as before and fill the cache at their arrival time."""
        window: List[float] = []
        depth = max(1, self.read_window)    # read_extents_at may be called
        send_frontier = at                  # with window 0: degrade to serial
        last_done = at
        cache = self.data_cache if cache_ctx is not None else None
        for (pos, pid, eid, eoff, ln) in pieces:
            dp = self._dp(pid)
            off = 0
            while off < ln:
                n = min(PACKET_SIZE, ln - off)
                if cache is not None:
                    key = (self.volume, pid, eid, eoff + off)
                    hit = cache.serve(key, n, cache_ctx, send_frontier)
                    if hit is not None:
                        data, done = hit
                        out[pos + off : pos + off + n] = data
                        send_frontier = max(send_frontier, done)
                        last_done = max(last_done, done)
                        self.stats["data_cache_hits"] += 1
                        off += n
                        continue
                    self.stats["data_cache_misses"] += 1
                send_at = send_frontier
                if len(window) >= depth:
                    first = min(window)
                    window.remove(first)
                    send_at = max(send_at, first)
                data, done, tx_done = self._timed_fetch(
                    dp, eid, eoff + off, n, send_at, hedge_us)
                out[pos + off : pos + off + len(data)] = data
                if cache is not None and len(data) == n:
                    cache.insert((self.volume, pid, eid, eoff + off),
                                 bytes(data), cache_ctx, done)
                window.append(done)
                last_done = max(last_done, done)
                send_frontier = max(send_frontier, tx_done)
                off += n
        return last_done

    def _punch_range(self, pid: int, eid: int, eoff: int, length: int) -> None:
        """Free [eoff, eoff+length) of one extent on every replica — the
        ftruncate tail-punch (same async fallocate path as small-file
        deletes, §2.7.3)."""
        if self.data_cache is not None:
            self.data_cache.invalidate_extent_range(
                pid, eid, eoff, eoff + length)
        try:
            dp = self._dp(pid)
        except NotFound:
            return
        for nid in dp.replicas:
            try:
                self.net.call(self.client_id, nid,
                              self.data_nodes[nid].serve_punch_hole,
                              pid, eid, eoff, length, kind="client.data")
            except NetError:
                continue

    def _serve_read_call(self, dp: _DataPartition, nid: str, eid: int,
                         eoff: int, size: int) -> bytes:
        self._tag()
        try:
            return self.net.call(
                self.client_id, nid, self.data_nodes[nid].serve_read,
                dp.pid, eid, eoff, size,
                nbytes=128, reply_bytes=size + 64, kind="client.data")
        except Busy as e:
            # admission NAK on a read: the caller's failover machinery
            # re-routes to the next replica in the group (hint-following),
            # so every read shed is also a re-route attempt
            self.stats["qos_sheds"] += 1
            self.stats["qos_shed_retries"] += 1
            self.stats["qos_backoff_us"] += e.retry_after_us
            raise

    def _read_one(self, dp: _DataPartition, eid: int, eoff: int,
                  size: int, hedge_us: Optional[float] = None) -> bytes:
        """One synchronous extent fetch (the serial read path).  Successful
        replicas are cached into ``read_affinity`` — never ``leader_cache``
        (a follower serving a read must not misroute the next write).

        With ``hedge_us`` set, a first attempt whose modeled cost blows the
        budget races the next replica and only the winner's cost is charged
        (the promoted ``storage/datapipe.hedged_read_file`` logic)."""
        op = self.net.current_op
        if op is not None and op.timed:
            data, done, _tx = self._timed_fetch(dp, eid, eoff, size,
                                                op.now_us, hedge_us)
            op.advance_to(done)
            return data
        gid = f"dp{dp.pid}"
        order = self._read_order(gid, dp.replicas)
        attempts: List[Tuple[float, int, str, bytes]] = []
        last_err: Exception = NotFound(gid)
        for idx, nid in enumerate(order):
            self.net.begin_op()         # untimed sub-op measures the cost
            try:
                d = self._serve_read_call(dp, nid, eid, eoff, size)
            except (NetError, ExtentError, Busy) as e:
                last_err = e
                self.net.end_op()
                continue
            cost = self.net.end_op().us
            self.stats["data_calls"] += 1
            attempts.append((cost, idx, nid, d))
            if hedge_us is None or cost <= hedge_us or len(attempts) > 1:
                break
            if idx + 1 >= len(order):
                break               # no replica left to race against
            # budget blown: race the next replica; min() charges the winner
            self.stats["hedged_reads"] += 1
        if not attempts:
            raise last_err
        cost, _, nid, data = min(attempts, key=lambda a: (a[0], a[1]))
        self.read_affinity[gid] = nid
        self._observe_read(gid, cost)
        if op is not None:
            op.add(cost)
        return data

    def _timed_fetch(self, dp: _DataPartition, eid: int, eoff: int,
                     size: int, at: float, hedge_us: Optional[float] = None
                     ) -> Tuple[bytes, float, float]:
        """One packet fetch on the event timeline, hedged against the
        partition group's p99 budget.

        The fetch runs as a timed sub-op starting at ``at``; primary and
        hedge are concurrent branches of an ``OpTimer.fork``: if the
        primary's completion exceeds ``at + budget``, the next replica is
        raced from the moment the budget expires, and ``fork.join_first()``
        resumes at the winner — the loser's queueing/service stays on the
        simulated resources (hedging is not free for the cluster, only for
        the caller).  Returns ``(data, completion_us, request_tx_done_us)``.
        The winner lands in ``read_affinity`` so later reads of this group
        go straight to the replica that actually answered fastest, and the
        winner's latency feeds the budget EWMAs."""
        gid = f"dp{dp.pid}"
        order = self._read_order(gid, dp.replicas)
        budget = hedge_us
        if budget is None and self.hedge_reads:
            budget = self._hedge_budget(gid)
        attempts: List[Tuple[float, int, str, bytes]] = []
        last_err: Exception = NotFound(gid)
        pkt = self.net.begin_op(at=at)
        try:
            fork = pkt.fork()
            t_fail = at
            try:
                d = self._serve_read_call(dp, order[0], eid, eoff, size)
                attempts.append((pkt.now_us, 0, order[0], d))
                self.stats["data_calls"] += 1
                fork.branch_done()
            except (NetError, ExtentError, Busy) as e:
                last_err = e
                t_fail = pkt.now_us          # the NAK's arrival time
                fork.branch_done(record=False)
            tx_done = pkt.tx_done_us
            primary_lat = attempts[0][0] - at if attempts else None
            if len(order) > 1 and (
                    not attempts or
                    (budget is not None and primary_lat > budget)):
                # hedge branch: fires when the budget timer expires (or the
                # moment the primary's NAK lands).  Counted when ISSUED on a
                # blown budget — a hedge that then NAKs still raced.
                if primary_lat is not None:
                    self.stats["hedged_reads"] += 1
                pkt.advance_to(t_fail if not attempts else at + budget)
                try:
                    d = self._serve_read_call(dp, order[1], eid, eoff, size)
                    attempts.append((pkt.now_us, 1, order[1], d))
                    self.stats["data_calls"] += 1
                    fork.branch_done()
                except (NetError, ExtentError, Busy) as e:
                    last_err = e
                    t_fail = max(t_fail, pkt.now_us)
                    fork.branch_done(record=False)
            fork.join_first()
            if not attempts:
                # both racers failed: walk the remaining replicas serially
                # from the time the client learned of the later failure
                pkt.advance_to(t_fail)
                for idx, nid in enumerate(order[2:], start=2):
                    try:
                        d = self._serve_read_call(dp, nid, eid, eoff, size)
                        attempts.append((pkt.now_us, idx, nid, d))
                        self.stats["data_calls"] += 1
                        break
                    except (NetError, ExtentError, Busy) as e:
                        last_err = e
        finally:
            self.net.end_op()
        if not attempts:
            raise last_err
        done, _, nid, data = min(attempts, key=lambda a: (a[0], a[1]))
        self.read_affinity[gid] = nid
        self._observe_read(gid, done - at)
        return data, done, tx_done

    # ------------------------------------------------- hedge budget (p99 EWMA)
    def _hedge_budget(self, gid: str) -> Optional[float]:
        """p99-derived hedge budget for one data-partition group, from the
        latency EWMAs the event timeline feeds; the client-wide aggregate
        covers the cold start, and below both minimums reads never hedge."""
        s = self._read_lat.get(gid)
        if s is not None and s.n >= HEDGE_MIN_GROUP_SAMPLES:
            return s.p99_us
        if self._read_lat_all.n >= HEDGE_MIN_GLOBAL_SAMPLES:
            return self._read_lat_all.p99_us
        return None

    def _observe_read(self, gid: str, lat_us: float) -> None:
        self._read_lat.setdefault(gid, _LatencyEwma()).observe(lat_us)
        self._read_lat_all.observe(lat_us)


def _uncovered(lo: int, hi: int,
               covered: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Subranges of [lo, hi) not covered by any interval in ``covered``."""
    out: List[Tuple[int, int]] = []
    pos = lo
    for c_lo, c_hi in sorted(covered):
        if c_lo > pos:
            out.append((pos, min(c_lo, hi)))
        pos = max(pos, c_hi)
        if pos >= hi:
            break
    if pos < hi:
        out.append((pos, hi))
    return out


class CfsFile:
    """An open file handle: buffering, packetization, small/large decision."""

    def __init__(self, client: CfsClient, inode: Dict, mode: str):
        self.client = client
        self.inode = inode
        self.mode = mode
        self.pos = inode["size"] if "a" in mode else 0
        self._buf = bytearray()
        self._buf_start = inode["size"]     # appends buffer from EOF
        self._stream_state: Optional[Tuple[int, int, int]] = None
        self._extents: List[ExtentKey] = [ExtentKey(*e) for e in inode["extents"]]
        self._size = inode["size"]
        self._dirty = False
        # chain-ack times of pipelined in-flight packets (virtual us); an
        # fsync/read barrier drains this via CfsClient.drain_window
        self._inflight: List[float] = []
        # ---- sequential readahead (mirror of the append window) ----
        # prefetched chunks [(file_offset, data, ready_us)]; a cache hit
        # advances the op to ready_us, fsync/close barrier-drain the rest
        self._ra_chunks: List[Tuple[int, bytes, float]] = []
        self._ra_next = -1          # where a forward scan would read next
        self._ra_pos = 0            # highest offset prefetched so far
        self._ra_wver = -1          # inode write version the cache is for

    # ---- write ---------------------------------------------------------------
    def write(self, data: bytes) -> int:
        if "r" == self.mode:
            raise FsError("read-only handle")
        self._wver_bump()           # prefetched bytes (any handle) now stale
        self._ra_reset()
        eof = self._buf_start + len(self._buf)
        if self.pos == eof:
            self._write_append(data)
        elif self.pos > eof:
            # sparse gap: fill with zeros then append (simplification)
            self._write_append(b"\x00" * (self.pos - eof))
            self._write_append(data)
        else:
            # rewound into existing content: make everything durable first,
            # then split into overwrite + append (Fig. 5)
            self._flush_full_packets(force=True)
            self._write_random(data)
        self.pos += len(data)
        self._dirty = True
        return len(data)

    def _write_append(self, data: bytes) -> None:
        self._buf.extend(data)
        # once the file is clearly not-small, stream out full packets
        if self._buf_start + len(self._buf) > SMALL_FILE_THRESHOLD or \
                self._extents:
            self._flush_full_packets()

    def _flush_full_packets(self, force: bool = False) -> None:
        cut = len(self._buf) if force else (len(self._buf) // PACKET_SIZE) * PACKET_SIZE
        if cut == 0:
            return
        chunk = bytes(self._buf[:cut])
        del self._buf[:cut]
        keys, self._stream_state = self.client._append_packets(
            chunk, self._stream_state, window=self._inflight)
        foff = self._buf_start
        for k in keys:
            k.file_offset = foff
            foff += k.size
        self._buf_start = foff
        self._extents.extend(keys)
        self._size = max(self._size, foff)
        self._cache_write_through(keys, chunk)

    def _write_random(self, data: bytes) -> None:
        """Fig. 5: split into overwrite (in-place, raft) + append parts.
        An overwrite may target bytes whose append ack is still in flight —
        barrier first (committed-offset rule: nothing may be overwritten
        before its append commit is known)."""
        self.client.drain_window(self._inflight)
        overlap = min(self._size - self.pos, len(data))
        if overlap > 0:
            self._overwrite_range(self.pos, data[:overlap])
        if overlap < len(data):
            self._flush_full_packets(force=True)
            self._write_append(data[overlap:])

    def _overwrite_range(self, file_off: int, data: bytes) -> None:
        """In-place overwrite: 'the offset of the file on the data partition
        does not change' — route each covered extent-piece to its raft group.
        Ranges below EOF that NO extent covers (holes left by ftruncate-grow
        or trimmed tails) get fresh extents instead: an overwrite must never
        silently drop bytes into a hole."""
        if self.client.data_cache is not None:
            # in-place raft overwrite: the DATA changes but the extent keys
            # and the inode mv stay put until the next fsync, so an mv check
            # cannot catch it — drop the inode's cached packets eagerly
            self.client.data_cache.drop_inode(self.inode["inode"])
        covered: List[Tuple[int, int]] = []
        for k in self._extents:
            seg_lo, seg_hi = k.file_offset, k.file_offset + k.size
            lo = max(file_off, seg_lo)
            hi = min(file_off + len(data), seg_hi)
            if lo >= hi:
                continue
            piece = data[lo - file_off : hi - file_off]
            dp = self.client._dp(k.partition_id)
            self.client._data_call(
                dp, "serve_overwrite", k.extent_id,
                k.extent_offset + (lo - seg_lo), piece,
                nbytes=len(piece) + 128)
            covered.append((lo, hi))
        for lo, hi in _uncovered(file_off, file_off + len(data), covered):
            keys, _ = self.client._append_packets(
                data[lo - file_off : hi - file_off])
            foff = lo
            for k in keys:
                k.file_offset = foff
                foff += k.size
            self._extents.extend(keys)

    # ---- read ------------------------------------------------------------------
    def read(self, size: int = -1) -> bytes:
        self.flush()
        # read-your-writes: a read behind the window waits for the acks
        self.client.drain_window(self._inflight)
        if size < 0:
            size = self._size - self.pos
        start = self.pos
        op = self.client.net.current_op
        ra_on = (op is not None and op.timed and
                 self.client.read_window > 0 and size > 0)
        data = self._ra_serve(start, size) if ra_on else None
        if data is None:
            data = self.client.read_extents(self._inode_view(), start, size)
        self.pos += len(data)
        seq = start == self._ra_next
        self._ra_next = start + len(data)
        if ra_on and seq and len(data) > 0:
            # a confirmed forward scan keeps up to read_window IO-sized
            # chunks prefetched ahead of the reader
            self._ra_topup(self._ra_next, len(data))
        return data

    def _inode_view(self) -> Dict:
        return {"inode": self.inode["inode"], "size": self._size,
                "extents": [k.as_tuple() for k in self._extents]}

    def _wver_bump(self) -> None:
        """Advance the client-wide write version of this inode: every
        handle's readahead cache for the file self-invalidates, not just
        this one's (cross-handle read-your-writes within one client)."""
        ino = self.inode["inode"]
        self.client._ino_wver[ino] = self.client._ino_wver.get(ino, 0) + 1

    def _ra_serve(self, start: int, size: int) -> Optional[bytes]:
        """Serve [start, start+size) from the readahead cache if a chunk
        covers it; the op waits until the prefetched bytes have actually
        arrived (``ready_us``).  Partial head coverage falls back to the
        network path (and drops the stale chunks), as does a cache built
        before another handle's write to the same inode (version check)."""
        if self._ra_wver != self.client._ino_wver.get(self.inode["inode"], 0):
            self._ra_chunks.clear()
            self._ra_pos = 0        # re-prefetch the invalidated range
            return None
        want = min(size, self._size - start)
        for i, (c_start, c_data, ready) in enumerate(self._ra_chunks):
            if c_start != start:
                continue
            if len(c_data) < want:
                break               # scan pattern changed: refetch fresh
            self._ra_chunks.pop(i)
            if len(c_data) > want:
                # keep the tail for the next sequential read
                self._ra_chunks.insert(i, (start + want, c_data[want:], ready))
            op = self.client.net.current_op
            if op is not None:
                op.advance_to(ready)
            self.client.stats["ra_hits"] += 1
            return c_data[:want]
        if self._ra_chunks:
            self._ra_chunks.clear()     # scan diverged: cached run is dead
            self._ra_pos = 0
        return None

    def _ra_topup(self, frontier: int, io_size: int) -> None:
        """Keep the prefetch pipeline ``read_window`` chunks deep: issue
        detached windowed fetches (resources occupied, frontier NOT
        advanced) for the next IO-sized chunks beyond ``frontier``."""
        op = self.client.net.current_op
        self._ra_wver = self.client._ino_wver.get(self.inode["inode"], 0)
        nxt = max(self._ra_pos, frontier)
        limit = min(self._size, frontier + self.client.read_window * io_size)
        inode = self._inode_view()
        while nxt < limit:
            ln = min(io_size, self._size - nxt)
            data, ready = self.client.read_extents_at(inode, nxt, ln,
                                                      op.now_us)
            self._ra_chunks.append((nxt, data, ready))
            nxt += ln
        self._ra_pos = nxt

    def _ra_reset(self) -> None:
        """Invalidate the readahead state (seek / write / truncate): cached
        chunks are dropped without waiting — the prefetch cost stays spent,
        nobody consumes the arrival."""
        self._ra_chunks.clear()
        self._ra_next = -1
        self._ra_pos = 0

    def _ra_barrier(self) -> None:
        """fsync/close barrier: wait out every prefetched chunk still in
        flight, mirroring the append window's drain."""
        pending = [ready for (_s, _d, ready) in self._ra_chunks]
        self.client.drain_window(pending)

    def seek(self, pos: int) -> None:
        if pos != self.pos:
            self._ra_reset()
        self.pos = pos

    def truncate(self, size: int = 0) -> None:
        """ftruncate(fd, size): shrink trims extent keys and punches the
        freed ranges out of their extents (async, §2.7.3); grow leaves a
        hole that reads back as zeros.  Buffered appends are flushed FIRST so
        the trim operates on the real extent map — the in-flight buffer used
        to be dropped silently, which corrupted truncate-to-nonzero."""
        self._wver_bump()           # cached runs may cover punched bytes
        self._ra_reset()
        if self.client.data_cache is not None:
            # shrink punches byte ranges out of live extents; the extent
            # cache drops the whole inode (simple and always safe)
            self.client.data_cache.drop_inode(self.inode["inode"])
        self.client.drain_window(self._inflight)   # never punch under the window
        if size == 0:
            # everything goes — no point making the buffer durable first
            if self._extents:
                self.client._free_extents(
                    [k.as_tuple() for k in self._extents], self._size)
            self._extents = []
            self._stream_state = None
            self._size = 0
            self._buf_start = 0
            self._buf.clear()
            self._dirty = True
            return
        self.flush()
        self.client.drain_window(self._inflight)
        if size < self._size:
            kept: List[ExtentKey] = []
            dropped: List[ExtentKey] = []
            for k in self._extents:
                if k.file_offset >= size:
                    dropped.append(k)
                elif k.file_offset + k.size > size:
                    # piece straddles the cut: keep the head, punch the tail
                    trim = k.file_offset + k.size - size
                    self.client._punch_range(
                        k.partition_id, k.extent_id,
                        k.extent_offset + (k.size - trim), trim)
                    k.size -= trim
                    kept.append(k)
                else:
                    kept.append(k)
            # pieces are ≤128 KB packets that may share an extent with kept
            # pieces, so freeing is per-range (punch), never whole-extent
            for k in dropped:
                self.client._punch_range(k.partition_id, k.extent_id,
                                         k.extent_offset, k.size)
            self._extents = kept
            self._stream_state = None       # next append opens a fresh extent
        self._size = size
        self._buf_start = self._size        # appends buffer from the new EOF
        self._buf.clear()
        self._dirty = True                  # POSIX: the fd offset is NOT moved

    def _cache_write_through(self, keys: List[ExtentKey],
                             chunk: bytes) -> None:
        """``CFS_CACHE_WRITE_THROUGH=1``: the packets just committed go
        straight into the extent cache (a producer that re-reads its own
        output — checkpoint-then-restore — hits locally).  Stamped with the
        CURRENT session mv; the fsync's ``update_extents`` flows through
        ``note_extent_map``, which re-stamps entries still covered by an
        identical piece of the new map, so the fill survives its own
        commit.  Off by default: fills cost RAM/SSD occupancy that a
        write-mostly workload never reads back."""
        client = self.client
        cache = client.data_cache
        op = client.net.current_op
        if cache is None or not client.cache_write_through or \
                op is None or not op.timed:
            return
        ctx = client._cache_ctx(self.inode)
        if ctx is None:
            return
        off = 0
        for k in keys:
            cache.insert((client.volume, k.partition_id, k.extent_id,
                          k.extent_offset),
                         chunk[off : off + k.size], ctx, op.now_us)
            off += k.size

    # ---- flush / fsync / close ----------------------------------------------------
    def flush(self) -> None:
        """Push buffered bytes out.  A never-streamed file that stayed ≤128 KB
        takes the small-file aggregated path."""
        if self._buf:
            if not self._extents and self._buf_start + len(self._buf) <= SMALL_FILE_THRESHOLD:
                small = bytes(self._buf)
                keys = self.client._write_small_file(small)
                for k in keys:
                    k.file_offset = self._buf_start
                self._extents.extend(keys)
                self._size = self._buf_start + len(self._buf)
                self._buf_start = self._size
                self._buf.clear()
                self._cache_write_through(keys, small)
            else:
                self._flush_full_packets(force=True)

    def fsync(self) -> None:
        """fsync(): flush data, drain the pipeline window (the barrier — a
        durable ack for the highest offset implies the whole committed
        prefix, §2.2.2), THEN synchronize the meta node (§2.7.1)."""
        self.flush()
        self.client.drain_window(self._inflight)
        self._ra_barrier()          # outstanding readahead is in-flight too
        if self._dirty:
            self.inode = self.client.update_extents(
                self.inode["inode"], self._size, self._extents)
            self._dirty = False
        # metadata durability barrier (close of a created file is an fsync):
        # every async-acked namespace mutation must be committed before the
        # fsync ack returns to the caller
        self.client.drain_meta_window()

    def close(self) -> None:
        self.fsync()

    @property
    def size(self) -> int:
        return max(self._size, self._buf_start + len(self._buf))
