"""Meta nodes and meta partitions (paper §2.1, §2.6).

A meta partition is an in-memory store of the inodes and dentries of one
volume slice, held in two b-trees (``inodeTree`` keyed by inode id,
``dentryTree`` keyed by (parent inode id, name)), replicated with MultiRaft,
persisted by snapshot+log (raft log compaction gives the paper's
"snapshots and logs ... log compaction" for free).

Each partition owns an inode-id range [start, end]; ids are allocated as
"the smallest inode id that has not been used so far" per §2.6.1 — we keep a
cursor plus the paper's ``freeList`` of deleted ids.  Splitting (Algorithm 1)
is driven by the resource manager, which *cuts off* the range of the old
partition at ``maxInodeID + Δ`` and creates a sibling covering
``[end+1, ∞)`` — ids stay unique without moving any existing metadata
(the heart of the no-rebalancing claim for capacity expansion).

Relaxed metadata atomicity (§2.6): inode and dentry of one file may live on
*different* partitions/nodes, so create/link/unlink are multi-step client
workflows, not transactions.  The invariant maintained is one-directional:
a dentry always references an inode that was created first; failures can only
leave orphan *inodes* (never dangling dentries), which the client evicts.

Metadata sessions (the client-cache contract, §2.4 redesigned): every
mutation — batch sub-ops included — bumps the partition's monotonic ``mvcc``
counter and stamps the touched inode/dentry with it (``mv``).  Reads served
through ``MetaNode.read_leased`` return an envelope carrying the partition
``mvcc`` and a TTL lease grant; a client holding an *expired* entry
revalidates it with the cheap ``stat_version`` read (compare ``mv``, renew
the lease) instead of refetching the whole object.  This replaces the
paper's force-sync-on-open: staleness is bounded by the lease TTL instead
of a per-open round-trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import knobs
from ..analysis import sanitizer as _san
from .btree import BTree
from .multiraft import MultiRaftHost
from .raft import NotLeader, StateMachine
from .simnet import Network
from .types import MAX_UINT64, Dentry, Inode, InodeFlag, InodeType

__all__ = ["MetaNode", "MetaPartitionSM", "MetaError", "NoSuchInode",
           "NoSuchDentry", "DentryExists", "WrongRange"]

# rough per-entry memory cost used for utilization-based placement
INODE_MEM_BYTES = 300
DENTRY_MEM_BYTES = 120

# Lease TTL granted on read replies (virtual µs).  The client caps its own
# cache validity at min(client TTL, server grant); both sides read the SAME
# registry entry so one env var — with one default — tunes the whole
# contract (previously each module parsed its own copy, and a skewed
# override desynchronized server grants from client cache TTLs).
META_LEASE_US = knobs.get_float("CFS_META_TTL")


class MetaError(Exception):
    pass


class NoSuchInode(MetaError):
    pass


class NoSuchDentry(MetaError):
    pass


class DentryExists(MetaError):
    pass


class RangeExhausted(MetaError):
    """Inode cursor hit the partition's (cut-off) range end."""


class PartitionFull(MetaError):
    """Entry-count threshold reached: no NEW files, mutations still allowed."""


class WrongRange(MetaError):
    """Op routed to a partition whose (possibly split-shrunk) inode range
    does not cover it.  Carries the routing epoch of the range cut so the
    client can fetch a partition table at least that new and re-route
    exactly once — a stale route is a redirect, never a silent serve or a
    spurious ENOENT."""

    def __init__(self, partition_id: int, ino: int, epoch: int):
        super().__init__(
            f"inode {ino} outside partition {partition_id} (epoch {epoch})")
        self.partition_id = partition_id
        self.ino = ino
        self.epoch = epoch


class MetaPartitionSM(StateMachine):
    """Replicated state machine of one meta partition."""

    def __init__(self, partition_id: int, volume: str,
                 start: int, end: int, max_entries: int = 1 << 20,
                 route_epoch: int = 0):
        self.partition_id = partition_id
        self.volume = volume
        self.start = start
        self.end = end                      # MAX_UINT64 until split cuts it
        # RM routing epoch as of the last range change this partition
        # learned about; advertised in WrongRange hints so clients know how
        # fresh a table they must fetch before re-routing
        self.route_epoch = route_epoch
        self.cursor = start - 1             # last allocated inode id
        self.inode_tree = BTree()
        self.dentry_tree = BTree()
        self.free_list: List[int] = []      # paper's freeList
        self.max_entries = max_entries
        # monotonic partition version: bumped once per applied mutation
        # (batch sub-ops included); entries are stamped with the mvcc of
        # the mutation that last touched them (``mv``)
        self.mvcc = 0
        self.lease_us = META_LEASE_US       # TTL granted on leased reads

    # ---- sizing (drives placement + splitting) ------------------------------
    @property
    def entries(self) -> int:
        return len(self.inode_tree) + len(self.dentry_tree)

    def mem_bytes(self) -> int:
        return (len(self.inode_tree) * INODE_MEM_BYTES
                + len(self.dentry_tree) * DENTRY_MEM_BYTES)

    @property
    def max_inode_id(self) -> int:
        return self.cursor

    def writable(self) -> bool:
        return self.entries < self.max_entries and self.cursor < self.end

    # ---- range enforcement (split-aware routing) ----------------------------
    # arg index of the routing inode per op; ops not listed (create_inode
    # allocates from the partition's own cursor, set_end is the RM task)
    # are never misrouted by a stale table
    MUT_ROUTE = {"create_dentry": 0, "delete_dentry": 0, "link_inc": 0,
                 "unlink_dec": 0, "evict": 0, "update_extents": 0}
    READ_ROUTE = {"lookup": 0, "get_inode": 0, "read_dir": 0}

    def _covers(self, ino: Any) -> bool:
        # non-int routing args are intra-batch ("ref", i, field) tokens:
        # they resolve to inodes this partition just allocated
        return not isinstance(ino, int) or self.start <= ino <= self.end

    def check_route(self, payload: Tuple) -> None:
        """Reject a mutation routed here by a pre-split table with a
        WrongRange hint instead of silently serving (or raising a spurious
        NoSuchInode for an inode that lives on the sibling)."""
        op, args = payload[0], payload[1:]
        if op == "batch":
            for sub in args[0]:
                self.check_route(sub)
            return
        idx = self.MUT_ROUTE.get(op)
        if idx is not None and not self._covers(args[idx]):
            raise WrongRange(self.partition_id, args[idx], self.route_epoch)

    def check_read_route(self, op: str, args: Tuple) -> None:
        """Same rejection for routed reads.  ``batch_inode_get`` is exempt:
        it is a best-effort bulk read that already skips unknown inodes, so
        the client refetches misses individually (and THAT read gets the
        WrongRange redirect)."""
        key: Any = None
        idx = self.READ_ROUTE.get(op)
        if idx is not None:
            key = args[idx]
        elif op == "stat_version":
            kind, k = args[0], args[1]
            key = k if kind == "inode" else tuple(k)[0]
        if key is not None and not self._covers(key):
            raise WrongRange(self.partition_id, key, self.route_epoch)

    # ---- raft apply ----------------------------------------------------------
    # ops that advance the partition mvcc; "batch" bumps through its sub-ops
    MUTATORS = {"create_inode", "create_dentry", "delete_dentry", "link_inc",
                "unlink_dec", "evict", "update_extents", "set_end"}

    def apply(self, payload: Any) -> Any:
        op, args = payload[0], payload[1:]
        if op in self.MUTATORS:
            # bump BEFORE dispatch so the handler stamps entries with the
            # version of this very mutation; deterministic across replicas
            # (followers apply the same committed entries in order)
            self.mvcc += 1
            if _san.SAN is not None:
                # the journal's mvcc-assignment point: no timed read may
                # observe a partition mvcc before this runs for it
                _san.SAN.note_mvcc_assign(self.partition_id, self.mvcc)
        return getattr(self, "_ap_" + op)(*args)

    # -- inode ops
    def _ap_create_inode(self, itype: int, link_target: bytes, now: float) -> Dict:
        if not self.writable():
            if self.cursor >= self.end:
                raise RangeExhausted(str(self.partition_id))
            raise PartitionFull(str(self.partition_id))
        if self.free_list:
            ino = self.free_list.pop()       # smallest-unused-id spirit (§2.6.1)
        else:
            self.cursor += 1
            ino = self.cursor
        nlink = 2 if itype == InodeType.DIR else 1
        inode = Inode(inode=ino, type=itype, link_target=link_target,
                      nlink=nlink, ctime=now, mtime=now, mv=self.mvcc)
        self.inode_tree.put(ino, inode)
        return _inode_view(inode)

    def _ap_link_inc(self, ino: int) -> Dict:
        inode = self._inode(ino)
        inode.nlink += 1
        inode.gen += 1
        inode.mv = self.mvcc
        return _inode_view(inode)

    def _ap_unlink_dec(self, ino: int) -> Dict:
        """Decrease nlink; mark deleted when the object is actually dead:
        files at nlink 0, directories BELOW 2 — an empty live dir sits at
        exactly 2 ("." + its parent entry), so a parent losing one subdir
        (3 -> 2) must stay NORMAL or fsck would evict a live directory."""
        inode = self._inode(ino)
        inode.nlink = max(0, inode.nlink - 1)
        inode.gen += 1
        inode.mv = self.mvcc
        if inode.type == InodeType.DIR:
            if inode.nlink <= 1:
                inode.flag = InodeFlag.MARK_DELETED
        elif inode.nlink <= 0:
            inode.flag = InodeFlag.MARK_DELETED
        return _inode_view(inode)

    def _ap_evict(self, ino: int) -> Dict:
        """Client-driven eviction of marked/orphan inodes (§2.6.1/2.6.3);
        returns the extent keys so the caller can free data asynchronously
        (§2.7.3's separate cleanup process)."""
        inode = self.inode_tree.get(ino)
        if inode is None:
            return {"ok": False, "extents": [], "size": 0}
        if inode.flag != InodeFlag.MARK_DELETED and inode.nlink > 0:
            return {"ok": False, "extents": [], "size": 0}
        self.inode_tree.delete(ino)
        self.free_list.append(ino)
        return {"ok": True, "size": inode.size,
                "extents": [e.as_tuple() for e in inode.extents]}

    def _ap_update_extents(self, ino: int, size: int,
                           extents: List[Tuple[int, int, int, int, int]],
                           mtime: float) -> Dict:
        from .types import ExtentKey
        inode = self._inode(ino)
        inode.size = size
        inode.extents = [ExtentKey(*e) for e in extents]
        inode.mtime = mtime
        inode.gen += 1
        inode.mv = self.mvcc
        return _inode_view(inode)

    # -- dentry ops
    def _ap_create_dentry(self, parent: int, name: str, ino: int, dtype: int) -> Dict:
        key = (parent, name)
        if key in self.dentry_tree:
            existing: Dentry = self.dentry_tree.get(key)
            if existing.inode == ino:
                return _dentry_view(existing)   # idempotent replay
            raise DentryExists(f"{parent}/{name}")
        # NOTE: no writable() check — a dentry must live with its parent
        # inode's partition, and a "full" partition still accepts
        # modifications (§2.3.1: "it can still be modified or deleted");
        # only NEW inode allocation is blocked.
        d = Dentry(parent_id=parent, name=name, inode=ino, type=dtype,
                   mv=self.mvcc)
        self.dentry_tree.put(key, d)
        # a directory gains nlink via its child's ".."; handled by client calling
        # link_inc on the parent for subdirectories.
        return _dentry_view(d)

    def _ap_delete_dentry(self, parent: int, name: str) -> Dict:
        key = (parent, name)
        d: Optional[Dentry] = self.dentry_tree.get(key)
        if d is None:
            raise NoSuchDentry(f"{parent}/{name}")
        self.dentry_tree.delete(key)
        return _dentry_view(d)

    def _ap_set_end(self, end: int, epoch: int = 0) -> int:
        """Algorithm 1 step: cut off the inode range at ``end``.  The RM's
        routing epoch at cut time rides along so out-of-range rejections
        can hint a table version that already routes the sibling."""
        self.end = end
        if epoch > self.route_epoch:
            self.route_epoch = epoch
        return end

    # -- batched mutations (λFS/AsyncFS-style coalescing) ----------------------
    #
    # One raft entry applies a whole list of sub-ops atomically.  Failure
    # modes of every batchable op are PRECONDITION failures (missing inode,
    # existing dentry, full partition), so a validation pass up front makes
    # the apply phase infallible — all-or-nothing without an undo log, and
    # deterministic across replicas.
    #
    # A sub-op argument of the form ``("ref", i, field)`` refers to field
    # ``field`` of the i-th sub-op's result, so e.g. a dentry can point at
    # the inode allocated earlier in the same batch.

    BATCHABLE = {"create_inode", "create_dentry", "delete_dentry",
                 "link_inc", "unlink_dec", "evict", "update_extents"}

    def _ap_batch(self, subs: List[Tuple]) -> List[Any]:
        # Validation must be EXACT w.r.t. the apply-phase checks, which is
        # why create_inode is restricted to one, in first position: its
        # writable() check then sees the same state at validation and apply.
        # Sub-ops must also not consume state an earlier sub-op destroys
        # (enforced for the delete/evict shapes our client emits).
        deleted_keys = set()
        for i, sub in enumerate(subs):
            op, args = sub[0], sub[1:]
            if op not in self.BATCHABLE:
                raise MetaError(f"op {op!r} is not batchable")
            if op == "create_inode":
                if i != 0:
                    raise MetaError(
                        "create_inode must be the first sub-op of a batch")
                if not self.writable():
                    if self.cursor >= self.end:
                        raise RangeExhausted(str(self.partition_id))
                    raise PartitionFull(str(self.partition_id))
            elif op == "create_dentry":
                parent, name, ino, _dtype = args
                existing = self.dentry_tree.get((parent, name))
                if existing is not None and existing.inode != ino:
                    raise DentryExists(f"{parent}/{name}")
            elif op == "delete_dentry":
                parent, name = args
                if ((parent, name) in deleted_keys
                        or self.dentry_tree.get((parent, name)) is None):
                    raise NoSuchDentry(f"{parent}/{name}")
                deleted_keys.add((parent, name))
            elif op in ("link_inc", "unlink_dec", "update_extents"):
                ino = args[0]
                if isinstance(ino, int):
                    self._inode(ino)            # raises NoSuchInode
            # "evict" never raises — it reports {"ok": False} instead
        results: List[Any] = []
        for sub in subs:
            results.append(self.apply(_resolve_refs(sub, results)))
        return results

    # ---- reads (leader-local, not proposed) ------------------------------------
    def _inode(self, ino: int) -> Inode:
        inode = self.inode_tree.get(ino)
        if inode is None:
            raise NoSuchInode(str(ino))
        return inode

    def get_inode(self, ino: int) -> Dict:
        return _inode_view(self._inode(ino))

    def batch_inode_get(self, inos: List[int]) -> List[Dict]:
        """The paper's batchInodeGet (§4.2, DirStat discussion): one RPC
        fetches many inodes instead of one inodeGet per file."""
        out = []
        for ino in inos:
            inode = self.inode_tree.get(ino)
            if inode is not None:
                out.append(_inode_view(inode))
        return out

    def lookup(self, parent: int, name: str) -> Dict:
        d = self.dentry_tree.get((parent, name))
        if d is None:
            raise NoSuchDentry(f"{parent}/{name}")
        return _dentry_view(d)

    def stat_version(self, kind: str, key: Any) -> Dict:
        """The session revalidation read: return just the ``mv`` stamp of
        one inode (``kind="inode"``, key = inode id) or dentry
        (``kind="dentry"``, key = (parent, name)) plus the partition mvcc —
        a tiny reply that lets a client renew an expired lease on an
        unchanged entry without refetching the whole object.  ``mv == -1``
        means the entry is gone (the caller turns that into a negative
        cache entry)."""
        if kind == "inode":
            e = self.inode_tree.get(key)
        else:
            e = self.dentry_tree.get(tuple(key))
        return {"mv": e.mv if e is not None else -1, "mvcc": self.mvcc}

    def read_dir(self, parent: int) -> List[Dict]:
        hi = (parent, "\U0010ffff")
        return [_dentry_view(d) for _, d in self.dentry_tree.range((parent, ""), hi)]

    # ---- snapshot/restore (raft log compaction, §2.1.3) --------------------------
    def snapshot(self) -> Any:
        return {
            "pid": self.partition_id,
            "vol": self.volume,
            "start": self.start,
            "end": self.end,
            "route_epoch": self.route_epoch,
            "cursor": self.cursor,
            "mvcc": self.mvcc,
            "free": list(self.free_list),
            "inodes": [
                (i.inode, i.type, bytes(i.link_target), i.nlink, i.flag, i.size,
                 [e.as_tuple() for e in i.extents], i.ctime, i.mtime, i.gen,
                 i.mv)
                for _, i in self.inode_tree.items()
            ],
            "dentries": [
                (d.parent_id, d.name, d.inode, d.type, d.mv)
                for _, d in self.dentry_tree.items()
            ],
        }

    def restore(self, snap: Any) -> None:
        from .types import ExtentKey
        self.partition_id = snap["pid"]
        self.volume = snap["vol"]
        self.start = snap["start"]
        self.end = snap["end"]
        self.route_epoch = snap.get("route_epoch", 0)
        self.cursor = snap["cursor"]
        self.mvcc = snap["mvcc"]
        if _san.SAN is not None:
            _san.SAN.note_mvcc_assign(self.partition_id, self.mvcc)
        self.free_list = list(snap["free"])
        self.inode_tree = BTree()
        self.dentry_tree = BTree()
        for (ino, t, lt, nlink, flag, size, exts, ct, mt, gen,
             mv) in snap["inodes"]:
            self.inode_tree.put(ino, Inode(
                inode=ino, type=t, link_target=lt, nlink=nlink, flag=flag,
                size=size, extents=[ExtentKey(*e) for e in exts],
                ctime=ct, mtime=mt, gen=gen, mv=mv))
        for (p, n, i, t, mv) in snap["dentries"]:
            self.dentry_tree.put((p, n), Dentry(p, n, i, t, mv=mv))


def _resolve_refs(sub: Tuple, results: List[Any]) -> Tuple:
    """Replace ("ref", i, field) argument tokens with results[i][field]."""
    out = []
    for arg in sub:
        if (isinstance(arg, tuple) and len(arg) == 3 and arg[0] == "ref"):
            out.append(results[arg[1]][arg[2]])
        else:
            out.append(arg)
    return tuple(out)


def _inode_view(i: Inode) -> Dict:
    return {
        "inode": i.inode, "type": i.type, "nlink": i.nlink, "flag": i.flag,
        "size": i.size, "extents": [e.as_tuple() for e in i.extents],
        "ctime": i.ctime, "mtime": i.mtime, "gen": i.gen, "mv": i.mv,
        "link_target": bytes(i.link_target),
    }


def _dentry_view(d: Dentry) -> Dict:
    return {"parent": d.parent_id, "name": d.name, "inode": d.inode,
            "type": d.type, "mv": d.mv}


class MetaNode:
    """A metadata node hosting many meta partitions (hundreds in prod)."""

    def __init__(self, node_id: str, net: Network,
                 registry: Dict[str, "MetaNode"],
                 raft_registry: Dict[str, MultiRaftHost],
                 mem_capacity: int = 256 * 1024 * 1024,
                 zone: str = "set0"):
        self.node_id = node_id
        self.net = net
        self.registry = registry
        self.mem_capacity = mem_capacity
        self.partitions: Dict[int, MetaPartitionSM] = {}
        self.raft_members: Dict[int, Any] = {}
        self.raft_host = MultiRaftHost(node_id, net, raft_registry)
        self.zone = zone
        # per-partition write-ahead journal records of async-acked
        # mutations: {"mvcc", "ack_us", "commit_us"} — drain latency is
        # commit_us - ack_us (reported by benchmarks/report.py)
        self.journal: Dict[int, List[Dict[str, float]]] = {}
        # meta-leader NICs schedule per-volume WFQ flows (CFS_QOS): every
        # proposal / leased read lands in its volume's flow instead of one
        # shared FIFO, so a single tenant's burst cannot starve the rest
        net.register_qos_nic(f"nic:{node_id}")
        registry[node_id] = self

    # ---- partition lifecycle ---------------------------------------------------
    def add_partition(self, partition_id: int, volume: str, start: int,
                      end: int, replicas: List[str],
                      max_entries: int = 1 << 20,
                      route_epoch: int = 0) -> MetaPartitionSM:
        sm = MetaPartitionSM(partition_id, volume, start, end, max_entries,
                             route_epoch)
        self.partitions[partition_id] = sm
        self.raft_members[partition_id] = self.raft_host.add_group(
            f"mp{partition_id}", replicas, sm)
        return sm

    # ---- RPC endpoints -----------------------------------------------------------
    # sequential raft-log append (group-committed) per metadata mutation
    LOG_APPEND_US = 4.0
    # leader-local journal append on the async-commit ack path (a single
    # buffered sequential write, no replication round)
    JOURNAL_APPEND_US = 2.0

    def propose(self, partition_id: int, payload: Any,
                client_id: str = "", seq: int = -1) -> Any:
        """Write op: goes through the partition's raft group.  Charges the
        (batched) raft log append on every replica (§2.1.3 snapshots+logs)."""
        self.partitions[partition_id].check_route(payload)
        member = self.raft_members[partition_id]
        # server-side executor the client funnel RPCs into
        result = member.propose(payload, client_id=client_id, seq=seq)  # lint: allow[direct-propose]
        op = self.net.current_op
        for nid in member.peers:
            self.net.charge_busy(nid, self.LOG_APPEND_US)
        if op is not None:
            op.add(self.LOG_APPEND_US)
        return result

    def propose_async(self, partition_id: int, payload: Any,
                      client_id: str = "", seq: int = -1) -> Dict[str, Any]:
        """Async-commit write (CFS_META_ASYNC): the leader appends the
        mutation to its partition journal, stamps it with the next mvcc and
        acks the client after one NIC round plus a journal append — the
        raft replication round completes in the background on a detached
        timeline.  Returns an envelope ``{"v", "mvcc", "commit_us"}``; the
        client holds ``commit_us`` in its bounded unacked window and drains
        it at durability barriers (dir-fsync, close-of-created-file).

        Modeling idealization: the leader validates and applies the
        mutation to its in-memory tree at ack time, so semantic failures
        (DentryExists, NoSuchInode, ...) still surface synchronously on the
        ack path; only durability (replication to followers) rides the
        background clock.  A dedup-hit replay is already durable, so its
        ``commit_us`` collapses to the ack time."""
        # range check before the leader check: every replica knows the cut,
        # so a misroute NAKs in one round instead of a NotLeader dance first
        self.partitions[partition_id].check_route(payload)
        member = self.raft_members[partition_id]
        if member.role != "leader":
            raise NotLeader(member.leader_id)
        sm = self.partitions[partition_id]
        op = self.net.current_op
        if op is None or not op.timed:
            # untimed callers (setup, recovery scans) take the sync path —
            # there is no client clock to early-ack against
            return {"v": self.propose(partition_id, payload, client_id, seq),  # lint: allow[direct-propose]
                    "mvcc": sm.mvcc, "commit_us": 0.0}
        self.net.charge_busy(self.node_id, self.JOURNAL_APPEND_US)
        op.add(self.JOURNAL_APPEND_US)
        ack_us = op.now_us
        sub = self.net.begin_op(at=ack_us)
        try:
            result = member.propose(payload, client_id=client_id, seq=seq)  # lint: allow[direct-propose]
            for nid in member.peers:
                self.net.charge_busy(nid, self.LOG_APPEND_US)
            sub.add(self.LOG_APPEND_US)
        finally:
            self.net.end_op()
        commit_us = sub.now_us
        self.journal.setdefault(partition_id, []).append(
            {"mvcc": sm.mvcc, "ack_us": ack_us, "commit_us": commit_us})
        return {"v": result, "mvcc": sm.mvcc, "commit_us": commit_us}

    def read(self, partition_id: int, op: str, *args: Any) -> Any:
        """Read op: served from the leader's in-memory state (sequential
        consistency; no quorum read — the paper's relaxed semantics)."""
        sm = self.partitions[partition_id]
        sm.check_read_route(op, args)
        return getattr(sm, op)(*args)

    def read_leased(self, partition_id: int, op: str, *args: Any) -> Dict:
        """Session read: same leader-local read, wrapped in an envelope that
        grants a TTL lease and carries the partition mvcc.  Errors (e.g.
        NoSuchDentry) propagate unleased — the client stamps its negative
        entries with its own (shorter) negative TTL."""
        sm = self.partitions[partition_id]
        sm.check_read_route(op, args)
        return {"v": getattr(sm, op)(*args), "pid": sm.partition_id,
                "mvcc": sm.mvcc, "lease_us": sm.lease_us}

    # ---- reporting -----------------------------------------------------------------
    def mem_used(self) -> int:
        return sum(p.mem_bytes() for p in self.partitions.values())

    def utilization(self) -> float:
        return self.mem_used() / self.mem_capacity if self.mem_capacity else 1.0

    def heartbeat_payload(self) -> Dict[str, Any]:
        return {
            "node": self.node_id,
            "kind": "meta",
            "zone": self.zone,
            "utilization": self.utilization(),
            "partitions": {
                pid: {
                    "entries": p.entries,
                    "inodes": len(p.inode_tree),
                    "mem_bytes": p.mem_bytes(),
                    "max_entries": p.max_entries,
                    "max_inode_id": p.max_inode_id,
                    "end": p.end,
                    "writable": p.writable(),
                    "leader": self.raft_members[pid].role == "leader",
                }
                for pid, p in self.partitions.items()
            },
        }
