"""Data nodes and data partitions with scenario-aware replication (§2.2).

Two strongly consistent protocols on the SAME partition (the paper's core
data-plane idea):

* **append** (sequential write) — primary-backup *chain*: the client sends a
  ≤128 KB packet to the leader (``replicas[0]``); the leader writes locally
  then forwards down the replica order.  The commit point of offset ``o``
  implies every byte before ``o`` is committed, so the group tracks one
  *committed offset* per extent = the largest prefix acked by ALL replicas.
  Stale tails are allowed on replicas — they are simply never served, and
  recovery truncates them (§2.2.5).  If only ``p`` of ``k`` MB commit, the
  client re-sends the remaining ``k−p`` to a different partition.

* **overwrite** — MultiRaft: the mutation is a raft log entry applied by every
  replica's extent store.  Raft's write amplification (log + data) is accepted
  because overwrites are rare (§2.2.4); it avoids the fragmentation/linked-
  list/defragmentation problem PB would create for in-place updates.

Recovery order on failure (§2.2.5): first align extents to the committed
offsets (PB path), then let raft replay the overwrite log.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import knobs
from ..analysis import sanitizer as _san
from .extent_store import ExtentError, ExtentStore
from .multiraft import MultiRaftHost
from .raft import NotCommitted, NotLeader, StateMachine
from .simnet import Disk, NetError, Network, OpTimer
from .types import PACKET_SIZE

__all__ = ["Busy", "DataNode", "DataPartitionReplica", "PartitionStatus",
           "WriteResult"]

# admission bound (CFS_QOS_ADMIT_US): the most virtual queue, in µs, a data
# node accepts from one tenant volume while another tenant is active before
# NAKing with Busy.  Module-level so tests can monkeypatch it.
QOS_ADMIT_US = knobs.get_float("CFS_QOS_ADMIT_US")


class Busy(Exception):
    """Admission-control NAK (CFS_QOS): this node's virtual queue for the
    calling tenant's volume is over the ``CFS_QOS_ADMIT_US`` bound while
    another tenant is active.  ``retry_after_us`` hints when the backlog
    drains below the bound; the client backs off and re-routes the retry
    to another replica/partition instead of piling onto this queue."""

    def __init__(self, node_id: str, retry_after_us: float):
        super().__init__(f"{node_id} busy; retry in {retry_after_us:.0f}us")
        self.node_id = node_id
        self.retry_after_us = retry_after_us


class PartitionStatus:
    READ_WRITE = "rw"
    READ_ONLY = "ro"
    UNAVAILABLE = "unavailable"


@dataclass
class WriteResult:
    """Reply to an append: how much of this packet is committed on ALL replicas."""
    extent_id: int
    committed_size: int       # extent-level committed size after this write
    accepted: int             # bytes of this packet committed (0 => resend elsewhere)


class _OverwriteSM(StateMachine):
    """Raft state machine for the overwrite path of one data partition."""

    def __init__(self, store: ExtentStore):
        self.store = store

    def apply(self, payload: Any) -> Any:
        op = payload[0]
        if op == "overwrite":
            _, extent_id, offset, data = payload
            self.store.overwrite(extent_id, offset, data)
            return len(data)
        if op == "create_extent":
            _, extent_id, is_tiny = payload
            if not self.store.has(extent_id):
                self.store.create_extent(is_tiny=is_tiny, extent_id=extent_id)
            return extent_id
        raise ValueError(op)

    def snapshot(self) -> Any:
        return self.store.snapshot()

    def restore(self, snap: Any) -> None:
        self.store.restore(snap)


class DataPartitionReplica:
    """One replica of a data partition, hosted on a data node (paper's
    ``type dataPartition`` struct)."""

    def __init__(self, partition_id: int, volume: str, node: "DataNode",
                 replicas: List[str], extent_max_size: int):
        self.partition_id = partition_id
        self.volume = volume
        self.node = node
        self.replicas = list(replicas)       # node ids; index 0 == PB leader
        self.status = PartitionStatus.READ_WRITE
        self.store = ExtentStore(node.disk, extent_max_size=extent_max_size)
        # leader-only: per-extent sizes acked per replica (for committed offset)
        self.acked_sizes: Dict[int, Dict[str, int]] = {}
        self.raft = None  # RaftMember, set by DataNode.add_partition

    # ---- identity ---------------------------------------------------------
    @property
    def is_pb_leader(self) -> bool:
        return self.replicas and self.replicas[0] == self.node.node_id

    def group_id(self) -> str:
        return f"dp{self.partition_id}"

    def committed_size(self, extent_id: int) -> int:
        acks = self.acked_sizes.get(extent_id)
        if not acks:
            return self.store.get(extent_id).size if self.store.has(extent_id) else 0
        return min(acks.values())

    # ---- append path (primary-backup chain) --------------------------------
    def leader_append(self, extent_id: int, offset: int, data: bytes,
                      create: bool = False) -> WriteResult:
        """Entry point on the PB leader.  Writes locally, chains to backups,
        returns the committed offset (paper: 'the leader always returns the
        largest offset that has been committed by all the replicas').  A
        replica that is NOT the PB leader NAKs with a hint instead of
        accepting the write — a client whose leader cache went stale (or was
        poisoned by a read-serving follower) must be redirected, never
        silently fork the chain."""
        if not self.is_pb_leader:
            raise NotLeader(self.replicas[0] if self.replicas else None)
        if self.status != PartitionStatus.READ_WRITE:
            raise ExtentError(f"partition {self.partition_id} is {self.status}")
        if create and not self.store.has(extent_id):
            self.store.create_extent(extent_id=extent_id)
        # the local media write and the chain forward proceed concurrently:
        # the ack only needs both done, not one after the other
        op = self.node.op()
        fork = op.fork() if op is not None and op.timed else None
        my_size = self.store.append(extent_id, offset, data, op)
        if fork is not None:
            fork.branch_done()
        acks = self.acked_sizes.setdefault(extent_id, {})
        acks[self.node.node_id] = my_size
        # forward down the chain
        chain = self.replicas[1:]
        chain_ok = True
        if chain:
            try:
                sizes = self.node.net.call(
                    self.node.node_id, chain[0],
                    self.node.registry[chain[0]].chain_append,
                    self.partition_id, extent_id, offset, data, create, chain[1:],
                    nbytes=len(data) + 128, kind="pb.append",
                )
                for nid, size in sizes.items():
                    acks[nid] = size
            except (NetError, ExtentError):
                chain_ok = False
        if fork is not None:
            fork.join()
        if not chain_ok or any(nid not in acks for nid in self.replicas):
            # §2.3.3: a replica timed out -> mark remaining replicas read-only;
            # the committed prefix stays serveable, the tail is resent elsewhere.
            self.status = PartitionStatus.READ_ONLY
        committed = min(acks.get(nid, 0) for nid in self.replicas)
        if _san.SAN is not None:
            _san.SAN.note_commit(self.partition_id, extent_id, committed, op)
        accepted = max(0, committed - offset)
        return WriteResult(extent_id, committed, accepted)

    def chain_write(self, extent_id: int, offset: int, data: bytes,
                    create: bool, rest: List[str]) -> Dict[str, int]:
        """Backup-side: write locally while forwarding to the rest of the
        chain (cut-through, like the leader)."""
        if create and not self.store.has(extent_id):
            self.store.create_extent(extent_id=extent_id)
        op = self.node.op()
        fork = op.fork() if op is not None and op.timed else None
        my_size = self.store.append(extent_id, offset, data, op)
        if fork is not None:
            fork.branch_done()
        sizes = {self.node.node_id: my_size}
        if rest:
            nxt = rest[0]
            sizes.update(self.node.net.call(
                self.node.node_id, nxt,
                self.node.registry[nxt].chain_append,
                self.partition_id, extent_id, offset, data, create, rest[1:],
                nbytes=len(data) + 128, kind="pb.append",
            ))
        if fork is not None:
            fork.join()
        return sizes

    def leader_small_write(self, data: bytes) -> Tuple[int, int, int]:
        """Small-file aggregated write (§2.2.3): the leader picks the shared
        tiny extent + physical offset, then chains the same placement to the
        backups (the ordered chain keeps every replica's tiny extent aligned).
        Returns (extent_id, physical_offset, committed_bytes)."""
        if not self.is_pb_leader:
            raise NotLeader(self.replicas[0] if self.replicas else None)
        if self.status != PartitionStatus.READ_WRITE:
            raise ExtentError(f"partition {self.partition_id} is {self.status}")
        op = self.node.op()
        eid, off = self.store.write_small(data, op)
        acks = self.acked_sizes.setdefault(eid, {})
        acks[self.node.node_id] = off + len(data)
        chain = self.replicas[1:]
        if chain:
            try:
                sizes = self.node.net.call(
                    self.node.node_id, chain[0],
                    self.node.registry[chain[0]].chain_small,
                    self.partition_id, eid, off, data, chain[1:],
                    nbytes=len(data) + 128, kind="pb.small",
                )
                for nid, size in sizes.items():
                    acks[nid] = size
            except (NetError, ExtentError):
                self.status = PartitionStatus.READ_ONLY
        committed = min(acks.get(nid, 0) for nid in self.replicas)
        if _san.SAN is not None:
            _san.SAN.note_commit(self.partition_id, eid, committed, op)
        return eid, off, max(0, committed - off)

    def chain_small_write(self, extent_id: int, offset: int, data: bytes,
                          rest: List[str]) -> Dict[str, int]:
        if not self.store.has(extent_id):
            self.store.create_extent(is_tiny=True, extent_id=extent_id)
        my_size = self.store.append(extent_id, offset, data, self.node.op())
        sizes = {self.node.node_id: my_size}
        if rest:
            nxt = rest[0]
            sizes.update(self.node.net.call(
                self.node.node_id, nxt,
                self.node.registry[nxt].chain_small,
                self.partition_id, extent_id, offset, data, rest[1:],
                nbytes=len(data) + 128, kind="pb.small",
            ))
        return sizes

    # ---- overwrite path (raft) ----------------------------------------------
    def leader_overwrite(self, extent_id: int, offset: int, data: bytes) -> int:
        if self.raft is None:
            raise ExtentError("no raft group")
        # data-plane raft (overwrite log), no metadata caches to
        # invalidate  # lint: allow[direct-propose]
        return self.raft.propose(("overwrite", extent_id, offset, data))  # lint: allow[direct-propose]

    # ---- read ------------------------------------------------------------------
    def read(self, extent_id: int, offset: int, size: int,
             verify_crc: bool = False) -> bytes:
        """Serve a read bounded by the committed offset (stale tails on
        followers are never returned, §2.2.5)."""
        op = self.node.op()
        if _san.SAN is not None:
            # group-wide committed-prefix check: extends the leader-only
            # guard below to followers, whose local acked_sizes are empty
            _san.SAN.check_read(self.partition_id, extent_id,
                                offset, offset + size, op)
        committed = self.committed_size(extent_id)
        if offset + size > committed and self.is_pb_leader:
            raise ExtentError(
                f"read beyond committed offset {committed} (req {offset}+{size})")
        return self.store.read(extent_id, offset, size, op,
                               verify_crc=verify_crc)

    # ---- recovery (§2.2.5) -------------------------------------------------------
    def recover_from_leader(self, leader_replica: "DataPartitionReplica") -> None:
        """Step 1: check and align all extents against the committed offsets.
        Step 2 (raft replay) happens automatically once the raft member
        rejoins — the leader's AppendEntries/snapshot catches it up."""
        for eid, lext in list(leader_replica.store.extents.items()):
            committed = leader_replica.committed_size(eid)
            if not self.store.has(eid):
                self.store.create_extent(extent_id=eid, is_tiny=lext.is_tiny)
            mine = self.store.get(eid)
            if mine.size > committed:
                self.store.truncate(eid, committed)
            if mine.size < committed:
                missing = leader_replica.store.read(eid, mine.size,
                                                    committed - mine.size)
                self.store.append(eid, mine.size, missing, self.node.op())
            leader_replica.acked_sizes.setdefault(eid, {})[
                self.node.node_id] = self.store.get(eid).size


class DataNode:
    """A storage node hosting many data-partition replicas (paper Fig. 1)."""

    def __init__(self, node_id: str, net: Network,
                 registry: Dict[str, "DataNode"],
                 raft_registry: Dict[str, MultiRaftHost],
                 disk_capacity: int = 16 * 1024 * 1024 * 1024,
                 zone: str = "set0"):
        self.node_id = node_id
        self.net = net
        self.registry = registry
        self.disk = Disk(disk_capacity, net.model, owner=node_id, net=net)
        self.partitions: Dict[int, DataPartitionReplica] = {}
        self.raft_host = MultiRaftHost(node_id, net, raft_registry)
        self.zone = zone  # raft set (§2.5.1)
        # per-volume admission ledger: volume -> virtual time its accepted
        # backlog on this node drains (CFS_QOS admission control); stamped
        # with the network's timeline epoch so a reset_accounting() (new
        # virtual timeline) drops entries parked in the old clock's future
        self._admit_until: Dict[str, float] = {}
        self._admit_epoch = net.timeline_epoch
        self.sheds = 0
        registry[node_id] = self

    def op(self) -> Optional[OpTimer]:
        return self.net.current_op

    def _admit(self, cost_us: float) -> None:
        """Per-tenant admission control at the leader RPC entry points.

        Bounds the virtual queue this node accepts per volume: while
        another tenant is active here, a request that would push its
        volume's backlog past ``CFS_QOS_ADMIT_US`` is NAKed with
        :class:`Busy` (the NAK still pays a reply round in ``_timed_call``)
        instead of being buried in the queue.  With a single tenant — or
        untimed/untagged ops — this is pure bookkeeping and never sheds,
        which keeps every single-volume baseline byte-identical.  Chain
        legs (``chain_append``/``chain_small``) are never admission-checked:
        a mid-chain shed would fork the replication chain."""
        net = self.net
        if not net.qos or QOS_ADMIT_US <= 0:
            return
        op = net.current_op
        if op is None or not op.timed or op.tenant is None:
            return
        vol = op.tenant[0]
        now = op.now_us
        ledger = self._admit_until
        if self._admit_epoch != net.timeline_epoch:
            ledger.clear()
            self._admit_epoch = net.timeline_epoch
        for v in [v for v, until in ledger.items() if until <= now]:
            del ledger[v]
        projected = max(ledger.get(vol, now), now) + cost_us
        foreign = max((until for v, until in ledger.items() if v != vol),
                      default=now)
        if foreign > now and projected - now > QOS_ADMIT_US:
            self.sheds += 1
            # the hint must cover the cross-tenant pressure horizon, not
            # just this volume's own drain — a shorter hint would bounce
            # the client straight back into the same NAK
            retry = max(projected - now - QOS_ADMIT_US, foreign - now)
            raise Busy(self.node_id, retry)
        ledger[vol] = projected

    # ---- partition lifecycle -------------------------------------------------
    def add_partition(self, partition_id: int, volume: str, replicas: List[str],
                      extent_max_size: int = 64 * 1024 * 1024) -> DataPartitionReplica:
        rep = DataPartitionReplica(partition_id, volume, self, replicas,
                                   extent_max_size)
        self.partitions[partition_id] = rep
        rep.raft = self.raft_host.add_group(rep.group_id(), replicas,
                                            _OverwriteSM(rep.store))
        return rep

    def remove_partition(self, partition_id: int) -> None:
        rep = self.partitions.pop(partition_id, None)
        if rep is not None:
            self.raft_host.remove_group(rep.group_id())
            for eid in list(rep.store.extents):
                rep.store.delete_extent(eid)

    # ---- RPC endpoints (called through simnet) -----------------------------------
    def chain_append(self, partition_id: int, extent_id: int, offset: int,
                     data: bytes, create: bool, rest: List[str]) -> Dict[str, int]:
        return self.partitions[partition_id].chain_write(
            extent_id, offset, data, create, rest)

    def serve_read(self, partition_id: int, extent_id: int, offset: int,
                   size: int, verify_crc: bool = False) -> bytes:
        self._admit(self.net.model.disk_cost(size))
        return self.partitions[partition_id].read(extent_id, offset, size,
                                                  verify_crc=verify_crc)

    def serve_append(self, partition_id: int, extent_id: int, offset: int,
                     data: bytes, create: bool = False) -> WriteResult:
        self._admit(self.net.model.disk_cost(len(data)))
        return self.partitions[partition_id].leader_append(
            extent_id, offset, data, create=create)

    def serve_overwrite(self, partition_id: int, extent_id: int, offset: int,
                        data: bytes) -> int:
        return self.partitions[partition_id].leader_overwrite(
            extent_id, offset, data)

    def serve_small_write(self, partition_id: int, data: bytes) -> Tuple[int, int, int]:
        self._admit(self.net.model.disk_cost(len(data)))
        return self.partitions[partition_id].leader_small_write(data)

    def chain_small(self, partition_id: int, extent_id: int, offset: int,
                    data: bytes, rest: List[str]) -> Dict[str, int]:
        return self.partitions[partition_id].chain_small_write(
            extent_id, offset, data, rest)

    def serve_delete_extent(self, partition_id: int, extent_id: int) -> None:
        """Large-file delete: remove extents on every replica (async task)."""
        self.partitions[partition_id].store.delete_extent(extent_id)

    def serve_punch_hole(self, partition_id: int, extent_id: int,
                         offset: int, length: int) -> None:
        self.partitions[partition_id].store.punch_hole(extent_id, offset, length)

    def background_tasks(self) -> int:
        """Run async work: punch-hole processing on every partition."""
        freed = 0
        for rep in self.partitions.values():
            freed += rep.store.process_punch_holes()
        return freed

    # ---- reporting ---------------------------------------------------------------
    def utilization(self) -> float:
        return self.disk.utilization

    def heartbeat_payload(self) -> Dict[str, Any]:
        return {
            "node": self.node_id,
            "kind": "data",
            "zone": self.zone,
            "utilization": self.utilization(),
            "partition_status": {
                pid: rep.status for pid, rep in self.partitions.items()
            },
        }
