"""Resource manager (paper §2.3) — the centralized control plane.

* Replicated 3 ways with raft, state persisted via snapshot (paper: RocksDB).
  Hard state (volumes / partitions / node membership) goes through the raft
  log; utilization and liveness are leader-local *soft state* rebuilt from
  heartbeats after failover — exactly the split a production RM makes.
* **Utilization-based placement** (§2.3.1): new partitions go to the nodes
  with the lowest memory (meta) / disk (data) utilization, preferring one
  *raft set* (§2.5.1).  Capacity expansion therefore never moves existing
  metadata or data — new nodes simply start at utilization 0 and attract all
  new partitions.
* **Meta partition splitting** (§2.3.2, Algorithm 1): only the partition with
  the max id (the one whose range is open at +∞) splits; the RM cuts its range
  at ``maxInodeID + Δ`` and creates a sibling over ``[end+1, ∞)``.
* **Exception handling** (§2.3.3): a partition that reports a replica timeout
  is marked read-only; a dead partition is migrated manually.
* Clients use *non-persistent connections* (§2.5.2): every client→RM exchange
  is a one-shot RPC, nothing is kept per client.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import knobs
from .multiraft import MultiRaftHost, RaftCluster
from .raft import NotLeader, StateMachine
from .simnet import NetError, Network
from .types import MAX_UINT64

__all__ = ["ResourceManager", "RMStateMachine", "SPLIT_DELTA"]

SPLIT_DELTA = knobs.get_int("CFS_META_SPLIT_DELTA")  # Algorithm 1's Δ
MIN_WRITABLE_DATA = 2      # auto-expand a volume below this many writable DPs
META_SPLIT_FRACTION = knobs.get_float("CFS_META_SPLIT_FRACTION")


@dataclass
class PartitionInfo:
    partition_id: int
    volume: str
    kind: str                 # "meta" | "data"
    replicas: List[str]
    start: int = 0            # meta only: inode range
    end: int = MAX_UINT64
    status: str = "rw"


class RMStateMachine(StateMachine):
    """Hard state, replicated by raft."""

    def __init__(self):
        self.nodes: Dict[str, Dict[str, Any]] = {}      # node_id -> {kind, zone}
        self.volumes: Dict[str, Dict[str, List[int]]] = {}
        self.partitions: Dict[int, PartitionInfo] = {}
        self.next_partition_id = 1
        # monotonic routing epoch: bumped on every applied hard-state change,
        # so it advances identically on every replica and survives failover.
        # Clients key their partition tables by it and `client_view` can
        # answer "unchanged" without re-serializing the tables.
        self.epoch = 0

    def apply(self, payload: Any) -> Any:
        op, args = payload[0], payload[1:]
        self.epoch += 1
        return getattr(self, "_ap_" + op)(*args)

    def _ap_register_node(self, node_id: str, kind: str, zone: str) -> bool:
        self.nodes[node_id] = {"kind": kind, "zone": zone}
        return True

    def _ap_remove_node(self, node_id: str) -> bool:
        return self.nodes.pop(node_id, None) is not None

    def _ap_create_volume(self, name: str) -> bool:
        if name in self.volumes:
            return False
        self.volumes[name] = {"meta": [], "data": []}
        return True

    def _ap_add_partition(self, volume: str, kind: str, replicas: List[str],
                          start: int, end: int) -> int:
        pid = self.next_partition_id
        self.next_partition_id += 1
        self.partitions[pid] = PartitionInfo(pid, volume, kind, list(replicas),
                                             start, end)
        self.volumes[volume][kind].append(pid)
        return pid

    def _ap_set_partition_end(self, pid: int, end: int) -> int:
        self.partitions[pid].end = end
        return end

    def _ap_set_partition_status(self, pid: int, status: str) -> str:
        self.partitions[pid].status = status
        return status

    def _ap_set_partition_replicas(self, pid: int, replicas: List[str]) -> bool:
        self.partitions[pid].replicas = list(replicas)
        return True

    def snapshot(self) -> Any:
        return {
            "nodes": {k: dict(v) for k, v in self.nodes.items()},
            "volumes": {k: {kk: list(vv) for kk, vv in v.items()}
                        for k, v in self.volumes.items()},
            "partitions": {
                pid: (p.volume, p.kind, list(p.replicas), p.start, p.end, p.status)
                for pid, p in self.partitions.items()
            },
            "next_pid": self.next_partition_id,
            "epoch": self.epoch,
        }

    def restore(self, snap: Any) -> None:
        self.nodes = {k: dict(v) for k, v in snap["nodes"].items()}
        self.volumes = {k: {kk: list(vv) for kk, vv in v.items()}
                        for k, v in snap["volumes"].items()}
        self.partitions = {
            pid: PartitionInfo(pid, vol, kind, reps, start, end, status)
            for pid, (vol, kind, reps, start, end, status)
            in snap["partitions"].items()
        }
        self.next_partition_id = snap["next_pid"]
        self.epoch = snap.get("epoch", 0)


class ResourceManager:
    """RM replica set + leader-side orchestration.

    ``directory`` maps node_id -> MetaNode/DataNode objects so the leader can
    push tasks (create partition, split) over the simulated network.
    """

    GROUP = "rm"

    def __init__(self, net: Network, raft_cluster: RaftCluster,
                 rm_node_ids: List[str], directory: Dict[str, Any],
                 meta_max_entries: int = 1 << 20,
                 extent_max_size: int = 64 * 1024 * 1024):
        self.net = net
        self.rc = raft_cluster
        self.rm_node_ids = list(rm_node_ids)
        self.directory = directory
        self.meta_max_entries = meta_max_entries
        self.extent_max_size = extent_max_size
        self.sms: Dict[str, RMStateMachine] = {}
        for nid in rm_node_ids:
            sm = RMStateMachine()
            self.sms[nid] = sm
            self.rc.host(nid).add_group(self.GROUP, rm_node_ids, sm)
        # soft state (leader-local): utilization & liveness from heartbeats
        self.soft_util: Dict[str, float] = {}
        self.soft_partition_meta: Dict[int, Dict[str, Any]] = {}
        self.soft_last_hb: Dict[str, float] = {}
        self._seq = 0
        # elastic control plane: the periodic timed control round
        # (heartbeats + Algorithm-1 split check) is knob-gated; every
        # executed split is logged for the expansion benchmark's timeline
        self.autosplit = knobs.get_bool("CFS_META_AUTOSPLIT")
        self.split_fraction = META_SPLIT_FRACTION
        self.hb_period_us = knobs.get_float("CFS_META_HB_US")
        self.split_log: List[Dict[str, Any]] = []

    # ---- leadership ------------------------------------------------------------
    def leader_id(self) -> str:
        leader = self.rc.leader_of(self.GROUP)
        if leader is None:
            leader = self.rc.elect(self.GROUP)
        return leader

    def leader_sm(self) -> RMStateMachine:
        return self.sms[self.leader_id()]

    def _propose(self, payload: Any) -> Any:
        self._seq += 1
        leader = self.leader_id()
        # RM-internal raft (placement state), no client metadata caches
        return self.rc.member(self.GROUP, leader).propose(  # lint: allow[direct-propose]
            payload, client_id="rm", seq=self._seq)

    # ---- node membership ----------------------------------------------------------
    def register_node(self, node: Any) -> None:
        kind = "meta" if hasattr(node, "mem_capacity") else "data"
        self._propose(("register_node", node.node_id, kind, node.zone))
        self.directory[node.node_id] = node
        self.soft_util.setdefault(node.node_id, 0.0)

    def heartbeat(self, payload: Dict[str, Any], now: float = 0.0) -> None:
        """Nodes report utilization + per-partition status (soft state)."""
        nid = payload["node"]
        self.soft_util[nid] = payload["utilization"]
        self.soft_last_hb[nid] = now
        for pid, info in payload.get("partitions", {}).items():
            self.soft_partition_meta[pid] = info
        for pid, status in payload.get("partition_status", {}).items():
            sm = self.leader_sm()
            if pid in sm.partitions and sm.partitions[pid].status != status:
                self._propose(("set_partition_status", pid, status))

    # ---- utilization-based placement (§2.3.1) -----------------------------------------
    def _pick_nodes(self, kind: str, n_replicas: int = 3,
                    exclude: Tuple[str, ...] = ()) -> List[str]:
        """Lowest-utilization nodes, preferring a single raft set (§2.5.1)."""
        sm = self.leader_sm()
        candidates = [
            (self.soft_util.get(nid, 0.0), nid)
            for nid, info in sm.nodes.items()
            if info["kind"] == kind and nid not in exclude
            and nid not in self.net.dead_nodes
        ]
        if len(candidates) < n_replicas:
            raise RuntimeError(f"not enough {kind} nodes: {len(candidates)}")
        candidates.sort()
        # prefer picking all replicas from the raft set of the least-utilized node
        zones: Dict[str, List[str]] = {}
        for util, nid in candidates:
            zones.setdefault(sm.nodes[nid]["zone"], []).append(nid)
        best_zone = sm.nodes[candidates[0][1]]["zone"]
        if len(zones.get(best_zone, [])) >= n_replicas:
            chosen = zones[best_zone][:n_replicas]
        else:
            chosen = [nid for _, nid in candidates[:n_replicas]]
        # allocation-aware projection: bump the estimated utilization so a
        # burst of placements spreads instead of stacking on the same nodes
        # before the next heartbeat refreshes the real numbers.  The bump is
        # the projected memory footprint of the new partition relative to
        # each node's capacity (mean of the observed per-partition sizes);
        # without any heartbeat data yet it falls back to a flat 1% of
        # capacity, the constant before elastic splits.
        for nid in chosen:
            self.soft_util[nid] = min(
                1.0, self.soft_util.get(nid, 0.0)
                + self._projected_bump(nid, kind))
        return chosen

    def _projected_bump(self, nid: str, kind: str) -> float:
        """Estimated utilization delta of placing one new ``kind`` partition
        replica on ``nid`` (soft-state projection, refined by heartbeats)."""
        node = self.directory.get(nid)
        if kind == "meta":
            cap = getattr(node, "mem_capacity", 0)
        else:
            cap = node.disk.capacity if node is not None \
                and hasattr(node, "disk") else 0
        if not cap:
            return 0.01
        sizes = [info["mem_bytes"]
                 for info in self.soft_partition_meta.values()
                 if kind == "meta" and "mem_bytes" in info]
        proj = (sum(sizes) / len(sizes)) if sizes else 0.01 * cap
        return min(1.0, proj / cap)

    # ---- volumes ---------------------------------------------------------------------
    def create_volume(self, name: str, n_meta: int = 3, n_data: int = 10,
                      replicas: int = 3) -> None:
        if not self._propose(("create_volume", name)):
            raise ValueError(f"volume {name} exists")
        # meta partitions split the inode space up front: [1, ∞) on partition 0,
        # later splits cut ranges (Algorithm 1).  Initial volumes get ONE
        # open-ended partition chain: partition i covers [i*SEG+1, (i+1)*SEG]
        # except the last which is open.  We follow the paper: partitions are
        # created in id order; only the max-id partition has end=+∞.
        seg = SPLIT_DELTA * 4
        for i in range(n_meta):
            start = i * seg + 1
            end = MAX_UINT64 if i == n_meta - 1 else (i + 1) * seg
            self._add_meta_partition(name, start, end, replicas)
        for _ in range(n_data):
            self._add_data_partition(name, replicas)

    def _add_meta_partition(self, volume: str, start: int, end: int,
                            replicas: int) -> int:
        nodes = self._pick_nodes("meta", replicas)
        pid = self._propose(("add_partition", volume, "meta", nodes, start, end))
        epoch = self.leader_sm().epoch
        for nid in nodes:
            self.net.call(self.leader_id(), nid,
                          self.directory[nid].add_partition,
                          pid, volume, start, end, nodes,
                          self.meta_max_entries, epoch, kind="rm.task")
        self.rc.elect(f"mp{pid}", preferred=nodes[0])
        return pid

    def _add_data_partition(self, volume: str, replicas: int) -> int:
        nodes = self._pick_nodes("data", replicas)
        pid = self._propose(("add_partition", volume, "data", nodes, 0, 0))
        for nid in nodes:
            self.net.call(self.leader_id(), nid,
                          self.directory[nid].add_partition,
                          pid, volume, nodes, self.extent_max_size,
                          kind="rm.task")
        self.rc.elect(f"dp{pid}", preferred=nodes[0])
        return pid

    # ---- client API (non-persistent connections, §2.5.2) --------------------------------
    def client_view(self, volume: str,
                    known_epoch: int = -1) -> Dict[str, Any]:
        """Everything a client caches at mount: partition routing tables.

        ``known_epoch`` is the routing epoch of the caller's cached table;
        when it matches the current epoch the reply is just
        ``{"epoch", "unchanged": True}`` — the fast path that makes routine
        resyncs O(1) once auto-splits yield hundreds of partitions."""
        sm = self.leader_sm()
        if volume not in sm.volumes:
            raise KeyError(volume)
        if known_epoch == sm.epoch:
            return {"epoch": sm.epoch, "unchanged": True}
        meta, data = [], []
        for pid in sm.volumes[volume]["meta"]:
            p = sm.partitions[pid]
            meta.append({"pid": pid, "start": p.start, "end": p.end,
                         "replicas": list(p.replicas), "status": p.status})
        for pid in sm.volumes[volume]["data"]:
            p = sm.partitions[pid]
            data.append({"pid": pid, "replicas": list(p.replicas),
                         "status": p.status})
        return {"epoch": sm.epoch, "meta": meta, "data": data}

    def statfs(self, volume: str) -> Dict[str, int]:
        """Volume-level statvfs: capacity from the registered data nodes'
        disks, file count from the meta partitions' heartbeat soft state."""
        sm = self.leader_sm()
        if volume not in sm.volumes:
            raise KeyError(volume)
        blocks = used = 0
        for nid, info in sm.nodes.items():
            if info["kind"] != "data" or nid not in self.directory:
                continue
            disk = self.directory[nid].disk
            blocks += disk.capacity
            used += disk.used
        files = sum(self.soft_partition_meta.get(pid, {}).get("inodes", 0)
                    for pid in sm.volumes[volume]["meta"])
        bsize = 4096
        return {
            "f_bsize": bsize,
            "f_blocks": blocks // bsize,
            "f_bfree": (blocks - used) // bsize,
            "f_bavail": (blocks - used) // bsize,
            "f_files": files,
            "f_namemax": 255,
        }

    # ---- meta partition splitting (§2.3.2, Algorithm 1) -----------------------------------
    def maybe_split_meta_partition(self, volume: str) -> Optional[int]:
        """Inspect the volume's max-id meta partition; split if near-full.
        Returns the new partition id, or None."""
        if not self.autosplit:
            return None
        self._finish_pending_splits(volume)
        sm = self.leader_sm()
        meta_pids = sm.volumes[volume]["meta"]
        if not meta_pids:
            return None
        max_pid = max(meta_pids)
        info = self.soft_partition_meta.get(max_pid)
        if info is None:
            return None
        if info["entries"] < self.split_fraction * info["max_entries"]:
            return None
        return self.split_meta_partition(volume, max_pid,
                                         max_inode_id=info["max_inode_id"])

    def split_meta_partition(self, volume: str, pid: int,
                             max_inode_id: int) -> int:
        """Algorithm 1 verbatim."""
        sm = self.leader_sm()
        mp = sm.partitions[pid]
        max_partition_id = max(sm.volumes[volume]["meta"])
        if pid < max_partition_id:          # line 6: only the max partition splits
            return -1
        if mp.end == MAX_UINT64:            # line 7
            end = max_inode_id + SPLIT_DELTA   # line 8: cut off the inode range
            self._propose(("set_partition_end", pid, end))   # line 13 (update)
            # line 14: create the sibling over [end+1, ∞) BEFORE pushing the
            # cut to the old partition, so the epoch it advertises in
            # WrongRange hints names a table that already routes the sibling
            new_pid = self._add_meta_partition(volume, end + 1, MAX_UINT64, 3)
            # line 11-12: sync with the meta node (the split task)
            self._push_set_end(pid, mp.replicas, end, self.leader_sm().epoch)
            op = self.net.current_op
            self.split_log.append({
                "t_us": round(op.now_us, 3)
                        if op is not None and op.timed else 0.0,
                "volume": volume, "pid": pid, "new_pid": new_pid,
                "cut": end, "epoch": self.leader_sm().epoch,
                "files": sum(self.soft_partition_meta.get(p, {})
                             .get("inodes", 0)
                             for p in sm.volumes[volume]["meta"]),
            })
            return new_pid
        return -1

    def _push_set_end(self, pid: int, replicas: List[str], end: int,
                      epoch: int) -> bool:
        """Push the range cut to the live partition as an RM task; the
        epoch rides along so WrongRange hints can name a fresh table."""
        for nid in replicas:
            try:
                self.net.call(self.leader_id(), nid,
                              self.directory[nid].propose,  # lint: allow[direct-propose]
                              pid, ("set_end", end, epoch), kind="rm.task")
                return True  # proposing once through the partition leader suffices
            except (NetError, NotLeader):
                continue
        return False

    def _finish_pending_splits(self, volume: str) -> None:
        """Crash-mid-split recovery: a split is three replicated steps (cut
        the RM range, create the sibling, push the cut to the partition).
        A leader crash between them leaves hard state that a later control
        round detects here and finishes idempotently."""
        sm = self.leader_sm()
        meta_pids = list(sm.volumes[volume]["meta"])
        if not meta_pids:
            return
        mp = sm.partitions[max(meta_pids)]
        if mp.end != MAX_UINT64:
            # crashed after the cut, before the sibling: the range cover has
            # a gap at [end+1, ∞) — create the missing sibling now
            self._add_meta_partition(volume, mp.end + 1, MAX_UINT64, 3)
        # re-push the cut to any partition whose live SM still serves a
        # wider range than the hard state records (idempotent)
        for pid in meta_pids:
            p = sm.partitions[pid]
            if p.end == MAX_UINT64:
                continue
            for nid in p.replicas:
                node = self.directory.get(nid)
                if (node is not None and nid not in self.net.dead_nodes
                        and pid in getattr(node, "partitions", {})
                        and node.partitions[pid].end != p.end):
                    self._push_set_end(pid, p.replicas, p.end, sm.epoch)
                    break

    # ---- periodic timed control round ---------------------------------------------
    def control_tick(self) -> None:
        """One timed control-plane round: every live node pushes its
        heartbeat to the RM leader over simnet (concurrent branches under
        the caller's op), then the leader runs the Algorithm-1 split check
        per volume as a timed task.  Benchmarks arm this periodically
        (``hb_period_us``); the untimed driver path stays
        ``CfsCluster.tick``."""
        leader = self.leader_id()
        op = self.net.current_op
        fork = op.fork() if op is not None and op.timed else None
        now = op.now_us if op is not None else 0.0
        for nid in sorted(self.directory):
            if nid in self.net.dead_nodes:
                continue
            payload = self.directory[nid].heartbeat_payload()
            try:
                self.net.call(nid, leader, self.heartbeat, payload, now,
                              kind="rm.hb")
            except NetError:
                pass
            if fork is not None:
                fork.branch_done()
        if fork is not None:
            fork.join()
        for vol in sorted(self.leader_sm().volumes):
            self.maybe_split_meta_partition(vol)

    # ---- volume auto-expansion (§2.3.1 second para) -------------------------------------------
    def check_volumes(self) -> List[int]:
        """Add data partitions to volumes running out of writable ones.
        No existing partition moves — that is the no-rebalancing property."""
        created = []
        sm = self.leader_sm()
        for vol, parts in sm.volumes.items():
            writable = [pid for pid in parts["data"]
                        if sm.partitions[pid].status == "rw"]
            if len(writable) < MIN_WRITABLE_DATA:
                for _ in range(MIN_WRITABLE_DATA - len(writable)):
                    created.append(self._add_data_partition(vol, 3))
            self.maybe_split_meta_partition(vol)
        return created

    # ---- exception handling (§2.3.3) ---------------------------------------------------------
    def report_timeout(self, pid: int) -> None:
        """A client/node observed a replica timeout: mark remaining read-only."""
        self._propose(("set_partition_status", pid, "ro"))

    def migrate_partition(self, pid: int) -> List[str]:
        """Manual migration of an unavailable partition to fresh nodes."""
        sm = self.leader_sm()
        p = sm.partitions[pid]
        new_nodes = self._pick_nodes(p.kind, len(p.replicas),
                                     exclude=tuple(p.replicas))
        self._propose(("set_partition_replicas", pid, new_nodes))
        self._propose(("set_partition_status", pid, "rw"))
        return new_nodes
