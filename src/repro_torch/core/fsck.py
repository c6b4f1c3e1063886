"""fsck — the administrator's repair tool the paper points to (§2.6):

    "a meta node rarely has too many orphan inodes in the memory.  But if
     this happens, tools like fsck can be used to repair the files by the
     administrator."

Walks every meta partition of a volume and cross-references the inode and
dentry b-trees:

  * ORPHAN INODES — inodes with nlink==0 / MARK_DELETED, or live inodes no
    dentry references (the failure arm of Fig. 3 when the client died
    before sending evict).  Repair: evict via the partition's raft group +
    free the data extents (punch holes / drop extents).
  * DANGLING DENTRIES — dentries whose inode no longer exists.  The
    relaxed-atomicity design makes these impossible through the normal
    workflows (dentry is only created AFTER the inode), so any hit is
    flagged as corruption and repaired by deleting the dentry.
  * REFCOUNT DRIFT — inode.nlink != number of referencing dentries
    (+ implicit "." for dirs); repaired to the observed count.

It also verifies the PARTITION-RANGE invariants a split must
preserve (crash-mid-split is the scenario that can break them):

  * RANGE OVERLAPS — no inode id covered by two meta partitions of the
    volume (the RM's hard-state ranges must be pairwise disjoint).
  * RANGE GAPS — the ranges must cover [1, ∞) contiguously: each partition
    starts exactly one past its predecessor's end and the max-id partition
    is open-ended (a leader crash between the range cut and the sibling
    creation leaves a gap the control loop must close).
  * RANGE MISMATCHES — a live partition SM still serving a wider range
    than the RM's hard state records (the set_end task never landed).
  * MISPLACED INODES — stored inodes outside their partition's hard-state
    range.
  * UNROUTABLE DENTRIES — a dentry whose child inode no range covers.

Range invariants are detected only — repair is the RM control loop's
``_finish_pending_splits`` (replicated, idempotent), not fsck's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from .fs import CfsCluster
from .types import MAX_UINT64, ROOT_INODE, InodeFlag, InodeType

__all__ = ["FsckReport", "fsck"]


@dataclass
class FsckReport:
    volumes: List[str] = field(default_factory=list)
    inodes_scanned: int = 0
    dentries_scanned: int = 0
    orphan_inodes: List[int] = field(default_factory=list)
    dangling_dentries: List[Tuple[int, str]] = field(default_factory=list)
    nlink_drift: List[Tuple[int, int, int]] = field(default_factory=list)
    # partition-range invariants: see module docstring
    range_overlaps: List[Tuple[int, int]] = field(default_factory=list)
    range_gaps: List[Tuple[int, int]] = field(default_factory=list)
    range_mismatches: List[int] = field(default_factory=list)
    misplaced_inodes: List[Tuple[int, int]] = field(default_factory=list)
    unroutable_dentries: List[Tuple[int, str, int]] = field(
        default_factory=list)
    repaired: int = 0
    bytes_freed: int = 0

    @property
    def clean(self) -> bool:
        return not (self.orphan_inodes or self.dangling_dentries
                    or self.nlink_drift or self.range_overlaps
                    or self.range_gaps or self.range_mismatches
                    or self.misplaced_inodes or self.unroutable_dentries)


def _volume_partitions(cluster: CfsCluster, volume: str):
    sm = cluster.rm.leader_sm()
    for pid in sm.volumes[volume]["meta"]:
        info = sm.partitions[pid]
        leader = cluster.rc.leader_of(f"mp{pid}")
        node = cluster.meta_nodes[leader or info.replicas[0]]
        yield pid, node, node.partitions[pid]


def _check_ranges(cluster: CfsCluster, volume: str, rep: FsckReport) -> None:
    """Partition-range invariants: the RM's hard-state ranges must
    tile [1, ∞) with no overlap, and every live partition SM must agree
    with them (a crash mid-split breaks exactly one of these)."""
    sm = cluster.rm.leader_sm()
    ranges = sorted(
        (sm.partitions[pid].start, sm.partitions[pid].end, pid)
        for pid in sm.volumes[volume]["meta"])
    prev_end, prev_pid = 0, -1
    for start, end, pid in ranges:
        if start <= prev_end and prev_pid >= 0:
            rep.range_overlaps.append((prev_pid, pid))
        elif start > prev_end + 1:
            rep.range_gaps.append((prev_end + 1, start - 1))
        prev_end, prev_pid = end, pid
    if ranges and prev_end != MAX_UINT64:
        # the max partition was cut but its sibling never materialized:
        # [prev_end+1, ∞) is uncovered
        rep.range_gaps.append((prev_end + 1, MAX_UINT64))
    for start, end, pid in ranges:
        info = sm.partitions[pid]
        # judge the group LEADER's live SM — it is the serving authority;
        # followers converge to it through raft replay and may lag benignly
        nid = cluster.rc.leader_of(f"mp{pid}") or info.replicas[0]
        node = cluster.meta_nodes.get(nid)
        if (node is not None and nid not in cluster.net.dead_nodes
                and pid in node.partitions
                and (node.partitions[pid].end != end
                     or node.partitions[pid].start != start)):
            rep.range_mismatches.append(pid)


def fsck(cluster: CfsCluster, volume: str, repair: bool = False) -> FsckReport:
    """Scan (and optionally repair) one volume's metadata."""
    rep = FsckReport(volumes=[volume])
    _check_ranges(cluster, volume, rep)
    sm = cluster.rm.leader_sm()
    hard = {pid: (sm.partitions[pid].start, sm.partitions[pid].end)
            for pid in sm.volumes[volume]["meta"]}

    # pass 1: collect every inode and every dentry reference
    referenced: Dict[int, int] = {}          # inode id -> #dentries
    all_inodes: Dict[int, Tuple[int, object]] = {}  # ino -> (pid, Inode)
    for pid, node, part in _volume_partitions(cluster, volume):
        lo, hi = hard.get(pid, (part.start, part.end))
        for ino, inode in part.inode_tree.items():
            all_inodes[ino] = (pid, inode)
            rep.inodes_scanned += 1
            if not lo <= ino <= hi:
                rep.misplaced_inodes.append((pid, ino))
        for (parent, name), d in part.dentry_tree.items():
            referenced[d.inode] = referenced.get(d.inode, 0) + 1
            rep.dentries_scanned += 1

    # pass 2: cross-reference
    dangling: List[Tuple[int, int, str]] = []   # (pid, parent, name)
    for pid, node, part in _volume_partitions(cluster, volume):
        for (parent, name), d in list(part.dentry_tree.items()):
            if d.inode not in all_inodes:
                dangling.append((pid, parent, name))
                rep.dangling_dentries.append((parent, name))
            if not any(lo <= d.inode <= hi for lo, hi in hard.values()):
                # no partition range covers the child inode: a client
                # cannot route a getattr for it at all
                rep.unroutable_dentries.append((parent, name, d.inode))

    for ino, (pid, inode) in all_inodes.items():
        refs = referenced.get(ino, 0)
        expected = refs + (2 if inode.type == InodeType.DIR else 0)
        if ino == ROOT_INODE:
            continue
        if inode.flag == InodeFlag.MARK_DELETED or refs == 0:
            rep.orphan_inodes.append(ino)
        elif inode.type != InodeType.DIR and inode.nlink != refs:
            rep.nlink_drift.append((ino, inode.nlink, refs))

    if not repair:
        return rep

    # pass 3: repair through the normal replicated paths (never poke state
    # machines directly — repairs must survive failover like any other op)
    admin = cluster.mount(volume, client_id="fsck")
    for pid, parent, name in dangling:
        mp = next(m for m in admin.client.meta_partitions if m.pid == pid)
        try:
            admin.client._meta_propose(mp, ("delete_dentry", parent, name))
            rep.repaired += 1
        except Exception:
            pass
    for ino in rep.orphan_inodes:
        try:
            mp = admin.client._mp_for_inode(ino)
            # force the nlink to zero first if a live orphan (refs == 0)
            res = admin.client._meta_propose(mp, ("unlink_dec", ino))
            res = admin.client._meta_propose(mp, ("evict", ino))
            if res["ok"]:
                rep.repaired += 1
                rep.bytes_freed += res.get("size", 0)
                admin.client._free_extents(res["extents"], res["size"])
        except Exception:
            pass
    for ino, had, want in rep.nlink_drift:
        try:
            mp = admin.client._mp_for_inode(ino)
            op = "link_inc" if had < want else "unlink_dec"
            for _ in range(abs(want - had)):
                admin.client._meta_propose(mp, (op, ino))
            rep.repaired += 1
        except Exception:
            pass
    cluster.run_background_tasks()
    return rep
