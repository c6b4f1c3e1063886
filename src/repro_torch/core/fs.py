"""Cluster assembly + path-level POSIX-like API (relaxed semantics, §2.7).

``CfsCluster`` wires up the whole simulated deployment (Figure 1): a 3-replica
resource manager, N meta nodes, M data nodes, the raft fabric, and hands out
``CfsMount`` objects — one per container/client.

``CfsMount`` resolves paths to inodes by walking dentries from the root and
exposes open/read/write/mkdir/readdir/stat/unlink/rename/link/symlink.
Consistency is the paper's: sequential consistency per file op, no leases, no
cross-client write atomicity for overlapping ranges.
"""

from __future__ import annotations

import errno
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from .client import (CfsClient, CfsFile, DirNotEmpty, Exists, FsError,
                     IsADirectory, NotADirectory, NotFound)
from .data_node import DataNode
from .meta_node import MetaNode
from .multiraft import RaftCluster
from .resource_manager import ResourceManager
from .simnet import LatencyModel, Network
from .types import ROOT_INODE, InodeType
from .vfs import (CfsOSError, CfsVfs, O_APPEND, O_CREAT, O_EXCL, O_RDONLY,
                  O_RDWR, O_TRUNC, O_WRONLY)

__all__ = ["CfsCluster", "CfsMount"]


class CfsCluster:
    """A whole simulated CFS deployment on one box."""

    def __init__(
        self,
        n_meta: int = 4,
        n_data: int = 6,
        n_rm: int = 3,
        meta_mem_capacity: int = 64 * 1024 * 1024,
        data_disk_capacity: int = 1024 * 1024 * 1024,
        meta_max_entries: int = 1 << 20,
        extent_max_size: int = 8 * 1024 * 1024,
        raft_set_size: int = 6,
        latency: Optional[LatencyModel] = None,
        seed: int = 0,
    ):
        self.net = Network(model=latency, seed=seed)
        self.rc = RaftCluster(self.net)
        self.meta_nodes: Dict[str, MetaNode] = {}
        self.data_nodes: Dict[str, DataNode] = {}
        self.directory: Dict[str, Any] = {}
        self.meta_max_entries = meta_max_entries
        self.extent_max_size = extent_max_size
        self.raft_set_size = raft_set_size
        self._client_count = 0

        rm_ids = [f"rm{i}" for i in range(n_rm)]
        self.rm = ResourceManager(self.net, self.rc, rm_ids, self.directory,
                                  meta_max_entries=meta_max_entries,
                                  extent_max_size=extent_max_size)
        self.rc.elect(ResourceManager.GROUP)

        for i in range(n_meta):
            self.add_meta_node(mem_capacity=meta_mem_capacity)
        for i in range(n_data):
            self.add_data_node(disk_capacity=data_disk_capacity)

    # ---- capacity expansion (the no-rebalancing scenario) ---------------------
    def add_meta_node(self, mem_capacity: int = 64 * 1024 * 1024) -> MetaNode:
        i = len(self.meta_nodes)
        zone = f"set{i // self.raft_set_size}"   # raft sets (§2.5.1)
        node = MetaNode(f"m{i}", self.net, self.meta_nodes, self.rc.registry,
                        mem_capacity=mem_capacity, zone=zone)
        self.rm.register_node(node)
        return node

    def add_data_node(self, disk_capacity: int = 1024 * 1024 * 1024) -> DataNode:
        i = len(self.data_nodes)
        zone = f"set{i // self.raft_set_size}"
        node = DataNode(f"d{i}", self.net, self.data_nodes, self.rc.registry,
                        disk_capacity=disk_capacity, zone=zone)
        self.rm.register_node(node)
        return node

    # ---- volumes ---------------------------------------------------------------
    def create_volume(self, name: str, n_meta_partitions: int = 3,
                      n_data_partitions: int = 10, replicas: int = 3) -> None:
        self.rm.create_volume(name, n_meta=n_meta_partitions,
                              n_data=n_data_partitions, replicas=replicas)
        # initialize the root directory inode (id 1) on the partition whose
        # inode range covers id 1
        boot = CfsClient("boot", self.net, self.rm, self.meta_nodes,
                         self.data_nodes, name)
        mp = boot._mp_for_inode(ROOT_INODE)
        root = boot._meta_propose(mp, ("create_inode", InodeType.DIR, b"", 0.0))
        assert root["inode"] == ROOT_INODE, root

    def mount(self, volume: str, client_id: Optional[str] = None) -> "CfsMount":
        self._client_count += 1
        cid = client_id or f"client{self._client_count}"
        client = CfsClient(cid, self.net, self.rm, self.meta_nodes,
                           self.data_nodes, volume,
                           rng_seed=self._client_count)
        return CfsMount(client)

    # ---- time / background work ---------------------------------------------------
    def tick(self, n: int = 1) -> None:
        """Advance raft timers + heartbeats + RM housekeeping."""
        for _ in range(n):
            self.rc.tick_all()
            for node in list(self.meta_nodes.values()):
                if node.node_id in self.net.dead_nodes:
                    continue
                try:
                    self.rm.heartbeat(node.heartbeat_payload())
                except Exception:
                    pass
            for node in list(self.data_nodes.values()):
                if node.node_id in self.net.dead_nodes:
                    continue
                try:
                    self.rm.heartbeat(node.heartbeat_payload())
                except Exception:
                    pass
        try:
            self.rm.check_volumes()
        except Exception:
            pass

    def control_tick(self) -> None:
        """One TIMED control-plane round (heartbeats over simnet + the
        Algorithm-1 split check) under the caller's op — the event-driven
        counterpart of :meth:`tick` for benchmark timelines.  Arm it
        periodically at ``rm.hb_period_us`` (knob ``CFS_META_HB_US``)."""
        self.rm.control_tick()

    def run_background_tasks(self) -> int:
        """Punch-hole workers etc.  Returns bytes freed."""
        return sum(n.background_tasks() for n in self.data_nodes.values()
                   if n.node_id not in self.net.dead_nodes)

    # ---- fault injection helpers ------------------------------------------------------
    def kill_node(self, node_id: str) -> None:
        self.net.kill(node_id)

    def revive_node(self, node_id: str) -> None:
        self.net.revive(node_id)

    def recover_data_node(self, node_id: str) -> None:
        """§2.2.5 recovery: align extents from each partition's PB leader,
        then raft replay happens on subsequent ticks."""
        self.net.revive(node_id)
        node = self.data_nodes[node_id]
        for pid, rep in node.partitions.items():
            leader_nid = rep.replicas[0]
            if leader_nid == node_id or leader_nid in self.net.dead_nodes:
                continue
            leader_rep = self.data_nodes[leader_nid].partitions[pid]
            rep.recover_from_leader(leader_rep)


_LEGACY_EXC = {
    errno.ENOENT: NotFound,
    errno.EEXIST: Exists,
    errno.ENOTDIR: NotADirectory,
    errno.EISDIR: IsADirectory,
    errno.ENOTEMPTY: DirNotEmpty,
}


def _mode_to_flags(mode: str) -> int:
    """Legacy string modes -> open(2) flags."""
    flags = 0
    if "w" in mode:
        flags = O_WRONLY | O_CREAT | O_TRUNC
    elif "a" in mode:
        flags = O_WRONLY | O_CREAT | O_APPEND
    elif mode.startswith("r"):
        flags = O_RDONLY
    else:
        raise FsError(f"bad mode {mode!r}")
    if "+" in mode or "w" in mode or "a" in mode:
        flags = (flags & ~0o3) | O_RDWR
    return flags


class CfsMount:
    """Legacy path/string-mode facade — a thin compat wrapper over
    :class:`~repro_torch.core.vfs.CfsVfs`.

    All semantics live in the VFS layer now; this class only translates
    string modes to flags and ``CfsOSError`` back to the historical
    exception classes.  New code should use ``mount.vfs`` directly."""

    def __init__(self, client: CfsClient):
        self.client = client
        self.vfs = CfsVfs(client)

    @contextmanager
    def _errs(self):
        try:
            yield
        except CfsOSError as e:
            legacy = _LEGACY_EXC.get(e.errno, FsError)
            raise legacy(e.path or str(e)) from None

    # ---- path resolution -------------------------------------------------------
    def _resolve(self, path: str, parent_only: bool = False):
        """(parent_ino, leaf, dentry|None) — kept for layers (storage/) that
        reached into the resolver; resolution itself lives in the VFS."""
        with self._errs():
            return self.vfs._resolve(path, parent_only=parent_only)

    def path_inode(self, path: str) -> int:
        with self._errs():
            return self.vfs.path_inode(path)

    # ---- file ops ------------------------------------------------------------------
    def create(self, path: str) -> CfsFile:
        with self._errs():
            return self.vfs.open_file(path, O_RDWR | O_CREAT | O_EXCL)

    def open(self, path: str, mode: str = "r") -> CfsFile:
        with self._errs():
            return self.vfs.open_file(path, _mode_to_flags(mode))

    def write_file(self, path: str, data: bytes) -> None:
        f = self.open(path, "w")
        f.write(data)
        f.close()

    def read_file(self, path: str) -> bytes:
        f = self.open(path, "r")
        return f.read()

    def unlink(self, path: str) -> None:
        with self._errs():
            self.vfs.unlink(path)

    def link(self, src: str, dst: str) -> None:
        with self._errs():
            self.vfs.link(src, dst)

    def symlink(self, target: str, linkpath: str) -> None:
        with self._errs():
            self.vfs.symlink(target, linkpath)

    def readlink(self, path: str) -> str:
        with self._errs():
            return self.vfs.readlink(path)

    def rename(self, src: str, dst: str) -> None:
        with self._errs():
            self.vfs.rename(src, dst)

    # ---- directory ops -----------------------------------------------------------------
    def mkdir(self, path: str) -> int:
        with self._errs():
            return self.vfs.mkdir(path)

    def rmdir(self, path: str) -> None:
        with self._errs():
            self.vfs.rmdir(path)

    def readdir(self, path: str) -> List[str]:
        with self._errs():
            return self.vfs.readdir(path)

    def dir_stat(self, path: str) -> List[Dict]:
        """readdir + attrs — the mdtest DirStat operation (batchInodeGet)."""
        with self._errs():
            return self.vfs.readdir_plus(path)

    def stat(self, path: str) -> Dict:
        with self._errs():
            return self.vfs.stat(path)

    def exists(self, path: str) -> bool:
        return self.vfs.exists(path)

    # ---- maintenance ---------------------------------------------------------------------
    def evict_orphans(self) -> int:
        return self.client.evict_orphans()
