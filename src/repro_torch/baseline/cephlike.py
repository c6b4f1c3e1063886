"""Ceph-like comparison system (the paper's §4 baseline, as it explains it).

This is NOT Ceph; it is the abstract system the paper's analysis attributes
Ceph's behaviour to, built on the same simnet substrate so the comparison
isolates the DESIGN differences the paper claims matter:

  * **Directory-locality metadata placement**: a directory and all metadata
    of its children (inode AND dentry, colocated) live on one MDS
    (hash(dir) → MDS).  Single-server atomic create/unlink — no orphan
    machinery needed, great single-client latency.
  * **Journaled, disk-backed MDS**: each metadata mutation writes a journal
    entry + applies to the backing store; only a bounded LRU cache of
    metadata lives in memory (paper §4.3: "each MDS only caches a portion
    of the file metadata"; cache misses hit disk).
  * **Per-directory serialization**: MDS ops on one directory hold its
    lock — the bottleneck-server busy model turns this into the contention
    the paper observes at 8 clients × 64 procs.
  * **Dynamic subtree re-partitioning with proxies** (paper §4.2): a hot
    directory gets split across MDSs but requests still route through the
    authoritative MDS — one extra hop.
  * **readdir + per-file inodeGet** (no batch op).
  * **One replication protocol for every write** (3-way primary-copy with
    journal write amplification) over **CRUSH-like pseudorandom placement**;
    adding an OSD REBALANCES (measured by the capacity-expansion test).
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..core.simnet import Disk, LatencyModel, NetError, Network

OBJECT_SIZE = 4 * 1024 * 1024
FRAGMENT_THRESHOLD = 10_000     # dirents before a dir fragments across MDSs


def _h(*parts: Any) -> int:
    s = ":".join(str(p) for p in parts).encode()
    return int.from_bytes(hashlib.md5(s).digest()[:8], "little")


class CephError(Exception):
    pass


class NotFound(CephError):
    pass


class Exists(CephError):
    pass


@dataclass
class CInode:
    ino: int
    is_dir: bool
    size: int = 0
    nlink: int = 1
    children: int = 0


class MDS:
    """Metadata server: journaled disk-backed store + bounded LRU cache."""

    JOURNAL_US = 0  # journal write charged via disk cost model

    def __init__(self, node_id: str, net: Network, cache_entries: int = 20000):
        self.node_id = node_id
        self.net = net
        self.disk = Disk(64 * 1024 * 1024 * 1024, net.model,
                         owner=node_id, net=net)
        # authoritative store: (parent_ino, name) -> (ino, CInode)
        self.dentries: Dict[Tuple[int, str], int] = {}
        self.inodes: Dict[int, CInode] = {}
        self.cache: Dict[Any, bool] = {}      # LRU-ish presence cache
        self.cache_entries = cache_entries

    # ---- cache/disk model --------------------------------------------------
    def _touch(self, key: Any, write: bool = False) -> None:
        op = self.net.current_op
        if write:
            # journal entry + apply (the paper's write-amplification path)
            self.disk.write_cost(512, op)
            self.disk.write_cost(256, op)
            self.cache[key] = True
        else:
            if key not in self.cache:
                self.disk.read_cost(512, op)       # cache miss -> disk
                self.cache[key] = True
        if len(self.cache) > self.cache_entries:   # crude LRU eviction
            for k in list(self.cache)[: len(self.cache) // 4]:
                del self.cache[k]

    # ---- ops (inode + dentry COLOCATED; atomic on this server) --------------
    def create(self, parent: int, name: str, ino: int, is_dir: bool) -> CInode:
        key = (parent, name)
        if key in self.dentries:
            raise Exists(f"{parent}/{name}")
        self._touch(("d", key), write=True)
        self._touch(("i", ino), write=True)
        inode = CInode(ino=ino, is_dir=is_dir, nlink=2 if is_dir else 1)
        self.dentries[key] = ino
        self.inodes[ino] = inode
        p = self.inodes.get(parent)
        if p is not None:
            p.children += 1
        return inode

    def lookup(self, parent: int, name: str) -> int:
        key = (parent, name)
        self._touch(("d", key))
        if key not in self.dentries:
            raise NotFound(f"{parent}/{name}")
        return self.dentries[key]

    def inode_get(self, ino: int) -> CInode:
        self._touch(("i", ino))
        inode = self.inodes.get(ino)
        if inode is None:
            raise NotFound(str(ino))
        return inode

    def set_size(self, ino: int, size: int) -> None:
        self._touch(("i", ino), write=True)
        self.inodes[ino].size = size

    def unlink(self, parent: int, name: str) -> int:
        key = (parent, name)
        self._touch(("d", key), write=True)
        if key not in self.dentries:
            raise NotFound(f"{parent}/{name}")
        ino = self.dentries.pop(key)
        self._touch(("i", ino), write=True)
        inode = self.inodes.pop(ino, None)
        p = self.inodes.get(parent)
        if p is not None:
            p.children -= 1
        return ino

    def readdir(self, parent: int) -> List[Tuple[str, int]]:
        self._touch(("dir", parent))
        return [(name, ino) for (p, name), ino in self.dentries.items()
                if p == parent]

    def register_subdir(self, ino: int, inode: CInode) -> None:
        """Receive an inode migrated here by fragmentation."""
        self.inodes[ino] = inode


class OSD:
    """Object storage device: journal + store, one replication protocol."""

    def __init__(self, node_id: str, net: Network,
                 capacity: int = 1024 * 1024 * 1024):
        self.node_id = node_id
        self.net = net
        self.disk = Disk(capacity, net.model, owner=node_id, net=net)
        self.objects: Dict[str, bytes] = {}

    def write_object(self, name: str, data: bytes) -> int:
        op = self.net.current_op
        old = self.objects.get(name)
        if old is not None:
            self.disk.release(len(old))
        self.disk.alloc(len(data))
        # journal first, then apply — every write, append or overwrite
        self.disk.write_cost(len(data), op)
        self.disk.write_cost(len(data), op)
        self.objects[name] = data
        return len(data)

    def read_object(self, name: str, offset: int = 0, size: int = -1) -> bytes:
        data = self.objects.get(name)
        if data is None:
            raise NotFound(name)
        if size < 0:
            size = len(data) - offset
        self.disk.read_cost(size, self.net.current_op)
        return data[offset : offset + size]

    def delete_object(self, name: str) -> None:
        data = self.objects.pop(name, None)
        if data is not None:
            self.disk.release(len(data))
            self.disk.write_cost(0, self.net.current_op)


class CephLikeCluster:
    """MDS fleet + OSD fleet + CRUSH-like placement."""

    def __init__(self, n_mds: int = 4, n_osd: int = 6, replicas: int = 3,
                 latency: Optional[LatencyModel] = None, seed: int = 0,
                 mds_cache_entries: int = 20000):
        self.net = Network(model=latency, seed=seed)
        self.mds: List[MDS] = [MDS(f"mds{i}", self.net, mds_cache_entries)
                               for i in range(n_mds)]
        self.osds: List[OSD] = [OSD(f"osd{i}", self.net)
                                for i in range(n_osd)]
        self.replicas = replicas
        self._next_ino = 2
        self.migrated_bytes = 0
        # root
        self.mds_of_dir(1).inodes[1] = CInode(ino=1, is_dir=True, nlink=2)
        self.fragmented: Dict[int, bool] = {}

    # ---- placement ---------------------------------------------------------
    def mds_of_dir(self, dir_ino: int) -> MDS:
        return self.mds[_h("dir", dir_ino) % len(self.mds)]

    def mds_of_entry(self, dir_ino: int, name: str) -> MDS:
        """Fragmented dirs spread entries by name — but via the proxy."""
        if self.fragmented.get(dir_ino):
            return self.mds[_h("frag", dir_ino, name) % len(self.mds)]
        return self.mds_of_dir(dir_ino)

    def crush(self, ino: int, stripe: int) -> List[OSD]:
        """Pseudorandom placement over the CURRENT osd set (rebalances on
        expansion — the contrast with CFS's utilization placement)."""
        n = len(self.osds)
        first = _h("obj", ino, stripe) % n
        return [self.osds[(first + i) % n] for i in range(self.replicas)]

    def alloc_ino(self) -> int:
        self._next_ino += 1
        return self._next_ino

    # ---- capacity expansion (rebalancing!) ------------------------------------
    def add_osd(self) -> Tuple[str, int]:
        """Adding an OSD remaps ~1/n of every object: data MOVES."""
        old = self.crush_snapshot()
        osd = OSD(f"osd{len(self.osds)}", self.net)
        self.osds.append(osd)
        moved = 0
        for name, (ino, stripe, data_len) in old.items():
            new_primary = self.crush(ino, stripe)[0]
            cur = None
            for o in self.osds[:-1]:
                if name in o.objects:
                    cur = o
                    break
            if cur is None or new_primary.node_id == cur.node_id:
                continue
            data = cur.objects[name]
            # migration: read + network + write on the new home.  Under a
            # timed op (rebalance racing client IO in a benchmark timeline)
            # the reads/writes queue on the OSDs' disk resources like any
            # other IO — backfill contends with the foreground, which is
            # exactly the p99 cliff CFS's split-without-move design avoids.
            op = self.net.current_op
            cur.disk.read_cost(len(data), op)
            lat = self.net.charge("mig", new_primary.node_id, len(data),
                                  "rebalance")
            if op is not None:
                op.add(lat)
            new_primary.write_object(name, data)
            cur.delete_object(name)
            moved += len(data)
        self.migrated_bytes += moved
        return osd.node_id, moved

    def crush_snapshot(self) -> Dict[str, Tuple[int, int, int]]:
        out = {}
        for o in self.osds:
            for name, data in o.objects.items():
                ino, stripe = name.split(":")
                key = (int(ino), int(stripe), len(data))
                if name not in out:
                    out[name] = key
        return out

    def maybe_fragment(self, dir_ino: int) -> None:
        mds = self.mds_of_dir(dir_ino)
        inode = mds.inodes.get(dir_ino)
        if inode is not None and inode.children > FRAGMENT_THRESHOLD:
            self.fragmented[dir_ino] = True


class CephLikeMount:
    """Client: same surface as CfsMount so the benchmarks are symmetric."""

    def __init__(self, cluster: CephLikeCluster, client_id: str):
        self.c = cluster
        self.net = cluster.net
        self.client_id = client_id

    # ---- path helpers -------------------------------------------------------
    def _resolve_dir(self, path: str) -> Tuple[int, str]:
        parts = [p for p in path.split("/") if p]
        parent = 1
        for comp in parts[:-1]:
            parent = self._lookup(parent, comp)
        return parent, (parts[-1] if parts else "")

    def _mds_call(self, mds: MDS, fn, *args, dir_ino: Optional[int] = None):
        """One hop — or two when the directory is fragmented (proxy)."""
        if dir_ino is not None and self.c.fragmented.get(dir_ino):
            proxy = self.c.mds_of_dir(dir_ino)
            return self.net.call(
                self.client_id, proxy.node_id,
                lambda: self.net.call(proxy.node_id, mds.node_id, fn, *args),
                kind="ceph.proxy")
        return self.net.call(self.client_id, mds.node_id, fn, *args,
                             kind="ceph.meta")

    def _lookup(self, parent: int, name: str) -> int:
        mds = self.c.mds_of_entry(parent, name)
        return self._mds_call(mds, mds.lookup, parent, name, dir_ino=parent)

    # ---- metadata ops ---------------------------------------------------------
    def mkdir(self, path: str) -> int:
        parent, leaf = self._resolve_dir(path)
        ino = self.c.alloc_ino()
        mds = self.c.mds_of_entry(parent, leaf)
        self._mds_call(mds, mds.create, parent, leaf, ino, True,
                       dir_ino=parent)
        # the new dir's authority may be a different MDS: register there
        home = self.c.mds_of_dir(ino)
        if home is not mds:
            self.net.call(self.client_id, home.node_id, home.register_subdir,
                          ino, CInode(ino=ino, is_dir=True, nlink=2),
                          kind="ceph.meta")
        self.c.maybe_fragment(parent)
        return ino

    def _create_file(self, path: str) -> int:
        parent, leaf = self._resolve_dir(path)
        ino = self.c.alloc_ino()
        mds = self.c.mds_of_entry(parent, leaf)
        self._mds_call(mds, mds.create, parent, leaf, ino, False,
                       dir_ino=parent)
        self.c.maybe_fragment(parent)
        return ino

    def unlink(self, path: str) -> None:
        parent, leaf = self._resolve_dir(path)
        mds = self.c.mds_of_entry(parent, leaf)
        ino = self._mds_call(mds, mds.unlink, parent, leaf, dir_ino=parent)
        # delete objects
        stripe = 0
        while True:
            osds = self.c.crush(ino, stripe)
            name = f"{ino}:{stripe}"
            if name not in osds[0].objects:
                break
            for o in osds:
                try:
                    self.net.call(self.client_id, o.node_id, o.delete_object,
                                  name, kind="ceph.data")
                except NetError:
                    pass
            stripe += 1

    rmdir = unlink

    def readdir(self, path: str) -> List[str]:
        parent, leaf = self._resolve_dir(path)
        d = self._lookup(parent, leaf) if leaf else 1
        mds = self.c.mds_of_dir(d)
        entries = self._mds_call(mds, mds.readdir, d, dir_ino=d)
        return [name for name, _ in entries]

    def dir_stat(self, path: str) -> List[Dict]:
        """readdir THEN one inodeGet per file (the paper's §4.2 contrast
        with CFS's batchInodeGet)."""
        parent, leaf = self._resolve_dir(path)
        d = self._lookup(parent, leaf) if leaf else 1
        mds = self.c.mds_of_dir(d)
        entries = self._mds_call(mds, mds.readdir, d, dir_ino=d)
        out = []
        for name, ino in entries:
            owner = self.c.mds_of_entry(d, name)
            inode = self._mds_call(owner, owner.inode_get, ino, dir_ino=d)
            out.append({"name": name, "inode": ino, "size": inode.size})
        return out

    def stat(self, path: str) -> Dict:
        parent, leaf = self._resolve_dir(path)
        ino = self._lookup(parent, leaf)
        mds = self.c.mds_of_entry(parent, leaf)
        inode = self._mds_call(mds, mds.inode_get, ino, dir_ino=parent)
        return {"inode": ino, "size": inode.size}

    # ---- file I/O ---------------------------------------------------------------
    def write_file(self, path: str, data: bytes) -> None:
        parent, leaf = self._resolve_dir(path)
        mds = self.c.mds_of_entry(parent, leaf)
        try:
            ino = self._lookup(parent, leaf)
        except NotFound:
            ino = self.c.alloc_ino()
            self._mds_call(mds, mds.create, parent, leaf, ino, False,
                           dir_ino=parent)
        for stripe in range(0, max(len(data), 1), OBJECT_SIZE):
            chunk = data[stripe : stripe + OBJECT_SIZE]
            self._write_object(ino, stripe // OBJECT_SIZE, chunk)
        self._mds_call(mds, mds.set_size, ino, len(data), dir_ino=parent)

    def _write_object(self, ino: int, stripe: int, data: bytes) -> None:
        osds = self.c.crush(ino, stripe)
        name = f"{ino}:{stripe}"
        primary = osds[0]

        def primary_write():
            primary.write_object(name, data)
            # primary-copy: forward to replicas, wait for BOTH (incl. their
            # journals) before ack — the single one-size-fits-all protocol
            self.net.parallel_calls(
                primary.node_id,
                [(o.node_id, o.write_object, (name, data)) for o in osds[1:]],
                nbytes=len(data) + 128, kind="ceph.repl")
            return True

        self.net.call(self.client_id, primary.node_id, primary_write,
                      nbytes=len(data) + 128, kind="ceph.data")

    def overwrite(self, path: str, offset: int, data: bytes) -> None:
        """In Ceph-like: read-modify-write the covered objects, full
        journaling each time (the paper's overwrite-queue observation)."""
        parent, leaf = self._resolve_dir(path)
        ino = self._lookup(parent, leaf)
        end = offset + len(data)
        s0, s1 = offset // OBJECT_SIZE, (end - 1) // OBJECT_SIZE
        for stripe in range(s0, s1 + 1):
            osds = self.c.crush(ino, stripe)
            name = f"{ino}:{stripe}"
            old = self.net.call(self.client_id, osds[0].node_id,
                                osds[0].read_object, name, kind="ceph.data")
            buf = bytearray(old)
            lo = max(offset, stripe * OBJECT_SIZE)
            hi = min(end, stripe * OBJECT_SIZE + len(old))
            buf[lo - stripe * OBJECT_SIZE : hi - stripe * OBJECT_SIZE] = \
                data[lo - offset : hi - offset]
            self._write_object(ino, stripe, bytes(buf))

    def read_file(self, path: str) -> bytes:
        parent, leaf = self._resolve_dir(path)
        ino = self._lookup(parent, leaf)
        mds = self.c.mds_of_entry(parent, leaf)
        inode = self._mds_call(mds, mds.inode_get, ino, dir_ino=parent)
        out = bytearray()
        for stripe in range(0, max(inode.size, 1), OBJECT_SIZE):
            osds = self.c.crush(ino, stripe // OBJECT_SIZE)
            name = f"{ino}:{stripe // OBJECT_SIZE}"
            chunk = self.net.call(self.client_id, osds[0].node_id,
                                  osds[0].read_object, name,
                                  reply_bytes=min(OBJECT_SIZE, inode.size) + 64,
                                  kind="ceph.data")
            out.extend(chunk)
        return bytes(out[: inode.size])

    def read_range(self, path: str, offset: int, size: int) -> bytes:
        parent, leaf = self._resolve_dir(path)
        ino = self._lookup(parent, leaf)
        out = bytearray()
        end = offset + size
        s0, s1 = offset // OBJECT_SIZE, (end - 1) // OBJECT_SIZE
        for stripe in range(s0, s1 + 1):
            osds = self.c.crush(ino, stripe)
            name = f"{ino}:{stripe}"
            lo = max(offset, stripe * OBJECT_SIZE) - stripe * OBJECT_SIZE
            hi = min(end, (stripe + 1) * OBJECT_SIZE) - stripe * OBJECT_SIZE
            chunk = self.net.call(self.client_id, osds[0].node_id,
                                  osds[0].read_object, name, lo, hi - lo,
                                  reply_bytes=hi - lo + 64, kind="ceph.data")
            out.extend(chunk)
        return bytes(out)
