"""POSIX-style VFS layer over a CfsClient (paper §2.7).

The paper's headline API claim is "POSIX-compliant APIs with relaxed
semantics and metadata atomicity".  This module is that surface: real open
flags (``O_CREAT | O_EXCL | O_TRUNC | O_APPEND`` over an ``O_ACCMODE``
access mode), a per-mount file-descriptor table handing out integer fds,
offset-addressed ``pread``/``pwrite``, arbitrary-size ``ftruncate``, and a
single ``CfsOSError(errno, path)`` error channel in place of the ad-hoc
exception zoo — exactly what a FUSE lowering or an mdtest/fio harness
expects to talk to.

Metadata consistency is the **session contract** (lease/version, see
``repro_torch.core.meta_session``): path resolution, ``stat``, ``open`` and
``readdir`` are served from versioned cache entries while their TTL leases
hold — ``open`` no longer force-syncs — with negative dentries answering
repeated ENOENT probes and mvcc ``stat_version`` revalidation for expired
entries.  Staleness against OTHER clients' mutations is bounded by one
TTL; this client's own mutations invalidate locally and immediately.
``CFS_META_TTL=0`` restores the paper's seed semantics (sync-on-open, no
leases).  No cross-client atomicity for overlapping writes, as before.

The metadata round-trip shape is batched (λFS/AsyncFS-style): namespace
mutations go through ``CfsClient.meta_batch``-style coalesced RPCs, so an
``open(O_CREAT)`` that allocates inode + dentry on one partition is a
single raft round-trip instead of two, and ``unlink`` collapses dentry
delete + nlink decrement + eviction the same way.
"""

from __future__ import annotations

import errno
import os
import posixpath
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .client import (CfsClient, CfsFile, DirNotEmpty, Exists, FsError,
                     IsADirectory, NotADirectory, NotFound)
from .meta_node import (DentryExists, MetaError, NoSuchDentry, NoSuchInode,
                        PartitionFull, RangeExhausted)
from .simnet import NetError
from .types import ROOT_INODE, InodeType

__all__ = [
    "CfsVfs", "CfsOSError",
    "O_RDONLY", "O_WRONLY", "O_RDWR", "O_ACCMODE",
    "O_CREAT", "O_EXCL", "O_TRUNC", "O_APPEND",
]

# Linux-valued open(2) flags (kept self-contained so a simulated client
# never depends on the host libc's encoding).
O_RDONLY = 0o0
O_WRONLY = 0o1
O_RDWR = 0o2
O_ACCMODE = 0o3
O_CREAT = 0o100
O_EXCL = 0o200
O_TRUNC = 0o1000
O_APPEND = 0o2000


class CfsOSError(OSError):
    """The VFS error channel: one exception type, errno semantics.

    Subclasses OSError so callers can use ``e.errno``/``errno.ENOENT``
    comparisons exactly as they would against a kernel filesystem."""

    def __init__(self, err: int, path: str = ""):
        super().__init__(err, os.strerror(err), path or None)
        self.path = path

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CfsOSError(errno.{errno.errorcode.get(self.errno)}, {self.path!r})"


# legacy CfsClient / meta-node exception -> errno (subclasses before bases)
_ERRNO_OF = (
    (NotFound, errno.ENOENT),
    (Exists, errno.EEXIST),
    (NotADirectory, errno.ENOTDIR),
    (IsADirectory, errno.EISDIR),
    (DirNotEmpty, errno.ENOTEMPTY),
    (DentryExists, errno.EEXIST),
    (NoSuchDentry, errno.ENOENT),
    (NoSuchInode, errno.ENOENT),
    (PartitionFull, errno.ENOSPC),
    (RangeExhausted, errno.ENOSPC),
    (MetaError, errno.EIO),
)


def _oserror(exc: Exception, path: str) -> CfsOSError:
    for cls, code in _ERRNO_OF:
        if isinstance(exc, cls):
            return CfsOSError(code, path)
    return CfsOSError(errno.EIO, path)


@dataclass
class _OpenFile:
    """One fd-table slot.  ``file`` is None for a DIRECTORY fd (an
    O_RDONLY open of a directory — the handle POSIX dir-fsync needs);
    ``dir_ino`` then carries the directory's inode."""
    fd: int
    path: str
    flags: int
    file: Optional[CfsFile]
    dir_ino: Optional[int] = None

    @property
    def readable(self) -> bool:
        return (self.flags & O_ACCMODE) != O_WRONLY

    @property
    def writable(self) -> bool:
        return (self.flags & O_ACCMODE) != O_RDONLY


class CfsVfs:
    """Per-mount POSIX-style VFS: fd table + flag-driven opens + errno errors.

    One instance per mounted volume (per CfsClient), like one kernel mount.
    All methods raise :class:`CfsOSError`; fds are small integers starting
    at 3 (0-2 reserved out of habit)."""

    def __init__(self, client: CfsClient):
        self.client = client
        self._fds: Dict[int, _OpenFile] = {}
        self._next_fd = 3

    # ------------------------------------------------------- path resolution
    def _resolve(self, path: str, parent_only: bool = False,
                 for_update: bool = False
                 ) -> Tuple[int, str, Optional[Dict]]:
        """Walk ``path`` from the root; returns (parent_ino, leaf, dentry).

        All components resolve through the metadata session: interior
        directories and the leaf are served from leased dentry entries
        (negative entries answer cached ENOENT), so a hot path walk costs
        zero RPCs while the leases hold.  The leaf is still *authoritative*
        under the seed contract (``CFS_META_TTL=0`` / untimed): there a
        stale cache entry must not resurrect a file another client
        unlinked, so it always pays the lookup RPC.

        ``for_update`` marks a resolution whose result PARAMETERIZES a
        mutation (unlink/rmdir/rename/link): the leaf bypasses the lease
        and resolves server-fresh even under an active session — a
        TTL-stale dentry there would feed the wrong inode into batched
        unlink_dec/evict ops and destroy live data, not just serve an old
        read.  Interior components keep the cached walk in BOTH contracts
        (the seed cached them unconditionally and forever; leases tighten
        that exposure to one TTL) — a concurrently renamed ancestor
        directory can therefore still route a mutation through its old
        parent inode for up to one TTL, as it always could."""
        norm = posixpath.normpath(path)
        if not norm.startswith("/"):
            raise CfsOSError(errno.EINVAL, path)
        if norm == "//":
            norm = "/"      # POSIX: "//" is (implementation-defined) root
        if norm == "/":
            return (0, "/", {"parent": 0, "name": "/", "inode": ROOT_INODE,
                             "type": InodeType.DIR})
        session = self.client.session
        parts = [p for p in norm.split("/") if p]
        parent = ROOT_INODE
        for comp in parts[:-1]:
            try:
                d = session.lookup(parent, comp)
            except NotFound:
                raise CfsOSError(errno.ENOENT, path)
            if d["type"] != InodeType.DIR:
                raise CfsOSError(errno.ENOTDIR, path)
            parent = d["inode"]
        leaf = parts[-1]
        if parent_only:
            return (parent, leaf, None)
        try:
            dentry = session.lookup(parent, leaf, authoritative=True,
                                    sync=for_update)
        except NotFound:
            dentry = None
        return (parent, leaf, dentry)

    def path_inode(self, path: str) -> int:
        _, _, dentry = self._resolve(path)
        if dentry is None:
            raise CfsOSError(errno.ENOENT, path)
        return dentry["inode"]

    # ------------------------------------------------------------- fd table
    def _alloc_fd(self, path: str, flags: int, f: CfsFile) -> int:
        fd = self._next_fd
        self._next_fd += 1
        self._fds[fd] = _OpenFile(fd, path, flags, f)
        return fd

    def _alloc_dir_fd(self, path: str, flags: int, ino: int) -> int:
        fd = self._next_fd
        self._next_fd += 1
        self._fds[fd] = _OpenFile(fd, path, flags, None, dir_ino=ino)
        return fd

    def _of(self, fd: int) -> _OpenFile:
        of = self._fds.get(fd)
        if of is None:
            raise CfsOSError(errno.EBADF, f"fd {fd}")
        return of

    def _file(self, of: _OpenFile) -> CfsFile:
        if of.file is None:
            raise CfsOSError(errno.EISDIR, of.path)
        return of.file

    # ------------------------------------------------------------ open/close
    def open(self, path: str, flags: int = O_RDONLY, mode: int = 0o644) -> int:
        """open(2): returns an integer fd.  ``mode`` is accepted for POSIX
        shape (permission bits are not modeled).

        An O_RDONLY open of a directory returns a DIRECTORY fd — the
        handle ``fsync`` needs to act as the dir-fsync durability barrier
        over async metadata commits.  Write-mode directory opens keep the
        seed's EISDIR, and byte I/O on a directory fd raises EISDIR."""
        if (flags & O_ACCMODE) == O_RDONLY and not flags & (O_CREAT | O_TRUNC):
            norm = posixpath.normpath(path)
            if norm in ("/", "//"):
                return self._alloc_dir_fd(path, flags, ROOT_INODE)
            _, _, dentry = self._resolve(path)
            if dentry is None:
                raise CfsOSError(errno.ENOENT, path)
            if dentry["type"] == InodeType.DIR:
                return self._alloc_dir_fd(path, flags, dentry["inode"])
            try:
                f = self.client.open(dentry["inode"], "r")
            except (FsError, MetaError) as e:
                raise _oserror(e, path)
            return self._alloc_fd(path, flags, f)
        f = self.open_file(path, flags)
        if flags & O_APPEND:
            # POSIX: O_APPEND pins WRITES to EOF (write/pwrite re-seek there)
            # but the initial offset for reads is 0
            f.seek(0)
        return self._alloc_fd(path, flags, f)

    def open_file(self, path: str, flags: int = O_RDONLY) -> CfsFile:
        """The open workflow without fd bookkeeping — the compat mount uses
        this to hand out raw CfsFile handles."""
        if posixpath.normpath(path) == "/":
            raise CfsOSError(errno.EISDIR, path)
        # with O_CREAT (and batching on) the up-front existence lookup is
        # skipped — create-first resolves only the parent chain and lets the
        # create RPC detect EEXIST atomically; in scatter mode a failed
        # create costs three RPCs and an orphan, so resolve the leaf instead
        create_first = bool(flags & O_CREAT) and self.client.coalesce_meta
        parent, leaf, dentry = self._resolve(path, parent_only=create_first)
        accmode = flags & O_ACCMODE
        fmode = "r" if accmode == O_RDONLY else (
            "a" if flags & O_APPEND else "r+")
        if flags & O_CREAT and dentry is None:
            # create-first: ONE coalesced round-trip when the file is new
            # (the common case for O_CREAT); fall back to open-existing on
            # EEXIST instead of paying an up-front existence lookup
            try:
                inode = self.client.create(parent, leaf, InodeType.FILE)
                return CfsFile(self.client, inode, fmode)
            except Exists:
                if flags & O_EXCL:
                    raise CfsOSError(errno.EEXIST, path)
                try:
                    # the server just proved the name exists (EEXIST), which
                    # outranks any cached negative entry — sync lookup
                    dentry = self.client.session.lookup(
                        parent, leaf, authoritative=True, sync=True)
                except NotFound:
                    raise CfsOSError(errno.ENOENT, path)
            except (FsError, MetaError) as e:
                raise _oserror(e, path)
        elif flags & O_CREAT and flags & O_EXCL:
            # scatter mode resolved the leaf up front: it exists
            raise CfsOSError(errno.EEXIST, path)
        if dentry is None:
            raise CfsOSError(errno.ENOENT, path)
        if dentry["type"] == InodeType.DIR:
            raise CfsOSError(errno.EISDIR, path)
        try:
            f = self.client.open(dentry["inode"], fmode)
        except (FsError, MetaError) as e:
            raise _oserror(e, path)
        if flags & O_TRUNC and accmode != O_RDONLY:
            f.truncate(0)
        return f

    def close(self, fd: int) -> None:
        of = self._of(fd)
        if of.file is None:
            del self._fds[fd]                   # directory fd: free the slot
            return
        try:
            of.file.close()                     # flush + meta sync
        except (FsError, MetaError) as e:
            raise _oserror(e, of.path)
        finally:
            del self._fds[fd]

    # --------------------------------------------------------------- fd I/O
    def pread(self, fd: int, size: int, offset: int) -> bytes:
        """pread(2).  Read-your-writes holds under a nonzero pipeline
        window for EVERY open mode, O_APPEND included: the handle's read
        path flushes buffered bytes and drains the in-flight append window
        (the committed-offset barrier) before fetching, and the fd offset
        is saved/restored around the positioned read (pinned by
        ``test_vfs_o_append_pread_drains_pipeline_window``)."""
        of = self._of(fd)
        if not of.readable:
            raise CfsOSError(errno.EBADF, of.path)
        if offset < 0:
            raise CfsOSError(errno.EINVAL, of.path)
        f = self._file(of)
        saved = f.pos
        f.seek(offset)
        try:
            return f.read(size)
        except (FsError, MetaError) as e:
            raise _oserror(e, of.path)
        finally:
            f.seek(saved)                       # pread does not move the offset

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        of = self._of(fd)
        if not of.writable:
            raise CfsOSError(errno.EBADF, of.path)
        if offset < 0:
            raise CfsOSError(errno.EINVAL, of.path)
        f = self._file(of)
        saved = f.pos
        if of.flags & O_APPEND:
            f.seek(f.size)                      # O_APPEND: offset is ignored
        else:
            f.seek(offset)
        try:
            return f.write(data)
        except (FsError, MetaError) as e:
            raise _oserror(e, of.path)
        finally:
            f.seek(saved)

    def read(self, fd: int, size: int = -1) -> bytes:
        """Sequential read advancing the fd offset.  Forward scans are
        detected by the handle and readahead-pipelined (a window of
        prefetched chunks, invalidated on seek/write/truncate, drained at
        the fsync/close barriers); the same drain-before-read barrier as
        ``pread`` guarantees read-your-writes behind the append window."""
        of = self._of(fd)
        if not of.readable:
            raise CfsOSError(errno.EBADF, of.path)
        try:
            return self._file(of).read(size)
        except (FsError, MetaError) as e:
            raise _oserror(e, of.path)

    def write(self, fd: int, data: bytes) -> int:
        """Sequential write at the fd offset (EOF under O_APPEND)."""
        of = self._of(fd)
        if not of.writable:
            raise CfsOSError(errno.EBADF, of.path)
        f = self._file(of)
        if of.flags & O_APPEND:
            f.seek(f.size)
        try:
            return f.write(data)
        except (FsError, MetaError) as e:
            raise _oserror(e, of.path)

    def lseek(self, fd: int, offset: int) -> int:
        of = self._of(fd)
        if offset < 0:
            raise CfsOSError(errno.EINVAL, of.path)
        self._file(of).seek(offset)
        return offset

    def ftruncate(self, fd: int, size: int) -> None:
        of = self._of(fd)
        if not of.writable:
            raise CfsOSError(errno.EBADF, of.path)
        if size < 0:
            raise CfsOSError(errno.EINVAL, of.path)
        try:
            self._file(of).truncate(size)
        except (FsError, MetaError) as e:
            raise _oserror(e, of.path)

    def fstat(self, fd: int) -> Dict:
        """Attributes from the handle: cached inode view with the LIVE size
        and extent map (unflushed appends included), like a kernel's
        in-core inode.  A directory fd serves the session getattr."""
        of = self._of(fd)
        if of.file is None:
            try:
                return dict(self.client.session.getattr(of.dir_ino))
            except (FsError, MetaError) as e:
                raise _oserror(e, of.path)
        f = of.file
        view = dict(f.inode)
        view["size"] = f.size
        view["extents"] = [k.as_tuple() for k in f._extents]
        return view

    def flush(self, fd: int) -> None:
        """Push buffered bytes into the pipeline WITHOUT the barrier: packets
        may still be in flight down the replica chain afterwards.  Durability
        plus the drain of the in-flight window is ``fsync``'s job (the
        committed-offset rule: the ack of the highest in-flight offset
        commits the whole prefix, so fsync waits for exactly that)."""
        of = self._of(fd)
        try:
            self._file(of).flush()
        except (FsError, MetaError) as e:
            raise _oserror(e, of.path)

    def fsync(self, fd: int) -> None:
        """fsync(2): flush + drain the pipelined append window + sync the
        meta node; returns only when every byte written through this fd is
        committed on ALL replicas of its extents.

        On a DIRECTORY fd this is the async metadata durability barrier:
        drain the unacked commit window of the partition owning the
        directory's inode (a child's dentry — and, coalesced, its inode —
        lives on that same partition), so every namespace mutation acked
        under this directory is raft-committed before fsync returns."""
        of = self._of(fd)
        if of.file is None:
            try:
                pid = self.client._mp_for_inode(of.dir_ino).pid
            except (FsError, MetaError) as e:
                raise _oserror(e, of.path)
            self.client.drain_meta_window(pid)
            return
        try:
            of.file.fsync()
        except (FsError, MetaError) as e:
            raise _oserror(e, of.path)

    # ------------------------------------------------------------- path ops
    def mkdir(self, path: str, mode: int = 0o755) -> int:
        parent, leaf, _ = self._resolve(path, parent_only=True)
        try:
            inode = self.client.create(parent, leaf, InodeType.DIR)
        except (FsError, MetaError) as e:
            raise _oserror(e, path)
        return inode["inode"]

    def rmdir(self, path: str) -> None:
        parent, leaf, dentry = self._resolve(path, for_update=True)
        if dentry is None:
            raise CfsOSError(errno.ENOENT, path)
        if dentry["type"] != InodeType.DIR:
            raise CfsOSError(errno.ENOTDIR, path)
        # the emptiness gate must be server-fresh: a stale-empty leased
        # listing would delete a directory another client just populated
        if self.client.session.readdir(dentry["inode"], sync=True):
            raise CfsOSError(errno.ENOTEMPTY, path)
        try:
            # dentry delete + dir nlink dec + evict + parent ".." dec — one
            # round-trip when the dir inode colocates with its dentry
            self.client.remove(parent, leaf, dentry["inode"],
                               dec_parent_link=True)
        except (FsError, MetaError) as e:
            raise _oserror(e, path)

    def unlink(self, path: str) -> None:
        parent, leaf, dentry = self._resolve(path, for_update=True)
        if dentry is None:
            raise CfsOSError(errno.ENOENT, path)
        if dentry["type"] == InodeType.DIR:
            raise CfsOSError(errno.EISDIR, path)
        try:
            self.client.remove(parent, leaf, dentry["inode"])
        except (FsError, MetaError) as e:
            raise _oserror(e, path)

    def rename(self, src: str, dst: str) -> None:
        """Move the dentry (dst created before src is deleted) — atomic when
        both parents share a partition, otherwise the paper's relaxed
        metadata atomicity.  Existing dst is an error (no implicit replace
        under relaxed semantics)."""
        src_parent, src_leaf, src_dentry = self._resolve(src, for_update=True)
        if src_dentry is None:
            raise CfsOSError(errno.ENOENT, src)
        if src_dentry["inode"] == ROOT_INODE:
            raise CfsOSError(errno.EINVAL, src)     # can't move the root
        dst_parent, dst_leaf, dst_dentry = self._resolve(dst, for_update=True)
        if dst_dentry is not None:
            if dst_dentry["inode"] == src_dentry["inode"]:
                return      # rename(2): same inode -> no-op success
            raise CfsOSError(errno.EEXIST, dst)
        if src_dentry["type"] == InodeType.DIR and \
                src_dentry["inode"] in self._dir_chain(dst):
            # moving a directory into its own subtree would detach it into
            # an unreachable cycle; POSIX says EINVAL
            raise CfsOSError(errno.EINVAL, dst)
        try:
            self.client.rename_entry(src_parent, src_leaf, dst_parent,
                                     dst_leaf, src_dentry["inode"],
                                     src_dentry["type"])
        except (FsError, MetaError) as e:
            raise _oserror(e, src)

    def link(self, src: str, dst: str) -> None:
        # both sides are mutation inputs: the new dentry will reference
        # src's inode (a stale one would dangle), and dst gates EEXIST
        _, _, src_dentry = self._resolve(src, for_update=True)
        if src_dentry is None:
            raise CfsOSError(errno.ENOENT, src)
        src_ino = src_dentry["inode"]
        parent, leaf, dentry = self._resolve(dst, for_update=True)
        if dentry is not None:
            raise CfsOSError(errno.EEXIST, dst)
        try:
            self.client.link(src_ino, parent, leaf)
        except (FsError, MetaError) as e:
            raise _oserror(e, dst)

    def symlink(self, target: str, linkpath: str) -> None:
        parent, leaf, dentry = self._resolve(linkpath, for_update=True)
        if dentry is not None:
            raise CfsOSError(errno.EEXIST, linkpath)
        try:
            self.client.create(parent, leaf, InodeType.SYMLINK,
                               link_target=target.encode())
        except (FsError, MetaError) as e:
            raise _oserror(e, linkpath)

    def readlink(self, path: str) -> str:
        inode = self._stat_inode(path)
        if inode["type"] != InodeType.SYMLINK:
            raise CfsOSError(errno.EINVAL, path)
        return inode["link_target"].decode()

    def _stat_inode(self, path: str) -> Dict:
        try:
            # session surface: a valid lease answers the getattr; the seed
            # contract (TTL=0) refetches — the old force-sync stat
            return self.client.session.getattr(self.path_inode(path))
        except NotFound:
            raise CfsOSError(errno.ENOENT, path)

    def stat(self, path: str) -> Dict:
        return self._stat_inode(path)

    def exists(self, path: str) -> bool:
        try:
            self.path_inode(path)
            return True
        except CfsOSError:
            return False

    def readdir(self, path: str) -> List[str]:
        """opendir/readdir: the listing is served from the session's leased
        per-directory cache while the lease holds (invalidated by local
        creates/deletes under the directory)."""
        ino, _ = self._dir_inode(path)
        return [d["name"] for d in self.client.session.readdir(ino)]

    def readdir_plus(self, path: str) -> List[Dict]:
        """readdir + attrs in one pass — the paper's batchInodeGet DirStat
        path (§4.2): ONE batched inode fetch per meta partition, and only
        for the inodes whose leases do not already answer."""
        ino, _ = self._dir_inode(path)
        return self.client.session.readdir_plus(ino)

    def _dir_chain(self, path: str) -> List[int]:
        """Inodes of every directory on ``path``'s parent chain (root
        included) — the ancestry a rename must not move a dir into."""
        chain = [ROOT_INODE]
        parts = [p for p in posixpath.normpath(path).split("/") if p]
        parent = ROOT_INODE
        for comp in parts[:-1]:
            try:
                d = self.client.lookup(parent, comp)
            except NotFound:
                break
            parent = d["inode"]
            chain.append(parent)
        return chain

    def _dir_inode(self, path: str) -> Tuple[int, int]:
        _, _, dentry = self._resolve(path)
        if dentry is None:
            raise CfsOSError(errno.ENOENT, path)
        if dentry["type"] != InodeType.DIR:
            raise CfsOSError(errno.ENOTDIR, path)
        return dentry["inode"], dentry["type"]

    def statfs(self, path: str = "/") -> Dict[str, int]:
        """statvfs(3) over the volume: one RM round-trip."""
        try:
            leader = self.client.rm.leader_id()
            out = self.client.net.call(
                self.client.client_id, leader, self.client.rm.statfs,
                self.client.volume, kind="client.rm")
        except KeyError:
            raise CfsOSError(errno.ENOENT, self.client.volume)
        except NetError:
            raise CfsOSError(errno.EIO, path)
        self.client.stats["rm_calls"] += 1
        return out

    # ---------------------------------------------------------- maintenance
    def cache_stats(self) -> Dict[str, float]:
        """Hit/occupancy counters of the client's tiered extent cache
        (empty dict when ``CFS_CLIENT_CACHE=0``) — the benchmark/diagnostic
        surface, mirroring ``client.stats`` for the metadata caches."""
        cache = self.client.data_cache
        if cache is None:
            return {}
        out = dict(cache.stats)
        out.update(cache.occupancy())
        return out

    def handle(self, fd: int) -> CfsFile:
        """Low-level escape hatch (tools/demos): the CfsFile behind an fd."""
        return self._file(self._of(fd))

    def open_fds(self) -> List[int]:
        return sorted(self._fds)

    def evict_orphans(self) -> int:
        return self.client.evict_orphans()
