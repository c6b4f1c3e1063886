"""Wire/metadata types mirroring the paper's Go structs (§2.1, §2.2)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = [
    "MAX_UINT64",
    "PACKET_SIZE",
    "SMALL_FILE_THRESHOLD",
    "InodeType",
    "Inode",
    "Dentry",
    "ExtentKey",
    "ROOT_INODE",
]

MAX_UINT64 = (1 << 64) - 1

# Paper §2.2.1: threshold t (128 KB default) separating small from large files,
# "usually aligned with the packet size during the data transfer".
PACKET_SIZE = 128 * 1024
SMALL_FILE_THRESHOLD = 128 * 1024

ROOT_INODE = 1


class InodeType:
    FILE = 0
    DIR = 1
    SYMLINK = 2


class InodeFlag:
    NORMAL = 0
    MARK_DELETED = 1  # §2.7.3: delete marks the inode; async cleanup follows


@dataclass
class ExtentKey:
    """Locator of one piece of file content (stored in the inode).

    For large files: (partition, extent, file_offset, size) with extent-internal
    offset always 0 for the start of the piece (a new file always writes at the
    zero-offset of a new extent, §2.2.2) — but appends continue within the same
    extent, so ``extent_offset`` tracks where this piece lives in the extent.
    For small files the content sits at ``extent_offset`` inside a shared extent
    ("the physical offset of each file content in the extent is recorded in the
    corresponding meta node", §2.2.3).
    """

    partition_id: int
    extent_id: int
    file_offset: int      # offset of this piece within the file
    extent_offset: int    # physical offset within the extent
    size: int

    def as_tuple(self) -> Tuple[int, int, int, int, int]:
        return (self.partition_id, self.extent_id, self.file_offset,
                self.extent_offset, self.size)


@dataclass
class Inode:
    """Paper §2.1.1 ``type inode`` struct."""

    inode: int                      # inode id
    type: int = InodeType.FILE
    link_target: bytes = b""        # symlink target name
    nlink: int = 1
    flag: int = InodeFlag.NORMAL
    size: int = 0
    extents: List[ExtentKey] = field(default_factory=list)
    ctime: float = 0.0
    mtime: float = 0.0
    gen: int = 0                    # bumped on every metadata mutation
    # partition mvcc version of the LAST mutation that touched this inode —
    # the token a client's `stat_version` revalidation compares against
    # (unlike ``gen``, it is comparable across entries of one partition)
    mv: int = 0

    def clone(self) -> "Inode":
        return Inode(
            inode=self.inode, type=self.type, link_target=self.link_target,
            nlink=self.nlink, flag=self.flag, size=self.size,
            extents=[ExtentKey(*e.as_tuple()) for e in self.extents],
            ctime=self.ctime, mtime=self.mtime, gen=self.gen, mv=self.mv,
        )


@dataclass
class Dentry:
    """Paper §2.1.1 ``type dentry`` struct; dentryTree key = (parent_id, name)."""

    parent_id: int
    name: str
    inode: int
    type: int = InodeType.FILE
    mv: int = 0                     # partition mvcc version of the creation

    def key(self) -> Tuple[int, str]:
        return (self.parent_id, self.name)
