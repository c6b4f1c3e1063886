"""Extent store — the general-purpose storage engine (paper §2.2, Figure 2).

Design points reproduced faithfully:

* An extent is the storage unit.  Large files are a *sequence of extents*,
  each extent used by exactly one file; writing a new file starts at the
  zero-offset of a fresh extent, the last extent is never padded and never
  shared (§2.2.2).
* Small files (≤ t = 128 KB) are *aggregated* into shared extents; the
  physical offset of each file's content inside the extent is recorded in
  the meta node (§2.2.3).
* Deleting a small file punches a hole (``fallocate(PUNCH_HOLE)``): disk
  space is freed *asynchronously*, with **no garbage collection and no
  logical→physical remapping table** — the explicit difference from
  Haystack that the paper calls out.  Deleting a large file removes its
  extents directly.
* The CRC of each extent is cached in memory to speed up integrity checks
  (§2.2.1).  Appends update the CRC incrementally; overwrites recompute it.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..analysis import sanitizer as _san
from .simnet import Disk, OpTimer
from .types import SMALL_FILE_THRESHOLD

__all__ = ["Extent", "ExtentStore", "ExtentError", "CrcMismatch"]


class ExtentError(Exception):
    pass


class CrcMismatch(ExtentError):
    pass


@dataclass
class Extent:
    extent_id: int
    data: bytearray = field(default_factory=bytearray)
    size: int = 0                       # high-water mark
    is_tiny: bool = False               # aggregates many small files
    crc: int = 0                        # cached CRC32 of live bytes
    holes: List[Tuple[int, int]] = field(default_factory=list)  # (offset, len)

    def live_bytes(self) -> int:
        return self.size - sum(l for _, l in self.holes)


class ExtentStore:
    """One store per data-partition replica, backed by the node's disk."""

    # Large-file extents are capped (prod: GBs); small for tests via ctor.
    def __init__(self, disk: Disk, extent_max_size: int = 64 * 1024 * 1024,
                 small_threshold: int = SMALL_FILE_THRESHOLD):
        from .types import PACKET_SIZE
        if extent_max_size < PACKET_SIZE:
            raise ValueError("extent_max_size must be >= one packet (128 KB)")
        self.disk = disk
        self.extent_max_size = extent_max_size
        self.small_threshold = small_threshold
        self.extents: Dict[int, Extent] = {}
        self._next_id = 1
        self._tiny_extent_id: Optional[int] = None
        self._punch_queue: List[Tuple[int, int, int]] = []  # (eid, off, len)
        self.crc_checks = 0
        self.crc_hits = 0

    # ---- extent lifecycle --------------------------------------------------
    def create_extent(self, is_tiny: bool = False, extent_id: Optional[int] = None) -> int:
        eid = extent_id if extent_id is not None else self._next_id
        self._next_id = max(self._next_id, eid + 1)
        if eid in self.extents:
            raise ExtentError(f"extent {eid} exists")
        self.extents[eid] = Extent(extent_id=eid, is_tiny=is_tiny)
        return eid

    def delete_extent(self, extent_id: int, op: Optional[OpTimer] = None) -> None:
        """Large-file delete path: drop the whole extent from disk (§2.2.3)."""
        ext = self.extents.pop(extent_id, None)
        if ext is None:
            return
        if _san.SAN is not None:
            _san.SAN.drop_extent(self, extent_id)
        self.disk.release(ext.live_bytes())
        if op is not None:
            self.disk.write_cost(0, op)  # metadata update

    def get(self, extent_id: int) -> Extent:
        ext = self.extents.get(extent_id)
        if ext is None:
            raise ExtentError(f"no extent {extent_id}")
        return ext

    def has(self, extent_id: int) -> bool:
        return extent_id in self.extents

    # ---- append (sequential write) ------------------------------------------
    def append(self, extent_id: int, offset: int, data: bytes,
               op: Optional[OpTimer] = None) -> int:
        """Write ``data`` at ``offset`` which must be the current size
        (append-only discipline for the PB path); returns new size."""
        ext = self.get(extent_id)
        if _san.SAN is not None and op is not None:
            # before offset validation: a racy fork branch is reported as
            # the race it is, not as the ExtentError symptom it causes
            _san.SAN.note_append(self, extent_id,
                                 offset, offset + len(data), op)
        if offset != ext.size:
            raise ExtentError(
                f"non-append write at {offset}, size={ext.size} (extent {extent_id})")
        if ext.size + len(data) > self.extent_max_size and not ext.is_tiny:
            raise ExtentError("extent full")
        self.disk.alloc(len(data))
        ext.data.extend(data)
        ext.size += len(data)
        ext.crc = zlib.crc32(data, ext.crc)  # incremental CRC cache
        self.disk.write_cost(len(data), op)
        return ext.size

    def truncate(self, extent_id: int, size: int) -> None:
        """Recovery alignment (§2.2.5): discard the uncommitted tail."""
        ext = self.get(extent_id)
        if size >= ext.size:
            return
        freed = ext.size - size
        del ext.data[size:]
        ext.size = size
        ext.holes = [(o, l) for (o, l) in ext.holes if o + l <= size]
        self.disk.release(freed)
        ext.crc = zlib.crc32(bytes(ext.data))
        if _san.SAN is not None:
            # the discarded tail's write records go with it, so recovery's
            # re-replication of those bytes is not a phantom conflict
            _san.SAN.note_truncate(self, extent_id, size)

    # ---- overwrite (random write, raft path) ---------------------------------
    def overwrite(self, extent_id: int, offset: int, data: bytes,
                  op: Optional[OpTimer] = None) -> None:
        """In-place write strictly inside the existing size (§2.7.2)."""
        ext = self.get(extent_id)
        if offset + len(data) > ext.size:
            raise ExtentError("overwrite beyond extent size")
        ext.data[offset : offset + len(data)] = data
        ext.crc = zlib.crc32(bytes(ext.data))  # full recompute on overwrite
        self.disk.write_cost(len(data), op)

    # ---- small files ----------------------------------------------------------
    def write_small(self, data: bytes, op: Optional[OpTimer] = None) -> Tuple[int, int]:
        """Aggregate a small file into the current tiny-file extent; returns
        (extent_id, physical_offset) for the meta node to record."""
        if len(data) > self.small_threshold:
            raise ExtentError("not a small file")
        if (self._tiny_extent_id is None
                or self.get(self._tiny_extent_id).size + len(data) > self.extent_max_size):
            self._tiny_extent_id = self.create_extent(is_tiny=True)
        eid = self._tiny_extent_id
        ext = self.get(eid)
        offset = ext.size
        if _san.SAN is not None and op is not None:
            _san.SAN.note_append(self, eid,
                                 offset, offset + len(data), op)
        self.disk.alloc(len(data))
        ext.data.extend(data)
        ext.size += len(data)
        ext.crc = zlib.crc32(data, ext.crc)
        self.disk.write_cost(len(data), op)
        return eid, offset

    def punch_hole(self, extent_id: int, offset: int, length: int) -> None:
        """Small-file delete: queue an async hole punch (fallocate analogue)."""
        self._punch_queue.append((extent_id, offset, length))

    def process_punch_holes(self, op: Optional[OpTimer] = None) -> int:
        """Async worker: actually free the space.  Returns bytes freed."""
        freed = 0
        queue, self._punch_queue = self._punch_queue, []
        for eid, offset, length in queue:
            ext = self.extents.get(eid)
            if ext is None:
                continue
            # zero the region (the kernel would deallocate blocks)
            ext.data[offset : offset + length] = b"\x00" * length
            ext.holes.append((offset, length))
            self.disk.release(length)
            ext.crc = zlib.crc32(bytes(ext.data))
            freed += length
            if op is not None:
                self.disk.write_cost(0, op)
        return freed

    @property
    def pending_punches(self) -> int:
        return len(self._punch_queue)

    # ---- read -------------------------------------------------------------------
    def read(self, extent_id: int, offset: int, size: int,
             op: Optional[OpTimer] = None, verify_crc: bool = False) -> bytes:
        ext = self.get(extent_id)
        if offset + size > ext.size:
            raise ExtentError(
                f"read past extent end: {offset}+{size} > {ext.size}")
        if verify_crc:
            self.crc_checks += 1
            # the in-memory CRC cache makes this a memory op, not a disk scan
            if ext.crc == zlib.crc32(bytes(ext.data)):
                self.crc_hits += 1
            else:
                raise CrcMismatch(f"extent {extent_id}")
        self.disk.read_cost(size, op)
        return bytes(ext.data[offset : offset + size])

    # ---- replication/recovery helpers ---------------------------------------------
    def extent_sizes(self) -> Dict[int, int]:
        return {eid: e.size for eid, e in self.extents.items()}

    def snapshot(self) -> Dict:
        return {
            "next_id": self._next_id,
            "tiny": self._tiny_extent_id,
            "extents": {
                eid: (bytes(e.data), e.size, e.is_tiny, e.crc, list(e.holes))
                for eid, e in self.extents.items()
            },
        }

    def restore(self, snap: Dict) -> None:
        if _san.SAN is not None:
            # wholesale replacement (raft snapshot): old write records are
            # for state that no longer exists on this replica
            _san.SAN.drop_store(self)
        self.disk.release(sum(e.live_bytes() for e in self.extents.values()))
        self._next_id = snap["next_id"]
        self._tiny_extent_id = snap["tiny"]
        self.extents = {}
        for eid, (data, size, is_tiny, crc, holes) in snap["extents"].items():
            ext = Extent(eid, bytearray(data), size, is_tiny, crc, list(holes))
            self.extents[eid] = ext
            self.disk.alloc(ext.live_bytes())
