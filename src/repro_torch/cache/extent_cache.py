"""Two-tier client-side extent cache: RAM + simulated SSD, mvcc-guarded.

The paper's container platforms re-read hot files (images, shared
libraries, training shards) from thousands of clients; every such read
used to pay a full NIC round per ≤128 KB extent packet.  This module
caches *committed* extent packets on the client across two tiers:

* **RAM tier** — a byte-budgeted LRU served at memory bandwidth
  (``LatencyModel.ram_cost``: additive, no queue — a memcpy does not
  contend with the NIC).
* **SSD tier** — a byte-budgeted LRU behind the client's local
  ``ssd:<client>`` :class:`~repro_torch.core.simnet.Resource`: every hit and
  every demotion *occupies* the device for ``LatencyModel.ssd_cost``
  (latency + size/bandwidth) on the event timeline, so SSD-tier hits
  queue against each other and against background demotion writes
  exactly like every other modeled stage.

Tiering is 2Q-style: inserts and promotions go to RAM; RAM evictions
demote to SSD (a detached timed write — the device is occupied, the op
frontier is not advanced, mirroring readahead's cost model); SSD
evictions are dropped.  An SSD hit promotes back to RAM.

**Consistency** extends the lease/mvcc contract from metadata to
data.  Every entry is stamped with ``(ino, mv)`` — the inode's
extent-map version under which its bytes were fetched.  ``serve``
requires the caller's current leased ``(ino, mv)`` to match, so an
entry is only ever served under an inode lease the session just
validated (the read path probes ``MetaSession.getattr`` first, which
revalidates an expired lease with the cheap ``stat_version`` read).
Local mutations invalidate eagerly through the existing funnels
(``note_mutation``/truncate/punch-hole); a *peer* client's mutation
bumps the server mv and is picked up at the next lease revalidation —
staleness is bounded by one ``CFS_META_TTL``, exactly as metadata is,
and under ``CFS_SANITIZE=1`` every cache serve asserts that bound.

Keys are ``(volume, partition, extent, extent_offset)``: small files
share aggregated extents whose ids are only unique per data partition,
so the partition id is part of the key.

Determinism: both tiers are insertion-ordered ``OrderedDict`` LRUs, the
inode index is a dict of dicts, and nothing reads the wall clock — the
cache is bit-identical across same-seed reruns.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import sanitizer as _san

__all__ = ["TieredExtentCache"]

# (volume, data partition id, extent id, extent offset)
Key = Tuple[str, int, int, int]


class _Entry:
    """One cached extent packet: bytes + the mvcc stamp they were read
    under."""

    __slots__ = ("data", "ino", "mv")

    def __init__(self, data: bytes, ino: int, mv: int):
        self.data = data
        self.ino = ino
        self.mv = mv


class TieredExtentCache:
    """Per-client two-tier (RAM → SSD) LRU over committed extent packets."""

    def __init__(self, client_id: str, net: Any, volume: str,
                 ram_bytes: int, ssd_bytes: int):
        self.client_id = client_id
        self.net = net
        self.volume = volume
        self.ram_budget = max(0, ram_bytes)
        self.ssd_budget = max(0, ssd_bytes)
        self._ram: "OrderedDict[Key, _Entry]" = OrderedDict()
        self._ssd: "OrderedDict[Key, _Entry]" = OrderedDict()
        self.ram_bytes = 0
        self.ssd_bytes = 0
        # ino -> {key: None}: the invalidation index (dict, not set — the
        # iteration order must be deterministic)
        self._by_ino: Dict[int, Dict[Key, None]] = {}
        self.stats: Dict[str, float] = {
            "ram_hits": 0, "ssd_hits": 0, "misses": 0, "stale_drops": 0,
            "inserts": 0, "demotions": 0, "promotions": 0, "evictions": 0,
            "invalidations": 0,
        }

    # ------------------------------------------------------------ plumbing
    def _ssd_resource(self):
        return self.net.resource(f"ssd:{self.client_id}")

    def _ssd_cost(self, nbytes: int) -> float:
        return self.net.model.ssd_cost(nbytes)

    def _ram_cost(self, nbytes: int) -> float:
        return self.net.model.ram_cost(nbytes)

    def _unindex(self, key: Key, entry: _Entry) -> None:
        keys = self._by_ino.get(entry.ino)
        if keys is not None:
            keys.pop(key, None)
            if not keys:
                del self._by_ino[entry.ino]

    def _pop_key(self, key: Key) -> Optional[_Entry]:
        e = self._ram.pop(key, None)
        if e is not None:
            self.ram_bytes -= len(e.data)
        else:
            e = self._ssd.pop(key, None)
            if e is not None:
                self.ssd_bytes -= len(e.data)
        if e is not None:
            self._unindex(key, e)
        return e

    def _evict_ssd(self) -> None:
        while self.ssd_bytes > self.ssd_budget and self._ssd:
            key, e = self._ssd.popitem(last=False)
            self.ssd_bytes -= len(e.data)
            self._unindex(key, e)
            self.stats["evictions"] += 1

    def _evict_ram(self, at: float) -> None:
        """Shrink RAM to budget; victims demote to SSD when it has a
        budget (a detached timed device write: occupancy is charged at
        ``at``, the caller's frontier is not advanced), else drop."""
        while self.ram_bytes > self.ram_budget and self._ram:
            key, e = self._ram.popitem(last=False)
            self.ram_bytes -= len(e.data)
            if self.ssd_budget >= len(e.data):
                self._ssd_resource().acquire(at, self._ssd_cost(len(e.data)))
                self._ssd[key] = e
                self.ssd_bytes += len(e.data)
                self.stats["demotions"] += 1
                self._evict_ssd()
            else:
                self._unindex(key, e)
                self.stats["evictions"] += 1

    # ------------------------------------------------------------- serving
    def serve(self, key: Key, n: int, ctx: Tuple, at: float
              ) -> Optional[Tuple[bytes, float]]:
        """Serve the first ``n`` bytes of the packet at ``key`` if a fresh
        entry covers them.  ``ctx`` is the read path's validated lease
        context ``(ino, mv, granted_us, bound_us)``; an entry stamped with
        a different inode or mv is dead — dropped, miss.  Returns
        ``(data, completion_us)``: RAM hits complete at ``at + ram_cost``,
        SSD hits queue on the ``ssd:<client>`` resource (and promote to
        RAM).  ``None`` = miss, the caller fetches over the network."""
        ino, mv, granted, bound = ctx
        e = self._ram.get(key)
        in_ram = e is not None
        if e is None:
            e = self._ssd.get(key)
        if e is None:
            self.stats["misses"] += 1
            return None
        if e.ino != ino or e.mv != mv or len(e.data) < n:
            self._pop_key(key)
            self.stats["stale_drops"] += 1
            self.stats["misses"] += 1
            return None
        if _san.SAN is not None and granted is not None:
            # the entry is served under its inode lease: assert the same
            # one-TTL staleness contract metadata hits assert
            _san.SAN.check_lease_age(max(0.0, at - granted), bound,
                                     "extent cache entry")
        if in_ram:
            self._ram.move_to_end(key)
            self.stats["ram_hits"] += 1
            return e.data[:n], at + self._ram_cost(n)
        done = self._ssd_resource().acquire(at, self._ssd_cost(n))
        self.stats["ssd_hits"] += 1
        # promote: the hot packet moves back to RAM (2Q), possibly
        # demoting the coldest RAM entries in its place
        self._ssd.pop(key)
        self.ssd_bytes -= len(e.data)
        if self.ram_budget >= len(e.data):
            self._ram[key] = e
            self.ram_bytes += len(e.data)
            self.stats["promotions"] += 1
            self._evict_ram(done)
        else:
            self._ssd[key] = e
            self.ssd_bytes += len(e.data)
        return e.data[:n], done

    def insert(self, key: Key, data: bytes, ctx: Tuple, at: float) -> None:
        """Insert one committed packet read (or written through) under the
        validated lease context; oversized packets are not cached."""
        ino, mv, _granted, _bound = ctx
        n = len(data)
        if n == 0 or (n > self.ram_budget and n > self.ssd_budget):
            return
        old = self._pop_key(key)
        if old is not None:
            self.stats["invalidations"] += 1
        e = _Entry(bytes(data), ino, mv)
        if self.ram_budget >= n:
            self._ram[key] = e
            self.ram_bytes += n
            self._evict_ram(at)
        else:
            # no RAM tier: the insert is itself a device write
            self._ssd_resource().acquire(at, self._ssd_cost(n))
            self._ssd[key] = e
            self.ssd_bytes += n
            self._evict_ssd()
        # an eviction triggered by this very insert may have dropped it
        if key in self._ram or key in self._ssd:
            self._by_ino.setdefault(ino, {})[key] = None
            self.stats["inserts"] += 1

    # -------------------------------------------------------- invalidation
    def drop_inode(self, ino: int) -> int:
        """Drop every entry cached for ``ino`` (unlink/evict/overwrite/
        truncate funnels).  Returns the number of entries dropped."""
        keys = self._by_ino.pop(ino, None)
        if not keys:
            return 0
        n = 0
        for key in list(keys):
            e = self._ram.pop(key, None)
            if e is not None:
                self.ram_bytes -= len(e.data)
            else:
                e = self._ssd.pop(key, None)
                if e is not None:
                    self.ssd_bytes -= len(e.data)
            if e is not None:
                n += 1
        self.stats["invalidations"] += n
        return n

    def invalidate_extent_range(self, pid: int, eid: int,
                                lo: int, hi: int) -> int:
        """Drop entries overlapping ``[lo, hi)`` of one extent — the
        punch-hole/delete-extent funnel.  Small files share aggregated
        extents, so this is range-precise: a peer file's bytes elsewhere
        in the same extent stay cached."""
        n = 0
        for tier in (self._ram, self._ssd):
            for key in [k for k in tier
                        if k[1] == pid and k[2] == eid
                        and k[3] < hi and k[3] + len(tier[k].data) > lo]:
                e = tier.pop(key)
                if tier is self._ram:
                    self.ram_bytes -= len(e.data)
                else:
                    self.ssd_bytes -= len(e.data)
                self._unindex(key, e)
                n += 1
        self.stats["invalidations"] += n
        return n

    def note_extent_map(self, view: Dict) -> None:
        """An ``update_extents`` mutation replaced ``view['inode']``'s
        extent map wholesale and bumped its mv.  Entries whose byte range
        is still covered by an IDENTICAL extent piece of the new map hold
        the same committed bytes (appends never rewrite history) — they
        are re-stamped to the new mv and stay hot.  Everything else
        (trimmed tails, replaced pieces) is dropped."""
        ino = view.get("inode")
        keys = self._by_ino.get(ino)
        if not keys:
            return
        mv = view.get("mv", -2)
        size = view.get("size", 0)
        # (pid, eid) -> [(eoff, esize, foff)] of the new map
        cover: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        for (pid, eid, foff, eoff, esize) in view.get("extents", []):
            cover.setdefault((pid, eid), []).append((eoff, esize, foff))
        for key in list(keys):
            tier = self._ram if key in self._ram else self._ssd
            e = tier.get(key)
            if e is None:
                keys.pop(key, None)
                continue
            lo, hi = key[3], key[3] + len(e.data)
            ok = False
            for (eoff, esize, foff) in cover.get((key[1], key[2]), ()):
                if eoff <= lo and hi <= eoff + esize and \
                        foff + (hi - eoff) <= size:
                    ok = True
                    break
            if ok:
                e.mv = mv
            else:
                tier.pop(key)
                if tier is self._ram:
                    self.ram_bytes -= len(e.data)
                else:
                    self.ssd_bytes -= len(e.data)
                keys.pop(key, None)
                self.stats["invalidations"] += 1
        if not keys:
            self._by_ino.pop(ino, None)

    def clear(self) -> None:
        self._ram.clear()
        self._ssd.clear()
        self._by_ino.clear()
        self.ram_bytes = 0
        self.ssd_bytes = 0

    # ----------------------------------------------------------- reporting
    def occupancy(self) -> Dict[str, float]:
        return {"ram_bytes": self.ram_bytes, "ssd_bytes": self.ssd_bytes,
                "ram_entries": len(self._ram), "ssd_entries": len(self._ssd)}
