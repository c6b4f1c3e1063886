"""Client metadata sessions — the lease/version consistency contract.

The paper's client cache (§2.4) fills on create/lookup/readdir and
*force-syncs on every open*.  That contract makes the open/stat hot path a
read storm on the meta partition leaders: at mdtest 8×64 the leaders queue
on redundant ``get_inode``/``lookup`` reads whose answers the client already
holds.  λFS/AsyncFS-style systems win this path by changing the contract,
not the cache: bounded staleness instead of sync-on-open.

A :class:`MetaSession` wraps one ``CfsClient``'s inode/dentry/dir caches in
**TTL leases** stamped with the server's per-partition ``mvcc`` versions:

* ``lookup`` / ``getattr`` / ``readdir`` / ``readdir_plus`` are served from
  a cache entry while its lease holds — ``open`` no longer force-syncs;
* missing names are cached as **negative dentries** with their own shorter
  TTL (``CFS_META_NEG_TTL``), so repeated ENOENT probes cost nothing;
* an *expired* entry is revalidated with the cheap ``stat_version`` read
  (compare the entry's ``mv`` stamp, renew the lease) instead of a full
  refetch — only a changed entry pays the refetch;
* every mutation the client routes (create/unlink/rename/truncate-sync/
  ``meta_batch``) invalidates or refreshes the touched entries *locally and
  immediately* via :meth:`note_mutation`, so a client always reads its own
  writes with zero staleness.

**Staleness bound**: a served value was authoritative at its lease-grant
time, and a lease lives at most ``min(client TTL, server grant)`` — so a
reader never observes state older than one TTL, and converges to another
client's mutation within one TTL of it.

**Seed compatibility**: with ``CFS_META_TTL=0`` — or outside a *timed* op,
where there is no virtual clock to bound a lease against — every method
reproduces the seed's paths bit-identically: unconditional dentry cache for
interior path components, authoritative RPC for the leaf, force-sync
``get_inode`` on open, uncached ``readdir``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..analysis import knobs
from ..analysis import sanitizer as _san
from .meta_node import NoSuchDentry, NoSuchInode

__all__ = ["MetaSession", "META_TTL_US", "META_NEG_TTL_US"]

# Client-side lease TTLs (virtual µs).  CFS_META_TTL=0 disables sessions
# entirely (the seed sync-on-open path, kept for A/B benchmarking).  Read
# from the knob registry — the server's grant (meta_node.META_LEASE_US)
# comes from the same entry, so the two sides cannot skew.
META_TTL_US = knobs.get_float("CFS_META_TTL")
META_NEG_TTL_US = knobs.get_float("CFS_META_NEG_TTL")


def _not_found(msg: str) -> Exception:
    from .client import NotFound          # client imports us first
    return NotFound(msg)


class MetaSession:
    """Versioned, leased view of one client's metadata caches.

    The *value* stores stay on the client (``dentry_cache``/``inode_cache``
    — the seed's caches, still inspectable by tests and tools); the session
    owns the validity metadata: per-entry ``(mv, granted_us, expires_us)``
    stamps, the negative-dentry table, and per-directory listing leases.
    """

    def __init__(self, client: Any,
                 ttl_us: float = META_TTL_US,
                 neg_ttl_us: float = META_NEG_TTL_US):
        self.client = client
        self.ttl_us = ttl_us
        self.neg_ttl_us = neg_ttl_us
        # (parent, name) -> (mv, granted_us, expires_us)
        self._dmeta: Dict[Tuple[int, str], Tuple[int, float, float]] = {}
        # ino -> (mv, granted_us, expires_us)
        self._imeta: Dict[int, Tuple[int, float, float]] = {}
        # negative dentries: (parent, name) -> (granted_us, expires_us)
        self._neg: Dict[Tuple[int, str], Tuple[float, float]] = {}
        # parent -> (dentry views, granted_us, expires_us)
        self._dirs: Dict[int, Tuple[List[Dict], float, float]] = {}

    # ------------------------------------------------------------ clock/lease
    def now(self) -> Optional[float]:
        """Virtual time of the current *timed* op; ``None`` when there is no
        clock to bound a lease against (plain synchronous calls)."""
        op = self.client.net.current_op
        return op.now_us if op is not None and op.timed else None

    def _active(self, now: Optional[float]) -> bool:
        return now is not None and self.ttl_us > 0

    def _grant(self, lease_us: float) -> Tuple[float, float]:
        """(granted, expires) for a reply arriving now; the client caps the
        server's grant at its own TTL."""
        t = self.now()
        assert t is not None
        return t, t + min(self.ttl_us, lease_us)

    def _served(self, granted: float, now: float, neg: bool = False) -> None:
        st = self.client.stats
        st["neg_hits" if neg else "meta_cache_hits"] += 1
        age = max(0.0, now - granted)
        if age > st["meta_stale_max_us"]:
            st["meta_stale_max_us"] = age
        if _san.SAN is not None:
            # every lease-served hit funnels through here: assert the paper's
            # one-TTL staleness contract instead of trusting the expiry math
            _san.SAN.check_lease_age(
                age, self.neg_ttl_us if neg else self.ttl_us,
                "negative dentry" if neg else "lease entry")

    def _check_env(self, mp: Any, env: Dict) -> Dict:
        """Async-commit invariant on every leased envelope: a timed read
        must never observe a partition mvcc the journal has not yet
        assigned (the ordering substrate read-your-writes rides on).  The
        envelope names the partition that actually served it — after a
        WrongRange redirect that is the split sibling, not ``mp``."""
        if _san.SAN is not None:
            _san.SAN.check_mvcc_read(env.get("pid", mp.pid), env["mvcc"],
                                     self.client.net.current_op)
        return env

    # ------------------------------------------------------------------ reads
    def lookup(self, parent: int, name: str,
               authoritative: bool = False, sync: bool = False) -> Dict:
        """Resolve one path component.  ``authoritative`` marks the leaf of
        a path walk: under the seed contract it forces an RPC (a stale
        cache entry must not resurrect an unlinked file); under an active
        session a valid lease answers it — bounded staleness IS the new
        contract — and a valid negative entry answers ENOENT.

        ``sync`` bypasses the lease even under an active session: a
        resolution that will PARAMETERIZE a mutation (unlink/rename/rmdir/
        link feed the resolved inode into batched unlink_dec/evict ops)
        must be server-fresh — a TTL-stale dentry there would destroy the
        wrong inode, not just serve an old read."""
        cl = self.client
        key = (parent, name)
        now = self.now()
        if sync and self._active(now):
            return self._fetch_dentry(parent, name)
        if not self._active(now):
            # ---- seed path (untimed op, or TTL=0) ----
            if not authoritative and key in cl.dentry_cache:
                cl.stats["cache_hits"] += 1
                return cl.dentry_cache[key]
            mp = cl._mp_for_inode(parent)
            try:
                d = cl._meta_read(mp, "lookup", parent, name)
            except NoSuchDentry:
                self.forget_dentry(parent, name)
                raise _not_found(f"{parent}/{name}")
            # note_dentry also clears a stale negative entry — an untimed
            # success must not leave cached ENOENT for a later timed op
            self.note_dentry(d)
            return d
        ne = self._neg.get(key)
        if ne is not None and now < ne[1]:
            self._served(ne[0], now, neg=True)
            raise _not_found(f"{parent}/{name}")
        d = cl.dentry_cache.get(key)
        meta = self._dmeta.get(key)
        if d is not None and meta is not None:
            mv, granted, expires = meta
            if now < expires:
                self._served(granted, now)
                return d
            verdict = self._revalidate(parent, "dentry", key, mv)
            if verdict == "ok":
                return d
            if verdict == "gone":
                raise _not_found(f"{parent}/{name}")
        cl.stats["meta_cache_misses"] += 1
        return self._fetch_dentry(parent, name)

    def _fetch_dentry(self, parent: int, name: str) -> Dict:
        """Server-fresh leased dentry fetch + note (the miss and ``sync``
        paths); a NAK becomes a negative entry."""
        cl = self.client
        mp = cl._mp_for_inode(parent)
        try:
            env = self._check_env(mp, cl._meta_read(
                mp, "lookup", parent, name, method="read_leased"))
        except NoSuchDentry:
            self.forget_dentry(parent, name, negative=True)
            raise _not_found(f"{parent}/{name}")
        self.note_dentry(env["v"], lease_us=env["lease_us"])
        return env["v"]

    def getattr(self, ino: int, use_cache: bool = False,
                sync: bool = False) -> Dict:
        """Inode attributes.  Seed contract: one ``get_inode`` RPC per call
        (this is the force-sync ``open`` used to pay); session contract: a
        valid lease serves it, an expired entry revalidates by version.

        ``sync`` bypasses the lease even under an active session: an inode
        view that will PARAMETERIZE a mutation — an open-for-write handle
        snapshots size/extents and ``update_extents`` later replaces the
        server's map wholesale — must be server-fresh, or a TTL-stale view
        would silently drop another client's committed appends."""
        cl = self.client
        now = self.now()
        if sync and self._active(now):
            return self._fetch_inode(ino)
        if not self._active(now):
            # ---- seed path ----
            if use_cache and ino in cl.inode_cache:
                cl.stats["cache_hits"] += 1
                return cl.inode_cache[ino]
            mp = cl._mp_for_inode(ino)
            try:
                inode = cl._meta_read(mp, "get_inode", ino)
            except NoSuchInode:
                raise _not_found(f"inode {ino}")
            cl.inode_cache[ino] = inode
            self._imeta.pop(ino, None)
            return inode
        inode = cl.inode_cache.get(ino)
        meta = self._imeta.get(ino)
        if inode is not None and meta is not None:
            mv, granted, expires = meta
            if now < expires:
                self._served(granted, now)
                return inode
            verdict = self._revalidate(ino, "inode", ino, mv)
            if verdict == "ok":
                return inode
            if verdict == "gone":
                raise _not_found(f"inode {ino}")
        cl.stats["meta_cache_misses"] += 1
        return self._fetch_inode(ino)

    def _fetch_inode(self, ino: int) -> Dict:
        """Server-fresh leased inode fetch + note (the miss and ``sync``
        paths)."""
        cl = self.client
        mp = cl._mp_for_inode(ino)
        try:
            env = self._check_env(mp, cl._meta_read(
                mp, "get_inode", ino, method="read_leased"))
        except NoSuchInode:
            self.forget_inode(ino)
            raise _not_found(f"inode {ino}")
        self.note_inode(env["v"], lease_us=env["lease_us"])
        return env["v"]

    def _revalidate(self, route_ino: int, kind: str, key: Any,
                    mv: int) -> str:
        """Expired entry: ask the partition for just the ``mv`` stamp (a
        16-byte reply instead of a whole inode with its extent map).  An
        unchanged stamp renews the lease in place — ``"ok"``, the cheap
        path.  A changed stamp drops the entry so the caller refetches —
        ``"changed"``.  A vanished entry is fresh authority that the object
        is gone — ``"gone"``, and a dentry becomes a negative entry without
        a second round-trip."""
        cl = self.client
        mp = cl._mp_for_inode(route_ino)
        env = self._check_env(mp, cl._meta_read(
            mp, "stat_version", kind, key,
            method="read_leased", reply_bytes=16))
        sv = env["v"]
        if sv["mv"] == mv and mv >= 0:
            cl.stats["lease_revalidations"] += 1
            granted, expires = self._grant(env["lease_us"])
            store = self._imeta if kind == "inode" else self._dmeta
            store[key] = (mv, granted, expires)
            return "ok"
        if kind == "dentry":
            self.forget_dentry(key[0], key[1], negative=sv["mv"] < 0)
        else:
            self.forget_inode(key)
        return "gone" if sv["mv"] < 0 else "changed"

    def readdir(self, parent: int, sync: bool = False) -> List[Dict]:
        """Directory listing; under an active session one leased RPC fills
        both the listing cache and the per-dentry cache (§2.4 'fills on
        readdir'), and repeats are served until the lease expires or a
        local mutation under ``parent`` invalidates it.  Listings have no
        cheap revalidation (there is no per-directory version) — an expired
        listing refetches.

        ``sync`` bypasses the lease: a listing that GATES a mutation
        (rmdir's emptiness check) must be server-fresh, or a stale-empty
        cache would let rmdir delete a directory another client just
        populated — leaving dangling dentries."""
        cl = self.client
        now = self.now()
        if not self._active(now):
            mp = cl._mp_for_inode(parent)
            return cl._meta_read(mp, "read_dir", parent)
        if not sync:
            cached = self._dirs.get(parent)
            if cached is not None and now < cached[2]:
                self._served(cached[1], now)
                return cached[0]
            cl.stats["meta_cache_misses"] += 1
        mp = cl._mp_for_inode(parent)
        env = self._check_env(mp, cl._meta_read(
            mp, "read_dir", parent, method="read_leased"))
        dentries = env["v"]
        granted, expires = self._grant(env["lease_us"])
        self._dirs[parent] = (dentries, granted, expires)
        for d in dentries:
            self.note_dentry(d, lease_us=env["lease_us"])
        return dentries

    def readdir_plus(self, parent: int) -> List[Dict]:
        """DirStat path (§4.2): readdir, then ONE ``batch_inode_get`` per
        meta partition for the inodes whose leases do not answer."""
        cl = self.client
        dentries = self.readdir(parent)
        now = self.now()
        active = self._active(now)
        out: Dict[int, Dict] = {}
        missing: List[int] = []
        for d in dentries:
            ino = d["inode"]
            if active:
                meta = self._imeta.get(ino)
                if meta is not None and now < meta[2] and \
                        ino in cl.inode_cache:
                    self._served(meta[1], now)
                    out[ino] = cl.inode_cache[ino]
                else:
                    missing.append(ino)
            elif ino in cl.inode_cache:
                cl.stats["cache_hits"] += 1
                out[ino] = cl.inode_cache[ino]
            else:
                missing.append(ino)
        by_mp: Dict[int, List[int]] = {}
        for ino in missing:
            mp = cl._mp_for_inode(ino)
            by_mp.setdefault(mp.pid, []).append(ino)
        for pid, inos in by_mp.items():
            mp = next(m for m in cl.meta_partitions if m.pid == pid)
            if active:
                cl.stats["meta_cache_misses"] += len(inos)
                env = self._check_env(mp, cl._meta_read(
                    mp, "batch_inode_get", inos, method="read_leased"))
                for iv in env["v"]:
                    self.note_inode(iv, lease_us=env["lease_us"])
                    out[iv["inode"]] = iv
            else:
                for iv in cl._meta_read(mp, "batch_inode_get", inos):
                    cl.inode_cache[iv["inode"]] = iv
                    self._imeta.pop(iv["inode"], None)
                    out[iv["inode"]] = iv
        for ino in missing:
            if ino in out:
                continue
            # a batch miss can be a stale ROUTE, not a vanished inode: the
            # dentry may point at an inode a split re-homed onto a sibling
            # our cached table does not know yet.  batch_inode_get is
            # best-effort (it never raises WrongRange), so refetch the miss
            # individually — get_inode carries the redirect; a genuinely
            # vanished inode stays absent (attr None, seed semantics).
            from .client import NotFound      # deferred: client imports us
            try:
                out[ino] = self.getattr(ino)
            except (NotFound, NoSuchInode):
                pass
        return [{**d, "attr": out.get(d["inode"])} for d in dentries]

    # ----------------------------------------------------------- bookkeeping
    def note_inode(self, view: Dict, lease_us: Optional[float] = None) -> None:
        """Install a fresh inode view.  Mutation replies and leased reads
        are both authoritative at their arrival time; without a clock the
        value is cached (seed behaviour) but carries no lease."""
        ino = view["inode"]
        self.client.inode_cache[ino] = view
        now = self.now()
        if self._active(now):
            ttl = self.ttl_us if lease_us is None else min(self.ttl_us,
                                                           lease_us)
            self._imeta[ino] = (view.get("mv", -2), now, now + ttl)
        else:
            self._imeta.pop(ino, None)

    def note_dentry(self, view: Dict,
                    lease_us: Optional[float] = None) -> None:
        key = (view["parent"], view["name"])
        self.client.dentry_cache[key] = view
        self._neg.pop(key, None)
        now = self.now()
        if self._active(now):
            ttl = self.ttl_us if lease_us is None else min(self.ttl_us,
                                                           lease_us)
            self._dmeta[key] = (view.get("mv", -2), now, now + ttl)
        else:
            self._dmeta.pop(key, None)

    def forget_inode(self, ino: int) -> None:
        self.client.inode_cache.pop(ino, None)
        self._imeta.pop(ino, None)
        # the central inode-drop funnel (unlink-dead, evict, revalidate-gone,
        # fetch-NotFound) also empties the data cache: no metadata, no bytes
        cache = getattr(self.client, "data_cache", None)
        if cache is not None:
            cache.drop_inode(ino)

    def inode_lease(self, ino: int) -> Optional[Tuple[int, float, float]]:
        """The inode's current ``(mv, granted_us, expires_us)`` lease, or
        None when nothing is leased (untimed op / TTL 0 / never fetched).
        The extent cache uses ``granted_us`` to assert the one-TTL
        staleness bound on every serve under ``CFS_SANITIZE=1``."""
        return self._imeta.get(ino)

    def forget_dentry(self, parent: int, name: str,
                      negative: bool = False) -> None:
        """Drop a dentry (and its parent's listing lease).  ``negative``
        caches the *absence*: the caller just learned authoritatively that
        the name is gone (own delete, or a NAK/stat_version reply)."""
        key = (parent, name)
        self.client.dentry_cache.pop(key, None)
        self._dmeta.pop(key, None)
        self._dirs.pop(parent, None)
        now = self.now()
        if negative and self._active(now) and self.neg_ttl_us > 0:
            self._neg[key] = (now, now + self.neg_ttl_us)
        else:
            self._neg.pop(key, None)

    def forget_dir(self, parent: int) -> None:
        self._dirs.pop(parent, None)

    def invalidate_all(self) -> None:
        """Drop every lease (kept for tools/failover paths)."""
        self._dmeta.clear()
        self._imeta.clear()
        self._neg.clear()
        self._dirs.clear()

    # ---- local write-through invalidation ---------------------------------
    def note_mutation(self, payload: Tuple, result: Any) -> None:
        """Hook run for EVERY metadata mutation this client routes (single
        proposes and each batch sub-op): refresh what the reply proves,
        drop what it obsoletes.  This is what keeps a session's staleness
        one-sided — a client never serves its own past."""
        op = payload[0]
        if op == "batch":
            for sub, res in zip(payload[1], result):
                self.note_mutation(sub, res)
            return
        if op in ("create_inode", "link_inc", "update_extents"):
            self.note_inode(result)
            if op == "update_extents":
                # the reply is the new extent map + mv: re-stamp cached
                # packets it still covers, drop the ones it obsoletes
                cache = getattr(self.client, "data_cache", None)
                if cache is not None:
                    cache.note_extent_map(result)
        elif op == "unlink_dec":
            from .types import InodeFlag
            if result["nlink"] <= 0 or result["flag"] == InodeFlag.MARK_DELETED:
                self.forget_inode(result["inode"])
            else:
                self.note_inode(result)
        elif op == "evict":
            if isinstance(payload[1], int):
                self.forget_inode(payload[1])
        elif op == "create_dentry":
            self.note_dentry(result)
            self.forget_dir(result["parent"])
        elif op == "delete_dentry":
            self.forget_dentry(result["parent"], result["name"],
                               negative=True)
