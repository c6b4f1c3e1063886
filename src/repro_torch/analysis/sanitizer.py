"""Runtime happens-before sanitizer for the discrete-event engine.

Under ``CFS_SANITIZE=1`` the simulator's benchmark-only invariants become
always-on assertions (λFS-style mechanical invariant checking):

* **HB-ordered conflicting writes** — every extent write is recorded with
  its op's fork context (the stack of ``OpTimer.fork`` branches it ran
  under).  Two writes to overlapping byte ranges of one replica's extent
  must be happens-before ordered: either sequential program order within
  one op, or separated by a ``join``.  Two *un-joined sibling branches* of
  the same fork touching the same range — or two concurrently-timed ops
  overlapping — raise :class:`HBViolation` at the write, where the race is
  visible, instead of surfacing later as an ``ExtentError`` symptom or a
  silently-diverged replica.
* **Committed-prefix reads** — data-partition leaders record a watermark
  ``(committed_offset, virtual_time)`` per extent; every timed read through
  ``DataPartitionReplica.read`` must be covered by a watermark that was
  committed at-or-before the read's virtual time.  This extends the
  leader-only runtime guard to followers, whose stale tails (legal to
  *hold*, §2.2.5, never to *serve*) would otherwise be served silently.
* **Lease staleness bound** — every lease-served metadata cache hit checks
  ``age <= TTL`` at the single serving funnel (``MetaSession._served``),
  turning the paper's one-TTL staleness contract into an assertion.
* **Async-commit ordering** — meta partitions record every mvcc assignment
  (``MetaPartitionSM.apply`` / snapshot restore); a timed read must never
  observe an mvcc the journal has not yet assigned
  (:meth:`Sanitizer.check_mvcc_read`), and a durability barrier drain must
  happens-before-precede its fsync ack: every async-acked background
  commit on the drained partition must have completed by the time the
  barrier returns (:meth:`Sanitizer.check_async_barrier`).

Design constraints: the sanitizer only *observes* — it never advances
clocks, touches RNGs, or perturbs resource queues, so enabling it cannot
change any benchmark trajectory; with ``CFS_SANITIZE`` unset every hook is
a single ``SAN is None`` check.  Only *timed* ops opened through
``Network.begin_op(at=t)`` are tracked: untimed unit-test paths (including
hand-built ``OpTimer`` objects and recovery prefills) are invisible to it.

This module imports only :mod:`.knobs` (stdlib underneath), so the
``core`` modules can import it without cycles.  It is the port's own copy
of the reference's ``repro.analysis.sanitizer``, with its own ``SAN``.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from . import knobs

__all__ = ["HBViolation", "Sanitizer", "SAN", "enabled", "enable", "disable"]

_EPS = 1e-6
_ANCIENT = float("-inf")   # "committed before this timeline started"


class HBViolation(AssertionError):
    """A happens-before / staleness invariant failed under CFS_SANITIZE=1."""


class _Fork:
    """Sanitizer-side record of one live ``OpTimer.fork``."""

    __slots__ = ("serial", "branch")

    def __init__(self, serial: int):
        self.serial = serial
        self.branch = 0          # index of the currently-running branch


class _Write:
    """One recorded extent write: byte range + full HB context."""

    __slots__ = ("lo", "hi", "op_serial", "ctx")

    def __init__(self, lo: int, hi: int, op_serial: int,
                 ctx: Tuple[Tuple[int, int], ...]):
        self.lo = lo
        self.hi = hi
        self.op_serial = op_serial
        self.ctx = ctx


def _same_op_concurrent(c1: Tuple[Tuple[int, int], ...],
                        c2: Tuple[Tuple[int, int], ...]) -> bool:
    """Two accesses of ONE op are concurrent iff their fork contexts diverge
    at a shared fork with different branch indices (un-joined siblings).
    A divergence at *different* fork serials means the earlier fork was
    joined before the later one was created — program order; a context that
    is a prefix of the other is the before-fork / after-join case."""
    for (f1, b1), (f2, b2) in zip(c1, c2):
        if f1 != f2:
            return False
        if b1 != b2:
            return True
    return False


class Sanitizer:
    """Shared state for one process-wide sanitizer instance."""

    def __init__(self) -> None:
        self._op_serial = 0
        self._fork_serial = 0
        # (id(store), extent_id) -> writes sorted by lo.  Extent ids are
        # per-ExtentStore (each partition replica numbers its own), so the
        # store instance — not the owning node — is the write domain.
        self._writes: Dict[Tuple[int, int], List[_Write]] = {}
        # (partition_id, extent_id) -> commit staircase: parallel arrays,
        # offsets strictly increasing, times strictly increasing, dominated
        # entries pruned — answer "earliest virtual time at which at least
        # ``hi`` bytes were committed" in O(log n)
        self._commit_off: Dict[Tuple[int, int], List[int]] = {}
        self._commit_t: Dict[Tuple[int, int], List[float]] = {}
        # meta partition_id -> highest mvcc the journal has assigned
        self._mvcc_hw: Dict[int, int] = {}
        # (client_id, partition_id) -> ((net_serial, epoch), commit_us) of
        # async-acked mutations still un-drained (a multiset: values
        # repeat); the timeline token tells live entries from records a
        # previous cluster/phase parked on a dead virtual clock
        self._async_acks: Dict[Tuple[str, int],
                               List[Tuple[Tuple[int, int], float]]] = {}
        self.violations = 0      # raises are counted too (tests may catch)

    # ---------------------------------------------------------- op context
    def on_begin_op(self, op) -> None:
        if not op.timed:
            return
        self._op_serial += 1
        op._san_serial = self._op_serial
        op._san_forks = []       # stack of live _Fork records

    def on_end_op(self, op) -> None:
        pass                     # fork records die with the op object

    def on_fork(self, op) -> Optional[_Fork]:
        forks = getattr(op, "_san_forks", None)
        if forks is None:
            return None
        self._fork_serial += 1
        rec = _Fork(self._fork_serial)
        forks.append(rec)
        return rec

    def on_branch_done(self, rec: _Fork) -> None:
        rec.branch += 1

    def on_join(self, op, rec: _Fork) -> None:
        forks = getattr(op, "_san_forks", None)
        if forks is not None and rec in forks:
            forks.remove(rec)

    @staticmethod
    def _ctx(op) -> Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]:
        """(op_serial, fork-context snapshot) for a tracked op, else None."""
        serial = getattr(op, "_san_serial", None)
        if serial is None:
            return None
        return serial, tuple((f.serial, f.branch) for f in op._san_forks)

    # ------------------------------------------------------- new timeline
    def on_new_timeline(self) -> None:
        """A fresh ``EventScheduler`` restarts virtual time at 0 (benchmark
        phases do this); everything recorded so far happened 'before' the
        new timeline.  Write records are dropped and commit staircases
        collapse to their high-water mark at t=-inf."""
        self._writes.clear()
        for key, offs in self._commit_off.items():
            if offs:
                self._commit_off[key] = [offs[-1]]
                self._commit_t[key] = [_ANCIENT]
        # async windows parked across a reset belong to a dead clock; the
        # mvcc high-waters are counters, not times — they survive
        self._async_acks.clear()

    # ------------------------------------------------------------- writes
    def note_append(self, store, extent_id: int, lo: int, hi: int,
                    op) -> None:
        """Record a write of ``[lo, hi)`` to one replica's extent and fail
        on any conflicting un-ordered write.  Called BEFORE the store
        validates the offset so a racy branch is reported as the race it
        is, not as the ExtentError symptom it causes."""
        ctx = self._ctx(op) if op is not None else None
        if ctx is None or hi <= lo:
            return
        serial, fork_ctx = ctx
        key = (id(store), extent_id)
        writes = self._writes.setdefault(key, [])
        # neighbors overlapping [lo, hi): sorted by lo, ranges disjoint in
        # the non-racy case, so only the predecessor and successors need a look
        i = bisect.bisect_left([w.lo for w in writes], lo)
        j = i - 1 if i > 0 else 0
        for w in writes[j:]:
            if w.lo >= hi:
                break
            if w.hi <= lo:
                continue
            if w.op_serial == serial:
                racy = _same_op_concurrent(w.ctx, fork_ctx)
                what = "un-joined fork branches"
            else:
                racy = True
                what = "concurrent timed ops"
            if racy:
                self.violations += 1
                raise HBViolation(
                    f"conflicting extent writes not happens-before ordered: "
                    f"{what} both wrote [{max(lo, w.lo)}, {min(hi, w.hi)}) "
                    f"of extent {extent_id} on node "
                    f"{store.disk.owner!r} (ops #{w.op_serial} and #{serial})")
        writes.insert(i, _Write(lo, hi, serial, fork_ctx))

    def note_truncate(self, store, extent_id: int, size: int) -> None:
        """Recovery truncation discards the tail — and with it any recorded
        writes above ``size``, so the re-replicated bytes don't collide."""
        key = (id(store), extent_id)
        writes = self._writes.get(key)
        if not writes:
            return
        self._writes[key] = [_clip(w, size) for w in writes if w.lo < size]

    def drop_extent(self, store, extent_id: int) -> None:
        self._writes.pop((id(store), extent_id), None)

    def drop_store(self, store) -> None:
        """Wholesale replacement of a store (raft snapshot restore)."""
        sid = id(store)
        for key in [k for k in self._writes if k[0] == sid]:
            del self._writes[key]

    # ------------------------------------------------------------ commits
    def note_commit(self, partition_id: int, extent_id: int, committed: int,
                    op) -> None:
        """Leader computed a new committed offset.  Untracked (untimed) ops
        record at t=-inf: they are not on the virtual timeline, so anything
        they commit is visible to every timed read."""
        t = op.now_us if getattr(op, "_san_serial", None) is not None \
            else _ANCIENT
        key = (partition_id, extent_id)
        offs = self._commit_off.setdefault(key, [])
        ts = self._commit_t.setdefault(key, [])
        i = bisect.bisect_left(offs, committed)
        if i < len(offs) and ts[i] <= t:
            return                    # dominated: >= offset already at <= t
        # drop entries this one dominates (smaller offset, later time)
        while i > 0 and ts[i - 1] >= t:
            i -= 1
            del offs[i], ts[i]
        offs.insert(i, committed)
        ts.insert(i, t)

    def check_read(self, partition_id: int, extent_id: int, lo: int, hi: int,
                   op) -> None:
        """A timed read of ``[lo, hi)`` must be covered by a commit watermark
        that existed at-or-before the read's virtual time.  Extents with no
        watermark at all (built outside the replication path by test
        fixtures) are not checked."""
        if getattr(op, "_san_serial", None) is None or hi <= lo:
            return
        key = (partition_id, extent_id)
        offs = self._commit_off.get(key)
        if not offs:
            return
        i = bisect.bisect_left(offs, hi)
        if i == len(offs):
            self.violations += 1
            raise HBViolation(
                f"committed-prefix violation: read [{lo}, {hi}) of extent "
                f"{extent_id} in partition {partition_id} beyond the "
                f"committed offset {offs[-1]} (stale tail served)")
        t_committed = self._commit_t[key][i]
        if t_committed > op.now_us + _EPS:
            self.violations += 1
            raise HBViolation(
                f"committed-prefix violation: read [{lo}, {hi}) of extent "
                f"{extent_id} in partition {partition_id} at virtual time "
                f"{op.now_us:.3f} but offset {hi} was only committed at "
                f"{t_committed:.3f}")

    # ------------------------------------------------------- async commits
    def note_mvcc_assign(self, partition_id: int, mvcc: int) -> None:
        """The journal's mvcc-assignment point (every applied mutation and
        every snapshot restore): advance the partition's high-water."""
        if mvcc > self._mvcc_hw.get(partition_id, -1):
            self._mvcc_hw[partition_id] = mvcc

    def check_mvcc_read(self, partition_id: int, mvcc: int, op) -> None:
        """No timed read may observe a partition mvcc the journal has not
        yet assigned.  Partitions with no recorded assignment (built
        outside the apply path by test fixtures) are not checked."""
        if op is None or getattr(op, "_san_serial", None) is None:
            return
        hw = self._mvcc_hw.get(partition_id)
        if hw is None:
            return
        if mvcc > hw:
            self.violations += 1
            raise HBViolation(
                f"async-commit mvcc violation: read observed mvcc {mvcc} "
                f"on meta partition {partition_id} but the journal has "
                f"only assigned up to {hw}")

    def note_async_ack(self, key: Tuple[str, int], commit_us: float,
                       op, timeline: Tuple[int, int]) -> None:
        """An async-acked mutation's background commit is now outstanding
        for (client, partition) until a barrier drains it.  ``timeline``
        is the client's (net_serial, timeline_epoch): commit times only
        mean anything on the virtual clock that produced them."""
        if op is None or getattr(op, "_san_serial", None) is None:
            return
        self._async_acks.setdefault(key, []).append((timeline, commit_us))

    def check_async_barrier(self, key: Tuple[str, int], op,
                            timeline: Tuple[int, int]) -> None:
        """Barrier drain must HB-precede the fsync ack: when a barrier over
        (client, partition) returns, every outstanding background commit
        on the SAME virtual timeline must have completed at-or-before the
        caller's virtual time (records from a dead clock are discarded)."""
        lst = self._async_acks.pop(key, None)
        if not lst or op is None or \
                getattr(op, "_san_serial", None) is None:
            return
        live = [c for (tl, c) in lst if tl == timeline]
        if not live:
            return
        hw = max(live)
        if op.now_us + _EPS < hw:
            self.violations += 1
            raise HBViolation(
                f"async-commit barrier violated: drain returned at "
                f"{op.now_us:.3f}us with a background commit acked at "
                f"{hw:.3f}us still in flight on partition {key[1]}")

    # -------------------------------------------------------------- leases
    def check_lease_age(self, age_us: float, bound_us: float,
                        what: str = "entry") -> None:
        """A lease-served cache hit must respect the one-TTL staleness
        contract: served age <= TTL."""
        if age_us > bound_us + _EPS:
            self.violations += 1
            raise HBViolation(
                f"lease staleness bound exceeded: {what} served at age "
                f"{age_us:.1f}us > TTL {bound_us:.1f}us")


def _clip(w: _Write, size: int) -> _Write:
    if w.hi > size:
        return _Write(w.lo, size, w.op_serial, w.ctx)
    return w


# Process-wide instance, or None when disabled (the common case: every hook
# site guards with ``if SAN is not None``, keeping the off path one global
# load + compare).
SAN: Optional[Sanitizer] = Sanitizer() if knobs.get_bool("CFS_SANITIZE") \
    else None


def enabled() -> bool:
    return SAN is not None


def enable() -> Sanitizer:
    """Turn the sanitizer on (tests); returns the fresh instance."""
    global SAN
    SAN = Sanitizer()
    return SAN


def disable() -> None:
    global SAN
    SAN = None
