"""Raft consensus (tick-driven, deterministic) for the simulated cluster.

Used three ways in CFS (paper §2.1.2, §2.2.4, §2.3):
  * resource manager: one 3-replica group,
  * meta partitions: MultiRaft — one group per partition, many per node,
  * data partitions: raft replication for the *overwrite* path.

Transport is synchronous (see ``simnet.Network``): an RPC either returns a
reply immediately or raises ``NetError`` (drop / partition / dead node), which
we treat as a lost message.  Election and heartbeat timers are advanced by
explicit ``tick()`` calls — the same pattern etcd-raft uses for deterministic
testing.

Retried proposals are deduplicated with (client_id, seq) sessions so that FS
operations stay exactly-once even though the paper's clients retry on failure
(§2.1.3).
"""

from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis import knobs
from .simnet import NetError, Network

# Leader→follower AppendEntries legs of one propose are independent RPCs; a
# real leader fires them concurrently.  Under a *timed* op they run as
# ``OpTimer.fork`` branches (the op pays max(legs), the source NIC still
# serializes transmissions) instead of serializing the whole round-trips —
# meta p50 drops as the replica count grows.  CFS_RAFT_FANOUT=0 keeps the
# seed's serial legs for A/B benchmarking.
FANOUT_APPENDS = knobs.get_bool("CFS_RAFT_FANOUT")

__all__ = [
    "Role",
    "LogEntry",
    "NotLeader",
    "NotCommitted",
    "StateMachine",
    "RaftMember",
]


class Role:
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


class NotLeader(Exception):
    def __init__(self, hint: Optional[str] = None):
        super().__init__(f"not leader (hint={hint})")
        self.leader_hint = hint


class NotCommitted(Exception):
    """Majority unreachable within this proposal; client should retry."""


class SMError:
    """A state-machine level error captured as a VALUE.

    ``apply`` must never raise out of the raft machinery (followers apply the
    same entries and would blow up inside AppendEntries); instead the error is
    stored as the entry's result and re-raised only at the proposer."""

    __slots__ = ("exc",)

    def __init__(self, exc: Exception):
        self.exc = exc


@dataclass
class LogEntry:
    term: int
    cmd: Any  # (client_id, seq, payload) or raw payload


class StateMachine:
    """Interface the replicated state machine implements."""

    def apply(self, payload: Any) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def snapshot(self) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def restore(self, snap: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError


# ---- messages --------------------------------------------------------------
@dataclass
class VoteReq:
    group: str
    term: int
    candidate: str
    last_log_index: int
    last_log_term: int


@dataclass
class VoteReply:
    term: int
    granted: bool


@dataclass
class AppendReq:
    group: str
    term: int
    leader: str
    prev_index: int
    prev_term: int
    entries: List[LogEntry]
    commit: int


@dataclass
class AppendReply:
    term: int
    success: bool
    match_index: int


@dataclass
class SnapReq:
    group: str
    term: int
    leader: str
    last_included_index: int
    last_included_term: int
    snapshot: Any
    dedup: Dict[Tuple[str, int], Any]


ELECTION_TICKS = 10
HEARTBEAT_TICKS = 2
COMPACT_THRESHOLD = 512  # log entries before snapshot+truncate


class RaftMember:
    """One member of one raft group, hosted on a node.

    ``send(dst_node, msg) -> reply`` is provided by the host (MultiRaftHost or
    a plain router) and goes through the simulated network.
    """

    def __init__(
        self,
        group_id: str,
        node_id: str,
        peers: List[str],          # node ids of ALL members (incl. self)
        sm: StateMachine,
        send: Callable[[str, Any], Any],
        rng: Optional[random.Random] = None,
        net: Optional[Network] = None,   # for timed fan-out of append legs
    ):
        self.group_id = group_id
        self.node_id = node_id
        self.peers = list(peers)
        self.sm = sm
        self.send = send
        self.net = net
        # crc32, NOT builtin hash(): str hashing is salted per process and
        # would give every run a different election-timeout sequence
        self.rng = rng or random.Random(
            zlib.crc32(f"{group_id}/{node_id}".encode()) & 0xFFFF)

        self.term = 0
        self.voted_for: Optional[str] = None
        self.role = Role.FOLLOWER
        self.leader_id: Optional[str] = None

        # log[0] is a sentinel at (snap_index, snap_term)
        self.snap_index = 0
        self.snap_term = 0
        self.log: List[LogEntry] = []
        self.commit_index = 0
        self.applied = 0

        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}

        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        self.randomized_timeout = self._rand_timeout()

        # client session dedup: (client_id, seq) -> result
        self.dedup: Dict[Tuple[str, int], Any] = {}

        # stats
        self.elections = 0
        self.applied_count = 0

    # ---- log helpers -----------------------------------------------------
    def _rand_timeout(self) -> int:
        return ELECTION_TICKS + self.rng.randrange(ELECTION_TICKS)

    def last_index(self) -> int:
        return self.snap_index + len(self.log)

    def term_at(self, index: int) -> int:
        if index == self.snap_index:
            return self.snap_term
        off = index - self.snap_index - 1
        if 0 <= off < len(self.log):
            return self.log[off].term
        return -1

    def entry_at(self, index: int) -> LogEntry:
        return self.log[index - self.snap_index - 1]

    def entries_from(self, index: int) -> List[LogEntry]:
        return self.log[index - self.snap_index - 1 :]

    # ---- tick ------------------------------------------------------------
    def tick(self) -> None:
        if self.role == Role.LEADER:
            self.heartbeat_elapsed += 1
            if self.heartbeat_elapsed >= HEARTBEAT_TICKS:
                self.heartbeat_elapsed = 0
                self.broadcast_append()
        else:
            self.election_elapsed += 1
            if self.election_elapsed >= self.randomized_timeout:
                self.start_election()

    # ---- election --------------------------------------------------------
    def start_election(self) -> None:
        self.role = Role.CANDIDATE
        self.term += 1
        self.voted_for = self.node_id
        self.leader_id = None
        self.election_elapsed = 0
        self.randomized_timeout = self._rand_timeout()
        self.elections += 1
        votes = 1
        req = VoteReq(self.group_id, self.term, self.node_id,
                      self.last_index(), self.term_at(self.last_index()))
        for peer in self.peers:
            if peer == self.node_id:
                continue
            try:
                reply: VoteReply = self.send(peer, req)
            except NetError:
                continue
            if reply is None:
                continue
            if reply.term > self.term:
                self.become_follower(reply.term, None)
                return
            if reply.granted:
                votes += 1
        if self.role == Role.CANDIDATE and votes * 2 > len(self.peers):
            self.become_leader()

    def become_follower(self, term: int, leader: Optional[str]) -> None:
        self.term = term
        self.role = Role.FOLLOWER
        self.leader_id = leader
        self.voted_for = None
        self.election_elapsed = 0
        self.randomized_timeout = self._rand_timeout()

    def become_leader(self) -> None:
        self.role = Role.LEADER
        self.leader_id = self.node_id
        ni = self.last_index() + 1
        self.next_index = {p: ni for p in self.peers if p != self.node_id}
        self.match_index = {p: 0 for p in self.peers if p != self.node_id}
        # §5.4.2 keeps ``_advance_commit`` from committing PRIOR-term entries
        # by counting replicas, so a fresh leader would sit on a fully
        # replicated-but-uncommitted tail (e.g. async-acked metadata
        # mutations mid-failover) until the next client proposal.  The
        # standard fix: append a no-op entry in the NEW term immediately —
        # committing it commits (and applies) the whole surviving prefix,
        # which is exactly the journal replay that makes the new leader's
        # tree equal the acked history.
        self.log.append(LogEntry(self.term, ("", -1, None)))
        self.broadcast_append()  # assert leadership immediately

    # ---- replication -----------------------------------------------------
    def propose(self, payload: Any, client_id: str = "", seq: int = -1) -> Any:
        """Append+replicate a command; returns the state-machine result once
        committed.  Raises NotLeader / NotCommitted."""
        if self.role != Role.LEADER:
            raise NotLeader(self.leader_id)
        if client_id and (client_id, seq) in self.dedup:
            return self._unwrap(self.dedup[(client_id, seq)])
        self.log.append(LogEntry(self.term, (client_id, seq, payload)))
        index = self.last_index()
        self.broadcast_append()
        if self.commit_index >= index:
            # applied during broadcast commit advance
            if client_id:
                return self._unwrap(self.dedup.get((client_id, seq)))
            return self._unwrap(self._last_apply_result)
        raise NotCommitted(f"group={self.group_id} index={index}")

    @staticmethod
    def _unwrap(result: Any) -> Any:
        if isinstance(result, SMError):
            raise result.exc
        return result

    def broadcast_append(self) -> None:
        if self.role != Role.LEADER:
            return
        peers = [p for p in self.peers if p != self.node_id]
        op = self.net.current_op if self.net is not None else None
        if FANOUT_APPENDS and op is not None and op.timed and len(peers) > 1:
            # concurrent legs: each branch rewinds to the fork point, the
            # join resumes at the latest leg's reply — the propose pays
            # max(legs) instead of sum(legs).  Replies still apply in
            # deterministic peer order (same Python call sequence).
            fork = op.fork()
            for peer in peers:
                self._replicate_to(peer)
                fork.branch_done()
            fork.join()
        else:
            for peer in peers:
                self._replicate_to(peer)
        self._advance_commit()

    def _replicate_to(self, peer: str) -> None:
        ni = self.next_index.get(peer, self.last_index() + 1)
        if ni <= self.snap_index:
            self._send_snapshot(peer)
            return
        prev = ni - 1
        req = AppendReq(
            self.group_id, self.term, self.node_id,
            prev, self.term_at(prev), self.entries_from(ni), self.commit_index,
        )
        try:
            reply: AppendReply = self.send(peer, req)
        except NetError:
            return
        if reply is None:
            return
        if reply.term > self.term:
            self.become_follower(reply.term, None)
            return
        if reply.success:
            self.match_index[peer] = reply.match_index
            self.next_index[peer] = reply.match_index + 1
        else:
            # back off; resend next round (or immediately if far behind)
            self.next_index[peer] = max(1, min(ni - 1, reply.match_index + 1))

    def _send_snapshot(self, peer: str) -> None:
        req = SnapReq(self.group_id, self.term, self.node_id,
                      self.snap_index, self.snap_term,
                      self.sm.snapshot(), dict(self.dedup))
        try:
            reply = self.send(peer, req)
        except NetError:
            return
        if reply is None:
            return
        if isinstance(reply, AppendReply):
            if reply.term > self.term:
                self.become_follower(reply.term, None)
                return
            if reply.success:
                self.match_index[peer] = reply.match_index
                self.next_index[peer] = reply.match_index + 1

    def _advance_commit(self) -> None:
        if self.role != Role.LEADER:
            return
        for idx in range(self.last_index(), self.commit_index, -1):
            if self.term_at(idx) != self.term:
                break  # §5.4.2: only commit entries from the current term by counting
            votes = 1 + sum(1 for p, m in self.match_index.items() if m >= idx)
            if votes * 2 > len(self.peers):
                self.commit_index = idx
                break
        self._apply_committed()

    _last_apply_result: Any = None

    def _apply_committed(self) -> None:
        while self.applied < self.commit_index:
            self.applied += 1
            entry = self.entry_at(self.applied)
            client_id, seq, payload = entry.cmd
            if payload is None:
                continue            # leadership-change no-op: nothing to apply
            if client_id and (client_id, seq) in self.dedup:
                continue
            try:
                result = self.sm.apply(payload)
            except Exception as e:            # deterministic SM-level error
                result = SMError(e)
            self.applied_count += 1
            self._last_apply_result = result
            if client_id:
                self.dedup[(client_id, seq)] = result
        self.maybe_compact()

    # ---- log compaction (paper §2.1.3) ------------------------------------
    def maybe_compact(self) -> None:
        if self.applied - self.snap_index < COMPACT_THRESHOLD:
            return
        # snapshot state machine, truncate applied prefix
        keep_from = self.applied  # truncate everything applied
        n_drop = keep_from - self.snap_index
        self.snap_term = self.term_at(keep_from)
        self.log = self.log[n_drop:]
        self.snap_index = keep_from
        self._snapshot_cache = self.sm.snapshot()

    _snapshot_cache: Any = None

    # ---- message handling (follower side) ----------------------------------
    def handle(self, msg: Any) -> Any:
        if isinstance(msg, VoteReq):
            return self._on_vote(msg)
        if isinstance(msg, AppendReq):
            return self._on_append(msg)
        if isinstance(msg, SnapReq):
            return self._on_snapshot(msg)
        raise TypeError(type(msg))

    def _on_vote(self, req: VoteReq) -> VoteReply:
        if req.term < self.term:
            return VoteReply(self.term, False)
        if req.term > self.term:
            self.become_follower(req.term, None)
        up_to_date = (req.last_log_term, req.last_log_index) >= (
            self.term_at(self.last_index()), self.last_index())
        if up_to_date and self.voted_for in (None, req.candidate):
            self.voted_for = req.candidate
            self.election_elapsed = 0
            return VoteReply(self.term, True)
        return VoteReply(self.term, False)

    def _on_append(self, req: AppendReq) -> AppendReply:
        if req.term < self.term:
            return AppendReply(self.term, False, self.last_index())
        self.become_follower(req.term, req.leader)
        if req.prev_index > self.last_index() or (
            req.prev_index >= self.snap_index
            and self.term_at(req.prev_index) != req.prev_term
        ):
            # log mismatch — tell leader how far we actually match
            return AppendReply(self.term, False,
                               min(self.last_index(), max(self.snap_index,
                                                          req.prev_index - 1)))
        # append / overwrite conflicting suffix
        idx = req.prev_index
        for e in req.entries:
            idx += 1
            if idx <= self.snap_index:
                continue
            if idx <= self.last_index():
                if self.term_at(idx) != e.term:
                    self.log = self.log[: idx - self.snap_index - 1]
                    self.log.append(e)
            else:
                self.log.append(e)
        if req.commit > self.commit_index:
            self.commit_index = min(req.commit, self.last_index())
            self._apply_committed()
        return AppendReply(self.term, True, idx)

    def _on_snapshot(self, req: SnapReq) -> AppendReply:
        if req.term < self.term:
            return AppendReply(self.term, False, self.last_index())
        self.become_follower(req.term, req.leader)
        if req.last_included_index <= self.snap_index:
            return AppendReply(self.term, True, self.last_index())
        self.sm.restore(req.snapshot)
        self.dedup = dict(req.dedup)
        self.snap_index = req.last_included_index
        self.snap_term = req.last_included_term
        self.log = []
        self.commit_index = req.last_included_index
        self.applied = req.last_included_index
        return AppendReply(self.term, True, self.last_index())
