"""MultiRaft hosting + raft sets (paper §2.1.2, §2.5.1).

A production CFS node hosts *hundreds* of partitions, each its own raft group.
Naive raft would exchange one heartbeat per group per peer per tick.  MultiRaft
coalesces them: each node sends ONE beat message per peer per tick carrying the
(term, commit, last) tuple of every group it leads that is routed to that peer.

Raft sets (§2.5.1) bound heartbeat fan-out further: the resource manager only
ever co-locates a partition's replicas within one raft set, so a node
exchanges beats only with the nodes of its own set.  The placement logic lives
in ``resource_manager.py``; the per-pair message statistics that demonstrate
the reduction live in ``Network.stats.per_pair``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .raft import (AppendReply, AppendReq, RaftMember, Role, SnapReq,
                   StateMachine, VoteReq)
from .simnet import NetError, Network

__all__ = ["MultiRaftHost", "RaftCluster"]


@dataclass
class CoalescedBeat:
    """One message per (src node, dst node) per tick carrying all group beats."""
    # gid -> (term, commit_index, last_index, last_term)
    beats: Dict[str, Tuple[int, int, int, int]]


@dataclass
class CoalescedBeatReply:
    # gid -> (term, ok_and_matching, match_index)
    replies: Dict[str, Tuple[int, bool, int]]


class MultiRaftHost:
    """All raft group members hosted on one node."""

    def __init__(self, node_id: str, net: Network, registry: Dict[str, "MultiRaftHost"]):
        self.node_id = node_id
        self.net = net
        self.registry = registry
        self.groups: Dict[str, RaftMember] = {}
        registry[node_id] = self

    # ---- group management -------------------------------------------------
    def add_group(self, group_id: str, peers: List[str], sm: StateMachine) -> RaftMember:
        member = RaftMember(
            group_id, self.node_id, peers, sm,
            send=lambda dst, msg, gid=group_id: self._send(dst, msg),
            net=self.net,       # timed ops fan out the append legs
        )
        self.groups[group_id] = member
        return member

    def remove_group(self, group_id: str) -> None:
        self.groups.pop(group_id, None)

    def _send(self, dst: str, msg: Any) -> Any:
        nbytes = 256
        if isinstance(msg, AppendReq):
            nbytes = 128 + sum(64 + _payload_size(e.cmd) for e in msg.entries)
        elif isinstance(msg, SnapReq):
            nbytes = 1024
        return self.net.call(
            self.node_id, dst, self.registry[dst].deliver, msg,
            nbytes=nbytes, kind="raft",
        )

    def deliver(self, msg: Any) -> Any:
        if isinstance(msg, CoalescedBeat):
            return self._on_beat(msg)
        gid = msg.group
        member = self.groups.get(gid)
        if member is None:
            return None
        return member.handle(msg)

    # ---- coalesced heartbeats ----------------------------------------------
    _hb_phase: int = 0

    def tick(self) -> None:
        """Advance all timers; emit at most ONE beat message per peer node.

        The heartbeat phase is host-level (not per group): every group this
        node leads beats in the same message — that is the MultiRaft point.
        """
        self._hb_phase += 1
        beat_now = self._hb_phase >= 2  # HEARTBEAT_TICKS
        if beat_now:
            self._hb_phase = 0
        per_peer: Dict[str, Dict[str, Tuple[int, int, int, int]]] = {}
        for gid, m in self.groups.items():
            if m.role == Role.LEADER:
                if beat_now:
                    for peer in m.peers:
                        if peer == self.node_id:
                            continue
                        per_peer.setdefault(peer, {})[gid] = (
                            m.term, m.commit_index, m.last_index(),
                            m.term_at(m.last_index()),
                        )
            else:
                m.election_elapsed += 1
                if m.election_elapsed >= m.randomized_timeout:
                    m.start_election()
        for peer, beats in per_peer.items():
            try:
                reply: CoalescedBeatReply = self.net.call(
                    self.node_id, peer,
                    self.registry[peer].deliver, CoalescedBeat(beats),
                    nbytes=64 + 24 * len(beats), kind="raft.beat",
                )
            except NetError:
                continue
            if reply is None:
                continue
            self._handle_beat_reply(reply)

    def _on_beat(self, beat: CoalescedBeat) -> CoalescedBeatReply:
        replies: Dict[str, Tuple[int, bool, int]] = {}
        for gid, (term, commit, last_index, last_term) in beat.beats.items():
            m = self.groups.get(gid)
            if m is None:
                continue
            if term < m.term:
                replies[gid] = (m.term, False, m.last_index())
                continue
            leader = None  # unknown from beat; fine — hint only
            if term > m.term or m.role != Role.FOLLOWER:
                m.become_follower(term, leader)
            m.election_elapsed = 0
            matching = (m.last_index() == last_index
                        and m.term_at(last_index) == last_term)
            if matching and commit > m.commit_index:
                # safe: our log provably equals the leader's
                m.commit_index = min(commit, m.last_index())
                m._apply_committed()
            replies[gid] = (m.term, matching, m.last_index())
        return CoalescedBeatReply(replies)

    def _handle_beat_reply(self, reply: CoalescedBeatReply) -> None:
        for gid, (term, matching, match_index) in reply.replies.items():
            m = self.groups.get(gid)
            if m is None or m.role != Role.LEADER:
                continue
            if term > m.term:
                m.become_follower(term, None)
                continue
            if not matching:
                # follower is behind/diverged: run a real append round
                m.broadcast_append()

    # ---- convenience --------------------------------------------------------
    def leader_groups(self) -> List[str]:
        return [g for g, m in self.groups.items() if m.role == Role.LEADER]


def _payload_size(cmd: Any) -> int:
    try:
        _, _, payload = cmd
    except Exception:
        payload = cmd
    if isinstance(payload, (bytes, bytearray)):
        return len(payload)
    if isinstance(payload, tuple) and payload and isinstance(payload[-1], (bytes, bytearray)):
        return len(payload[-1]) + 64
    return 128


class RaftCluster:
    """Driver helper: owns the hosts of a simulated cluster and steps time."""

    def __init__(self, net: Network):
        self.net = net
        self.registry: Dict[str, MultiRaftHost] = {}

    def host(self, node_id: str) -> MultiRaftHost:
        if node_id not in self.registry:
            MultiRaftHost(node_id, self.net, self.registry)
        return self.registry[node_id]

    def add_group(self, group_id: str, node_ids: List[str],
                  sm_factory) -> Dict[str, RaftMember]:
        members = {}
        for nid in node_ids:
            members[nid] = self.host(nid).add_group(group_id, node_ids, sm_factory(nid))
        return members

    def tick_all(self, n: int = 1) -> None:
        for _ in range(n):
            for host in list(self.registry.values()):
                if host.node_id in self.net.dead_nodes:
                    continue
                host.tick()

    def elect(self, group_id: str, preferred: Optional[str] = None, max_ticks: int = 200) -> str:
        """Step ticks until the group has a leader; returns its node id.

        Groups created mid-run by the RM's timed split task cannot rely on
        driver ticks, so before falling back to the tick loop (which steps
        EVERY host's clock) each live member of the group gets one direct
        election attempt — a reachable quorum elects synchronously."""
        if preferred is not None:
            m = self.registry[preferred].groups[group_id]
            m.start_election()
            if m.role == Role.LEADER:
                return preferred
        for nid in sorted(self.registry):
            if nid == preferred or nid in self.net.dead_nodes:
                continue
            m = self.registry[nid].groups.get(group_id)
            if m is None:
                continue
            m.start_election()
            if m.role == Role.LEADER:
                return nid
        for _ in range(max_ticks):
            leader = self.leader_of(group_id)
            if leader is not None:
                return leader
            self.tick_all()
        raise TimeoutError(f"no leader for {group_id} after {max_ticks} ticks")

    def leader_of(self, group_id: str) -> Optional[str]:
        # stale leaders on the minority side of a partition also claim
        # leadership; only report a leader that can reach a quorum of its
        # peers (driver-level oracle), preferring the highest term.
        best: Optional[str] = None
        best_term = -1
        for nid, host in self.registry.items():
            if nid in self.net.dead_nodes:
                continue
            m = host.groups.get(group_id)
            if m is None or m.role != Role.LEADER or m.term <= best_term:
                continue
            reachable = 1
            for peer in m.peers:
                if peer == nid:
                    continue
                try:
                    self.net.check_reachable(nid, peer)
                    reachable += 1
                except Exception:
                    pass
            if reachable * 2 > len(m.peers):
                best, best_term = nid, m.term
        return best

    def member(self, group_id: str, node_id: str) -> RaftMember:
        return self.registry[node_id].groups[group_id]
