"""Drawn workloads through the reference's storage plane and the port's copy.

The sequences are drawn as ``tests/test_property_fs.py`` and
``tests/test_property_raft.py`` draw them, and the Ceph-like baseline's
mount ops with OSD joins, kills and revivals among them, derandomized (the
same examples on every run) and bounded; each runs in both packages and the
two trajectories must be equal (``torch_core_parity``).
"""

import pytest

pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import torch_core_parity as tp  # noqa: E402

NAMES = ["a", "b", "c", "d", "e"]

fs_op = st.one_of(
    st.tuples(st.just("write"), st.sampled_from(NAMES), st.binary(min_size=0, max_size=300)),
    st.tuples(st.just("append"), st.sampled_from(NAMES), st.binary(min_size=1, max_size=200)),
    st.tuples(st.just("overwrite"), st.sampled_from(NAMES), st.integers(0, 250),
              st.binary(min_size=1, max_size=64)),
    st.tuples(st.just("delete"), st.sampled_from(NAMES)),
    st.tuples(st.just("read"), st.sampled_from(NAMES)),
    st.tuples(st.just("stat"), st.sampled_from(NAMES)),
    st.tuples(st.just("rename"), st.sampled_from(NAMES), st.sampled_from(NAMES)),
    st.tuples(st.just("link"), st.sampled_from(NAMES), st.sampled_from(NAMES)),
)

N = len(tp.RAFT_NODES)
raft_event = st.one_of(
    st.tuples(st.just("tick"), st.integers(1, 8)),
    st.tuples(st.just("propose"), st.integers(0, 999)),
    st.tuples(st.just("kill"), st.integers(0, N - 1)),
    st.tuples(st.just("revive"), st.integers(0, N - 1)),
    st.tuples(st.just("partition"), st.integers(1, N - 1)),
    st.tuples(st.just("heal"), st.integers(0, 0)),
)

CEPH_NAMES = ["a", "b", "x", "x/a", "x/b"]
CEPH_OBJECT = 4 * 1024 * 1024
ceph_op = st.one_of(
    st.tuples(st.just("mkdir"), st.sampled_from(CEPH_NAMES)),
    st.tuples(st.just("create"), st.sampled_from(CEPH_NAMES)),
    st.tuples(st.just("write"), st.sampled_from(CEPH_NAMES),
              st.sampled_from([0, 1, 300, CEPH_OBJECT - 1, CEPH_OBJECT + 7]),
              st.integers(0, 255)),
    st.tuples(st.just("overwrite"), st.sampled_from(CEPH_NAMES),
              st.sampled_from([0, 5, 250, CEPH_OBJECT - 3]), st.binary(min_size=1, max_size=64)),
    st.tuples(st.just("read"), st.sampled_from(CEPH_NAMES)),
    st.tuples(st.just("read_range"), st.sampled_from(CEPH_NAMES),
              st.sampled_from([0, 7, CEPH_OBJECT - 5]), st.integers(0, 40)),
    st.tuples(st.just("stat"), st.sampled_from(CEPH_NAMES)),
    st.tuples(st.just("unlink"), st.sampled_from(CEPH_NAMES)),
    st.tuples(st.just("readdir"), st.sampled_from(["", "x"])),
    st.tuples(st.just("dir_stat"), st.sampled_from(["", "x"])),
    st.tuples(st.just("add_osd")),
    st.tuples(st.just("kill"), st.integers(0, 4)),
    st.tuples(st.just("revive"), st.integers(0, 4)),
)

DRAWN = settings(derandomize=True, database=None, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow])


@pytest.mark.parametrize("client_pick", [0, 1])
@settings(DRAWN, max_examples=12)
@given(ops=st.lists(fs_op, min_size=1, max_size=40))
def test_vfs_sequences_give_equal_trajectories(client_pick, ops):
    tp.both(tp.vfs_sequence, ops, client_pick)


@settings(DRAWN, max_examples=15)
@given(events=st.lists(raft_event, min_size=5, max_size=60))
def test_raft_under_faults_gives_equal_trajectories(events):
    rows = tp.both(tp.raft_events, events)
    leader = {label: out for label, out, _ in rows}["leader"]
    assert leader[1] is not None             # the healed group elects a leader


@settings(DRAWN, max_examples=12)
@given(ops=st.lists(ceph_op, min_size=1, max_size=30))
def test_ceph_like_sequences_give_equal_trajectories(ops):
    tp.both(tp.ceph_sequence, ops)
