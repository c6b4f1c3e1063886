"""One scripted workload through two copies of the CFS storage plane.

The reference's storage plane (``repro.core``, ``repro.cache``,
``repro.analysis``, and the Ceph-like comparison system of
``repro.baseline``) and the port's copy of it (``repro_torch.core``, ...)
are deterministic simulations on a virtual clock, so the same script must
give the same trajectory in both, bit for bit.  A scenario is a function of
a package namespace (``REF`` or ``PORT``, from :func:`package`) that drives
one cluster and returns its rows: every call's return value or exception,
the modeled time of the op it ran under (``OpTimer``: start, frontier,
messages, bytes, disk IOs), and at the end a fingerprint of the whole
cluster (every raft member, meta partition, extent store, disk, service
queue, client counter and RNG state) and its ``fsck`` report.
:func:`assert_same` compares two trajectories and names the first row
where they part.

Values are compared through :func:`norm`, which replaces each package's
classes by their names (the two packages' ``Inode`` are different classes
with the same fields), so the rows of the two packages compare equal
exactly when the two runs did the same thing.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import importlib
import random
from types import SimpleNamespace
from typing import Any, Callable, List, Optional

MODULES = ("analysis.knobs", "analysis.sanitizer", "core.types", "core.simnet",
           "core.raft", "core.multiraft", "core.btree", "core.extent_store",
           "core.meta_node", "core.meta_session", "core.data_node",
           "core.resource_manager", "cache.extent_cache", "core.client", "core.fs",
           "core.vfs", "core.fsck", "analysis.lint", "baseline.cephlike")


def package(root: str) -> SimpleNamespace:
    """The storage plane of ``root`` ("repro" or "repro_torch"): ``P.core``,
    ``P.cache``, ``P.analysis``, ``P.baseline`` and each module of
    :data:`MODULES` by its last name (``P.client``, ``P.fsck``,
    ``P.cephlike``, ...)."""
    ns = SimpleNamespace(root=root)
    for pkg in ("core", "cache", "analysis", "baseline"):
        setattr(ns, pkg, importlib.import_module(f"{root}.{pkg}"))
    for m in MODULES:
        setattr(ns, m.split(".")[1], importlib.import_module(f"{root}.{m}"))
    return ns


REF, PORT = package("repro"), package("repro_torch")


# ------------------------------------------------------------------ values

def norm(x: Any) -> Any:
    """``x`` as plain, comparable data; each package's own classes by name."""
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if isinstance(x, (bytearray, memoryview)):
        return bytes(x)
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, BaseException):
        return ("raise", type(x).__name__, getattr(x, "errno", None), str(x))
    if isinstance(x, random.Random):
        return ("Random", x.getstate())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return (type(x).__name__, tuple((norm(k), norm(v)) for k, v in x.items()))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted((norm(v) for v in x), key=repr)))
    if isinstance(x, (list, tuple, collections.deque)):
        return (type(x).__name__, tuple(norm(v) for v in x))
    if type(x).__name__ == "BTree":
        return ("BTree", tuple(norm(kv) for kv in x.items()))
    if callable(x):
        return ("callable", getattr(x, "__qualname__", type(x).__name__))
    return ("obj", type(x).__name__)


def state(obj: Any, skip=()) -> Any:
    """An object's attributes, normalised (objects it holds collapse to names)."""
    if hasattr(obj, "__dict__"):
        attrs = vars(obj)
    else:
        attrs = {k: getattr(obj, k) for cls in type(obj).__mro__
                 for k in getattr(cls, "__slots__", ()) if hasattr(obj, k)}
    return norm({k: v for k, v in attrs.items() if k not in skip})


# ------------------------------------------------------------------ recording

class Trace:
    """The rows of one run.  ``t(label, fn, *args)`` calls ``fn`` under an
    untimed op (costs add), ``t.at(us, label, fn, *args)`` under a timed op
    starting at virtual time ``us``, ``t.bare(label, fn, *args)`` under no op
    at all; each records the outcome and the op's modeled time."""

    def __init__(self, net=None):
        self.net = net
        self.rows: List[Any] = []

    def _run(self, label: str, fn: Callable, args, kw, at: Optional[float], mode: str):
        op = None
        if mode == "untimed":
            op = self.net.begin_op()
        elif mode == "timed":
            op = self.net.begin_op(at=at)
        try:
            out = fn(*args, **kw)
            row = ("ok", norm(out))
        except Exception as e:            # noqa: BLE001 -- the outcome is the datum
            out, row = e, norm(e)
        finally:
            if op is not None:
                self.net.end_op()
        timing = None if op is None else (op.start_us, op.now_us, op.msgs, op.bytes,
                                          op.disk_ops)
        self.rows.append((label, row, timing))
        return out

    def __call__(self, label: str, fn: Callable, *args, **kw):
        return self._run(label, fn, args, kw, None, "untimed")

    def at(self, us: float, label: str, fn: Callable, *args, **kw):
        return self._run(label, fn, args, kw, us, "timed")

    def bare(self, label: str, fn: Callable, *args, **kw):
        return self._run(label, fn, args, kw, None, "bare")

    def note(self, label: str, value: Any) -> None:
        self.rows.append((label, ("note", norm(value)), None))


def fingerprint(c, clients=()) -> Any:
    """Everything a cluster holds: raft members, meta partitions, extent
    stores, disks, service queues, network counters, RM state, and the
    given clients' counters and caches."""
    out = {"net": state(c.net, skip=("model",)),
           "rm": norm(c.rm.leader_sm().snapshot()) if c.rm.leader_id() else None,
           "raft": {nid: {gid: state(m) for gid, m in sorted(h.groups.items())}
                    for nid, h in sorted(c.rc.registry.items())},
           "resources": {k: state(r) for k, r in sorted(c.net.resources.items())},
           "meta": {nid: {pid: state(sm) for pid, sm in sorted(n.partitions.items())}
                    for nid, n in sorted(c.meta_nodes.items())},
           "data": {nid: {"disk": state(n.disk),
                          "parts": {pid: (state(r, skip=("store", "raft")), state(r.store))
                                    for pid, r in sorted(n.partitions.items())}}
                    for nid, n in sorted(c.data_nodes.items())},
           "clients": [(cl.stats, state(cl.session) if getattr(cl, "session", None) else None,
                        cl.read_affinity, cl.leader_cache) for cl in clients]}
    return norm(out)


def finish(t: Trace, P, c, volume: str, clients=()) -> List[Any]:
    """The trace's rows, then the cluster's fingerprint and fsck report."""
    t.note("fingerprint", fingerprint(c, clients))
    t.note("fsck", P.fsck.fsck(c, volume))
    return t.rows


def assert_same(ref_rows: List[Any], port_rows: List[Any]) -> None:
    for i, (a, b) in enumerate(zip(ref_rows, port_rows)):
        assert a == b, f"row {i} differs:\n  reference {a!r:.2000}\n  port      {b!r:.2000}"
    assert len(ref_rows) == len(port_rows), (len(ref_rows), len(port_rows))


# Process-wide counters of the storage plane: ``Network._created`` gives each
# network its serial (``net_serial``, which clients and the sanitizer key
# timelines by) and ``CfsClient._extent_counter`` is the tail of every
# extent id, so a process that ran more of one package before would give
# the two runs different serials and extent ids
COUNTERS = (("simnet", "Network", "_created"), ("client", "CfsClient", "_extent_counter"))


def align_serials() -> None:
    """Start both packages' process-wide counters at the same values (each
    moves only forward)."""
    for mod, cls, attr in COUNTERS:
        ref, port = (getattr(getattr(P, mod), cls) for P in (REF, PORT))
        n = max(getattr(ref, attr), getattr(port, attr))
        setattr(ref, attr, n)
        setattr(port, attr, n)


def both(scenario: Callable, *args, **kw) -> List[Any]:
    """Run ``scenario`` on both packages, assert equal trajectories, return the rows."""
    align_serials()
    ref_rows = scenario(REF, *args, **kw)
    port_rows = scenario(PORT, *args, **kw)
    assert_same(ref_rows, port_rows)
    return ref_rows


class sanitized:
    """Turn on ``P``'s sanitizer (a fresh instance) for a block, and restore
    the one that was active before."""

    def __init__(self, P):
        self.mod = P.sanitizer

    def __enter__(self):
        self.prev = self.mod.SAN
        return self.mod.enable()

    def __exit__(self, *exc):
        self.mod.SAN = self.prev


# ------------------------------------------------------------------ helpers

def _creat(P, vfs, path: str, data: bytes = b"") -> int:
    fd = vfs.open(path, P.core.O_WRONLY | P.core.O_CREAT | P.core.O_TRUNC)
    if data:
        vfs.pwrite(fd, data, 0)
    vfs.close(fd)
    return len(data)


def _read_all(P, vfs, path: str) -> bytes:
    fd = vfs.open(path, P.core.O_RDONLY)
    try:
        return vfs.read(fd, -1)
    finally:
        vfs.close(fd)


# ------------------------------------------------------------------ scenarios

def quickstart(P) -> List[Any]:
    """``examples/quickstart.py``'s sequence."""
    C = P.core
    c = C.CfsCluster(n_meta=4, n_data=6, extent_max_size=1024 * 1024)
    c.create_volume("vol1", n_meta_partitions=3, n_data_partitions=8)
    v1, v2 = c.mount("vol1").vfs, c.mount("vol1").vfs
    t = Trace(c.net)
    t("config", _creat, P, v1, "/config.json", b'{"replicas": 3}')
    t("mkdir", v1.mkdir, "/logs")
    t("log", _creat, P, v1, "/logs/app.log", b"line\n" * 100_000)
    t("readdir", v2.readdir, "/")
    t("read config", _read_all, P, v2, "/config.json")
    t("stat log", v2.stat, "/logs/app.log")
    t("excl", v2.open, "/config.json", C.O_WRONLY | C.O_CREAT | C.O_EXCL)
    fd = t("open rdwr", v2.open, "/logs/app.log", C.O_RDWR)
    t("pwrite head", v2.pwrite, fd, b"HEAD\n", 0)
    t("close", v2.close, fd)
    fd = t("open append", v2.open, "/logs/app.log", C.O_WRONLY | C.O_APPEND)
    t("pwrite tail", v2.pwrite, fd, b"TAIL\n", 0)
    t("close", v2.close, fd)
    fd = t("open rdonly", v1.open, "/logs/app.log", C.O_RDONLY)
    t("pread head", v1.pread, fd, 5, 0)
    size = t("fstat", v1.fstat, fd)["size"]
    t("lseek", v1.lseek, fd, size - 5)
    t("read tail", v1.read, fd, 5)
    t("close", v1.close, fd)
    fd = t("open trunc", v1.open, "/logs/app.log", C.O_RDWR)
    t("ftruncate", v1.ftruncate, fd, 1024)
    t("close", v1.close, fd)
    t("stat truncated", v1.stat, "/logs/app.log")
    t("tick", c.tick, 1)
    t("statfs", v1.statfs)
    t("client_view", c.rm.client_view, "vol1")
    t.note("stats", v1.client.stats)
    t("add data node", lambda: c.add_data_node().node_id)
    t("tick", c.tick, 2)
    t.note("used", {n: d.disk.used for n, d in c.data_nodes.items()})
    t("background", c.run_background_tasks)
    return finish(t, P, c, "vol1", [v1.client, v2.client])


def failover(P) -> List[Any]:
    """``examples/failover_demo.py``: a data backup killed mid-write, its
    recovery, a meta-partition leader killed, the RM leader killed."""
    C = P.core
    c = C.CfsCluster(n_meta=4, n_data=8, extent_max_size=1024 * 1024, seed=3)
    c.create_volume("v", n_meta_partitions=3, n_data_partitions=6)
    vfs = c.mount("v").vfs
    t = Trace(c.net)
    fd = t("open big", vfs.open, "/big.bin", C.O_WRONLY | C.O_CREAT | C.O_TRUNC)
    t("write A", vfs.pwrite, fd, b"A" * (512 * 1024), 0)
    t("fsync", vfs.fsync, fd)
    victim = vfs.client._dp(vfs.handle(fd)._extents[0].partition_id).replicas[1]
    t.note("victim", victim)
    t("kill data", c.kill_node, victim)
    t("write B", vfs.pwrite, fd, b"B" * (512 * 1024), 512 * 1024)
    t("close", vfs.close, fd)
    t("read back", _read_all, P, vfs, "/big.bin")
    t("recover", c.recover_data_node, victim)
    gid = f"mp{vfs.client.meta_partitions[0].pid}"
    leader = c.rc.leader_of(gid)
    t.note("meta leader", leader)
    t("kill meta leader", c.kill_node, leader)
    t("elections", c.rc.tick_all, 40)
    t.note("new meta leader", c.rc.leader_of(gid))
    v2 = c.mount("v").vfs
    t("after failover", _creat, P, v2, "/after_failover.txt", b"still alive")
    t("read after failover", _read_all, P, v2, "/after_failover.txt")
    rm_leader = c.rm.leader_id()
    t.note("rm leader", rm_leader)
    t("kill rm leader", c.kill_node, rm_leader)
    t("elect rm", c.rc.elect, "rm")
    v3 = c.mount("v").vfs
    t("rm failover", _creat, P, v3, "/rm_failover.txt", b"ok")
    t("readdir", v3.readdir, "/")
    return finish(t, P, c, "v", [vfs.client, v2.client, v3.client])


def vfs_sequence(P, ops, client_pick: int) -> List[Any]:
    """A sequence of ops as ``tests/test_property_fs.py`` draws them, on two
    mounts of one volume; every odd op runs timed (the leased paths), every
    even op untimed."""
    c = P.core.CfsCluster(n_meta=3, n_data=4, extent_max_size=1024 * 1024)
    c.create_volume("pv", n_meta_partitions=2, n_data_partitions=4)
    mounts = [c.mount("pv"), c.mount("pv")]
    t = Trace(c.net)

    def append(mnt, name, data):
        f = mnt.open(name, "a")
        f.write(data)
        f.close()

    def overwrite(mnt, name, off, data):
        f = mnt.open(name, "r+")
        f.seek(off)
        f.write(data)
        f.close()

    for i, op in enumerate(ops):
        mnt = mounts[(client_pick + i) % 2]
        kind, name = op[0], "/" + op[1]
        call = {"write": lambda: mnt.write_file(name, op[2]),
                "append": lambda: append(mnt, name, op[2]),
                "overwrite": lambda: overwrite(mnt, name, op[2], op[3]),
                "delete": lambda: mnt.unlink(name),
                "read": lambda: mnt.read_file(name),
                "stat": lambda: mnt.stat(name),
                "rename": lambda: mnt.rename(name, "/" + op[2]),
                "link": lambda: mnt.link(name, "/" + op[2])}[kind]
        if i % 2:
            t.at(1_000.0 * i, repr(op), call)
        else:
            t(repr(op), call)
    for j, mnt in enumerate(mounts):
        t(f"readdir {j}", lambda: sorted(mnt.readdir("/")))
        for name in sorted(mnt.readdir("/")):
            t(f"read {j} {name}", mnt.read_file, "/" + name)
            t(f"stat {j} {name}", mnt.stat, "/" + name)
    return finish(t, P, c, "pv", [m.client for m in mounts])


RAFT_NODES = [f"n{i}" for i in range(5)]


def raft_events(P, events) -> List[Any]:
    """A raft group of five under kills, revivals, partitions, heals, ticks
    and proposals, as ``tests/test_property_raft.py`` draws them; after each
    event every member's role, term, commit and applied index, and at the
    end the healed group's convergence."""

    class LogSM(P.raft.StateMachine):
        def __init__(self):
            self.log = []

        def apply(self, payload):
            self.log.append(payload)
            return len(self.log)

        def snapshot(self):
            return list(self.log)

        def restore(self, snap):
            self.log = list(snap)

    net = P.simnet.Network(seed=1)
    rc = P.multiraft.RaftCluster(net)
    rc.add_group("g", RAFT_NODES, lambda nid: LogSM())
    t = Trace(net)
    n = len(RAFT_NODES)
    seq = 0

    def members():
        return [(m.role, m.term, m.leader_id, m.commit_index, m.applied,
                 len(m.log), m.sm.log[: m.applied])
                for m in (rc.member("g", nid) for nid in RAFT_NODES)]

    for kind, arg in events:
        if kind == "tick":
            t(f"tick {arg}", rc.tick_all, arg)
        elif kind == "propose":
            leader = rc.leader_of("g")
            if leader is not None:
                seq += 1
                t(f"propose {arg}", rc.member("g", leader).propose, ("cmd", arg),
                  client_id="prop", seq=seq)
        elif kind == "kill":
            if len(net.dead_nodes) < n // 2:
                net.kill(RAFT_NODES[arg])
        elif kind == "revive":
            net.revive(RAFT_NODES[arg])
        elif kind == "partition":
            net.partition(RAFT_NODES[:arg], RAFT_NODES[arg:])
        elif kind == "heal":
            net.heal()
        t.note(f"{kind} {arg}", members())
    net.heal()
    for nid in sorted(net.dead_nodes):
        net.revive(nid)
    t("converge", rc.tick_all, 60)
    leader = rc.leader_of("g")
    t.note("leader", leader)
    if leader is not None:
        t("final propose", rc.member("g", leader).propose, ("final", 0),
          client_id="prop", seq=10_000)
    t("settle", rc.tick_all, 10)
    t.note("members", members())
    t.note("groups", {nid: {gid: state(m) for gid, m in h.groups.items()}
                      for nid, h in sorted(rc.registry.items())})
    t.note("net", state(net, skip=("model",)))
    return t.rows


def _timed_control_tick(c, at: float):
    op = c.net.begin_op(at=at)
    try:
        c.control_tick()
    finally:
        c.net.end_op()
    return op.now_us


def meta_split(P) -> List[Any]:
    """Meta partitions split on capacity (``tests/test_elastic_meta.py``):
    a create storm with timed control rounds auto-splits near-full
    partitions; a meta node joins and a forced split places the sibling on
    it; a stale client's mutation follows the WrongRange hint once."""
    c = P.core.CfsCluster(n_meta=4, n_data=4, extent_max_size=1024 * 1024,
                          meta_max_entries=24, seed=7)
    c.create_volume("v", n_meta_partitions=1, n_data_partitions=3)
    m = c.mount("v")
    stale = c.mount("v")
    t = Trace(c.net)
    t("stale sync", stale.client.sync_partitions, force=True)
    t("mkdir", m.mkdir, "/d")
    clock = 0.0
    for i in range(30):
        t(f"write f{i}", m.write_file, f"/d/f{i}", bytes([i]) * (64 + i))
        if i % 5 == 4:
            clock += 1_000.0
            t(f"control {clock}", _timed_control_tick, c, clock)
    t.note("split log", c.rm.split_log)
    t("add meta node", lambda: c.add_meta_node().node_id)
    clock += 1_000.0
    t("control after join", _timed_control_tick, c, clock)
    sm = c.rm.leader_sm()
    pid = max(sm.volumes["v"]["meta"])
    leader = c.rc.leader_of(f"mp{pid}") or sm.partitions[pid].replicas[0]
    part = c.meta_nodes[leader].partitions[pid]
    new_pid = t("force split", c.rm.split_meta_partition, "v", pid,
                max_inode_id=part.max_inode_id)
    t.note("sibling replicas", sm.partitions[new_pid].replicas if new_pid in sm.partitions
           else None)
    fresh = c.mount("v")
    fresh.client.coalesce_meta = False
    for i in range(12):
        t(f"fresh write y{i}", fresh.write_file, f"/d/y{i}", b"y" * 32)
        t(f"fresh ino y{i}", fresh.path_inode, f"/d/y{i}")
    t("stale readdir", lambda: sorted(stale.readdir("/d")))
    for i in range(0, 30, 7):
        t.at(50_000.0 + i, f"stale read f{i}", stale.read_file, f"/d/f{i}")
        t(f"stale unlink f{i}", stale.unlink, f"/d/f{i}")
    t.note("stale stats", stale.client.stats)
    return finish(t, P, c, "v", [m.client, stale.client, fresh.client])


def meta_sessions(P) -> List[Any]:
    """Lease-served metadata (``tests/test_meta_sessions.py``): a writer and
    a reader on timed ops at chosen virtual times, inside and past the
    lease TTL, with negative dentries, unlinks and renames."""
    C = P.core
    c = C.CfsCluster(n_meta=3, n_data=4, extent_max_size=8 * 1024 * 1024, seed=42)
    c.create_volume("v", n_meta_partitions=3, n_data_partitions=4, replicas=3)
    w = c.mount("v", client_id="w").vfs
    r = c.mount("v", client_id="r").vfs
    ttl = P.meta_session.META_TTL_US
    t = Trace(c.net)
    t.note("ttl", (ttl, P.meta_session.META_NEG_TTL_US))
    t.at(0.0, "mkdir", w.mkdir, "/s")
    for i in range(6):
        t.at(10.0 * i, f"create f{i}", _creat, P, w, f"/s/f{i}", b"x" * (100 * i))
    clock = 100.0
    for rnd in range(3):
        for i in range(6):
            t.at(clock, f"r stat f{i} round {rnd}", r.stat, f"/s/f{i}")
            clock += 5.0
        t.at(clock, f"r readdir {rnd}", r.readdir, "/s")
        t.at(clock, f"r readdir_plus {rnd}", r.readdir_plus, "/s")
        t.at(clock, f"r stat missing {rnd}", r.stat, "/s/missing")
        t.at(clock, f"w unlink f{rnd}", w.unlink, f"/s/f{rnd}")
        t.at(clock, f"w rename f{rnd + 3}", w.rename, f"/s/f{rnd + 3}", f"/s/g{rnd}")
        t.at(clock, f"w create missing {rnd}", _creat, P, w, "/s/missing", b"m" * rnd)
        t.at(clock + 1.0, f"r open f{rnd + 3} (renamed)", r.open, f"/s/f{rnd + 3}",
             C.O_RDONLY)
        clock += ttl * 0.6 if rnd == 0 else ttl * 1.5
    t.at(clock, "w unlink missing", w.unlink, "/s/missing")
    t.at(clock, "r rmdir through stale listing", r.rmdir, "/s")
    t("r untimed stat", r.stat, "/s/g0")
    t.note("r stats", r.client.stats)
    t.note("w stats", w.client.stats)
    return finish(t, P, c, "v", [w.client, r.client])


def meta_async_crash(P) -> List[Any]:
    """Async metadata commits (``tests/test_meta_async.py``) with a crash mid
    burst: a timed mkdir burst on the early-ack journal path, the meta
    partition's leader killed halfway, the burst carried on, elections, then
    the durability barriers (dir fsync, file close)."""
    C = P.core
    c = C.CfsCluster(n_meta=4, n_data=4, seed=11)
    c.create_volume("v", n_meta_partitions=2, n_data_partitions=4)
    mnt = c.mount("v")
    mnt.client.meta_async = True
    mnt.client.meta_journal_depth = 4
    vfs = mnt.vfs
    t = Trace(c.net)
    t.at(0.0, "mkdir", mnt.mkdir, "/b")
    pid = mnt.client._mp_for_inode(mnt.stat("/b")["inode"]).pid
    leader = c.rc.leader_of(f"mp{pid}")
    t.note("partition, leader", (pid, leader))
    op = c.net.begin_op(at=100.0)
    try:
        for i in range(10):
            if i == 5:
                t.bare("kill leader", c.kill_node, leader)
            t.bare(f"burst mkdir c{i}", mnt.mkdir, f"/b/c{i}")
            t.note(f"frontier {i}", (op.now_us, mnt.client.stats["meta_async_acks"],
                                     mnt.client.stats["meta_async_stalls"]))
    finally:
        c.net.end_op()
    t("elections", c.rc.tick_all, 40)
    t.note("new leader", c.rc.leader_of(f"mp{pid}"))
    t.at(50_000.0, "drain", mnt.client.drain_meta_window, pid)
    fd = t.at(60_000.0, "open dir", vfs.open, "/b", C.O_RDONLY)
    t.at(60_000.0, "fsync dir", vfs.fsync, fd)
    t.at(60_000.0, "close dir", vfs.close, fd)
    t.at(70_000.0, "write file", mnt.write_file, "/b/f.bin", b"z" * 4096)
    t("revive", c.revive_node, leader)
    t("catch up", c.rc.tick_all, 20)
    t("readdir", lambda: sorted(mnt.readdir("/b")))
    t.note("stats", mnt.client.stats)
    return finish(t, P, c, "v", [mnt.client])


def extent_cache(P) -> List[Any]:
    """The tiered client extent cache (``tests/test_extent_cache.py``): a
    cold pass, a RAM-hot pass, demotion to the simulated SSD under RAM
    pressure, budget eviction, and invalidation by overwrite, truncate and
    unlink."""
    C = P.core
    pkt = P.types.PACKET_SIZE
    c = C.CfsCluster(n_meta=3, n_data=3, extent_max_size=8 * 1024 * 1024, seed=42)
    c.create_volume("v", n_meta_partitions=3, n_data_partitions=4)
    vfs = c.mount("v", client_id="c0").vfs
    cache = P.extent_cache.TieredExtentCache("c0", c.net, "v", 4 * pkt, 6 * pkt)
    vfs.client.data_cache = cache
    t = Trace(c.net)
    files = {f"/f{i}": bytes([65 + i]) * (3 * pkt + 100 * i) for i in range(3)}
    for path, data in files.items():
        t(f"write {path}", _creat, P, vfs, path, data)
    clock = 0.0

    def pread(path, size, off=0):
        fd = vfs.open(path, C.O_RDONLY)
        try:
            return vfs.pread(fd, size, off)
        finally:
            vfs.close(fd)

    for rnd in range(3):
        for path, data in files.items():
            t.at(clock, f"pread {path} round {rnd}", pread, path, len(data))
            clock += 10_000.0
            t.note(f"cache after {path} {rnd}", state(cache, skip=("net",)))
    t.at(clock, "partial pread", pread, "/f0", 1000, pkt - 10)
    fd = t.at(clock, "open rdwr", vfs.open, "/f1", C.O_RDWR)
    t.at(clock, "overwrite", vfs.pwrite, fd, b"Q" * 500, 10)
    t.at(clock, "truncate", vfs.ftruncate, fd, pkt + 7)
    t.at(clock, "close", vfs.close, fd)
    clock += 10_000.0
    t.at(clock, "pread after overwrite", pread, "/f1", 2 * pkt)
    t.at(clock, "unlink", vfs.unlink, "/f2")
    t.at(clock, "recreate", _creat, P, vfs, "/f2", b"new")
    t.at(clock + 1.0, "pread recreated", pread, "/f2", 10)
    t("untimed pread", pread, "/f0", 2 * pkt)
    t.note("cache", state(cache, skip=("net",)))
    t.note("stats", vfs.client.stats)
    return finish(t, P, c, "v", [vfs.client])


def multi_client(P, n_clients: int = 3, n_streams: int = 2, n_files: int = 5) -> List[Any]:
    """A timed create/stat/unlink run: each client runs ``n_streams``
    streams on the event scheduler; each stream creates, stats and unlinks
    its files, one op after another, an op dispatched when the last one
    completes.  Rows: each op's stream, start and completion times and
    outcome, in the scheduler's firing order."""
    C = P.core
    c = C.CfsCluster(n_meta=3, n_data=3, extent_max_size=1024 * 1024, seed=42)
    c.create_volume("v", n_meta_partitions=3, n_data_partitions=4)
    vfs = [c.mount("v", client_id=f"c{i}").vfs for i in range(n_clients)]
    sched = P.simnet.EventScheduler()
    t = Trace(c.net)
    t.at(0.0, "mkdir", vfs[0].mkdir, "/m")

    def stream_ops(v, name):
        for i in range(n_files):
            path = f"/m/{name}_{i}"
            yield f"create {path}", lambda p=path: _creat(P, v, p, b"x" * (512 * (i + 1)))
            yield f"stat {path}", lambda p=path: v.stat(p)
        for i in range(0, n_files, 2):
            yield f"unlink /m/{name}_{i}", lambda p=f"/m/{name}_{i}": v.unlink(p)
        yield f"readdir {name}", lambda: len(v.readdir("/m"))

    def dispatch(at, name, it):
        step = next(it, None)
        if step is None:
            return
        label, fn = step
        op = c.net.begin_op(at=at, tenant=("v", name))
        try:
            out = ("ok", norm(fn()))
        except Exception as e:      # noqa: BLE001
            out = norm(e)
        finally:
            c.net.end_op()
        t.rows.append((f"{name} {label}", out, (at, op.now_us, op.msgs, op.bytes,
                                                op.disk_ops)))
        sched.at(op.now_us, dispatch, name, it)

    for ci, v in enumerate(vfs):
        for si in range(n_streams):
            name = f"c{ci}s{si}"
            sched.at(1_000.0 + 3.0 * si, dispatch, name, stream_ops(v, name))
    t.note("makespan", sched.run())
    return finish(t, P, c, "v", [v.client for v in vfs])


def racy(P) -> List[Any]:
    """Under the sanitizer: a legitimate timed write and read, then two
    un-joined fork branches appending the same range of one extent through
    the real PB chain, which must raise ``HBViolation`` at the second
    append, then a clean run again."""
    C = P.core
    with sanitized(P) as san:
        c = C.CfsCluster(n_meta=3, n_data=4, extent_max_size=8 * 1024 * 1024, seed=42)
        c.create_volume("v", n_meta_partitions=3, n_data_partitions=4)
        vfs = c.mount("v", client_id="c0").vfs
        pkt = P.types.PACKET_SIZE
        t = Trace(c.net)
        payload = bytes(range(256)) * (2 * pkt // 256)
        t.at(0.0, "clean write", _creat, P, vfs, "/clean.bin", payload)
        t.at(20_000.0, "clean read", _read_all, P, vfs, "/clean.bin")
        t("racy file", _creat, P, vfs, "/racy.bin", bytes(pkt))
        pid, eid = vfs.stat("/racy.bin")["extents"][0][:2]
        leader = c.data_nodes[vfs.client._dp(pid).replicas[0]]
        tail = leader.partitions[pid].store.get(eid).size
        op = c.net.begin_op(at=0.0)
        try:
            fork = op.fork()
            t.bare("branch 0 append", leader.serve_append, pid, eid, tail, b"A" * 64)
            fork.branch_done()
            t.bare("branch 1 append", leader.serve_append, pid, eid, tail, b"B" * 64)
        finally:
            c.net.end_op()
        t.note("violations", san.violations)
        t.at(10_000.0, "later write", _creat, P, vfs, "/later.bin", b"L" * 1000)
        t.note("violations after", san.violations)
        return finish(t, P, c, "v", [vfs.client])


# ------------------------------------------------------------------ the Ceph-like baseline

def ceph_fingerprint(c) -> Any:
    """Everything a Ceph-like cluster holds: each MDS's dentries, inodes,
    cache keys in order and disk counters, each OSD's objects and disk, the
    placement state, and the network's counters and service queues."""
    return norm({"net": state(c.net, skip=("model",)),
                 "resources": {k: state(r) for k, r in sorted(c.net.resources.items())},
                 "mds": [(m.node_id, m.dentries, m.inodes, list(m.cache), m.cache_entries,
                          state(m.disk)) for m in c.mds],
                 "osds": [(o.node_id, o.objects, state(o.disk)) for o in c.osds],
                 "migrated_bytes": c.migrated_bytes, "fragmented": c.fragmented,
                 "next_ino": c._next_ino, "replicas": c.replicas})


def ceph_finish(t: Trace, c) -> List[Any]:
    t.note("fingerprint", ceph_fingerprint(c))
    return t.rows


def tree_paths(root: str, depth: int, branch: int = 2) -> List[str]:
    """mdtest's tree below ``root``, parents before children
    (``benchmarks/mdtest.py``'s ``tree_paths``)."""
    paths, frontier = [], [root]
    for _ in range(depth):
        frontier = [f"{p}/t{b}" for p in frontier for b in range(branch)]
        paths += frontier
    return paths


def ceph_metadata(P) -> List[Any]:
    """The paper's seven metadata operations as ``benchmarks/mdtest.py``
    spells them for the Ceph-like system (DirCreation, DirStat, DirRemoval,
    FileCreation through ``write_file``, FileRemoval, TreeCreation,
    TreeRemoval), timed and untimed, with ``Exists`` and ``NotFound``."""
    B = P.cephlike
    c = B.CephLikeCluster(n_mds=4, n_osd=4, seed=42, mds_cache_entries=3000)
    m = B.CephLikeMount(c, "c0")
    t = Trace(c.net)
    t.at(0.0, "mkdir base", m.mkdir, "/md")
    clock = 100.0
    for i in range(8):
        t.at(clock, f"mkdir d{i}", m.mkdir, f"/md/d{i}")
        clock += 40.0
    t("mkdir exists", m.mkdir, "/md/d3")
    t("mkdir under missing", m.mkdir, "/md/nope/x")
    t.at(clock, "mkdir statdir", m.mkdir, "/md/s")
    for i in range(16):
        t(f"creat f{i}", m.write_file, f"/md/s/f{i}", b"")
    t("create file", m._create_file, "/md/s/g")
    t("create exists", m._create_file, "/md/s/g")
    for k in range(2):
        t.at(clock, f"dir_stat {k}", m.dir_stat, "/md/s")
        t(f"dir_stat untimed {k}", m.dir_stat, "/md/s")
        clock += 500.0
    t("readdir", m.readdir, "/md")
    t("readdir root", m.readdir, "/")
    t.at(clock, "stat f3", m.stat, "/md/s/f3")
    t("stat missing", m.stat, "/md/s/nope")
    t("read empty", m.read_file, "/md/s/f5")
    t("unlink missing", m.unlink, "/md/s/nope")
    for i in range(8):
        t.at(clock, f"rmdir d{i}", m.rmdir, f"/md/d{i}")
        clock += 40.0
    t("rmdir again", m.rmdir, "/md/d0")
    for i in range(16):
        t(f"unlink f{i}", m.unlink, f"/md/s/f{i}")
    paths = ["/md/tree"] + tree_paths("/md/tree", 3)
    for p in paths:
        t.at(clock, f"tree mkdir {p}", m.mkdir, p)
        clock += 25.0
    t("tree readdir", m.readdir, "/md/tree/t1")
    for p in sorted(paths, key=lambda p: -p.count("/")):
        t.at(clock, f"tree rmdir {p}", m.rmdir, p)
        clock += 25.0
    t("readdir after", m.readdir, "/md")
    t("dir_stat after", m.dir_stat, "/md/s")
    return ceph_finish(t, c)


def ceph_large_file(P) -> List[Any]:
    """A 9 MiB file in three 4 MiB stripes: a read across a stripe border,
    a read-modify-write overwrite across it, the whole file read back, and
    an unlink that deletes every stripe of every replica."""
    B = P.cephlike
    c = B.CephLikeCluster(n_mds=3, n_osd=5, seed=3)
    m = B.CephLikeMount(c, "c0")
    t = Trace(c.net)
    data = bytes(range(256)) * (9 * 1024 * 1024 // 256)
    t.at(0.0, "mkdir", m.mkdir, "/big")
    t.at(10.0, "write", m.write_file, "/big/f", data)
    ino = m.stat("/big/f")["inode"]
    t.note("stripes", [(o.node_id, sorted(k for k in o.objects)) for o in c.osds])
    border = B.OBJECT_SIZE
    t.at(50_000.0, "read across", m.read_range, "/big/f", border - 100, 300)
    t("read tail", m.read_range, "/big/f", 2 * border, 1000)
    t.at(60_000.0, "overwrite across", m.overwrite, "/big/f", border - 50, b"Z" * 100)
    t("overwrite untimed", m.overwrite, "/big/f", 10, b"Y" * 10)
    t("read across again", m.read_range, "/big/f", border - 60, 120)
    t.at(70_000.0, "read whole", m.read_file, "/big/f")
    t("stat", m.stat, "/big/f")
    t.at(80_000.0, "unlink", m.unlink, "/big/f")
    t.note("objects left", [len(o.objects) for o in c.osds])
    t.note("crush", [[o.node_id for o in c.crush(ino, s)] for s in range(3)])
    t("read gone", m.read_file, "/big/f")
    return ceph_finish(t, c)


def ceph_add_osd(P) -> List[Any]:
    """Capacity expansion by rebalancing: OSDs join with objects present,
    with no op, under an untimed op and under a timed op (backfill queued
    on the OSDs' disks); every file reads back after each join."""
    B = P.cephlike
    c = B.CephLikeCluster(n_mds=2, n_osd=4, seed=5)
    m = B.CephLikeMount(c, "c0")
    t = Trace(c.net)
    files = {f"/f{i}": bytes([i + 1]) * (B.OBJECT_SIZE // 2 * (i % 3) + 1000 * i + 1)
             for i in range(8)}
    for k, (path, data) in enumerate(files.items()):
        t.at(100.0 * k, f"write {path}", m.write_file, path, data)
    for how in ("bare", "untimed", "timed"):
        call = {"bare": t.bare, "untimed": t,
                "timed": lambda *a: t.at(200_000.0, *a)}[how]
        call(f"add_osd {how}", c.add_osd)
        t.note(f"migrated after {how}", c.migrated_bytes)
        t.note(f"snapshot after {how}", c.crush_snapshot())
        for path in files:
            t(f"read {path} after {how}", m.read_file, path)
    return ceph_finish(t, c)


def ceph_small_cache(P) -> List[Any]:
    """An MDS cache of 8 entries: creates and stats evict a quarter of it
    at a time, and lookups that miss read the MDS's disk."""
    B = P.cephlike
    c = B.CephLikeCluster(n_mds=3, n_osd=4, seed=9, mds_cache_entries=8)
    m = B.CephLikeMount(c, "c0")
    t = Trace(c.net)
    t.at(0.0, "mkdir a", m.mkdir, "/a")
    t.at(0.0, "mkdir b", m.mkdir, "/b")
    for i in range(15):
        t.at(10.0 * i, f"create a/{i}", m.write_file, f"/a/{i}", b"x" * i)
        t(f"create b/{i}", m._create_file, f"/b/{i}")
        t.note(f"cache sizes {i}", [len(s.cache) for s in c.mds])
    for rnd in range(2):
        for i in range(0, 15, 2):
            t.at(5_000.0 + 100.0 * i, f"stat a/{i} {rnd}", m.stat, f"/a/{i}")
            t(f"read a/{i} {rnd}", m.read_file, f"/a/{i}")
        t.at(9_000.0, f"dir_stat b {rnd}", m.dir_stat, "/b")
        t.note(f"disk reads {rnd}", [s.disk.reads for s in c.mds])
    return ceph_finish(t, c)


def ceph_dead_osd(P) -> List[Any]:
    """An OSD killed: the unlink's delete to it fails and is swallowed,
    leaving its copy behind; a write whose primary is down raises; after a
    revive the survivors read back."""
    B = P.cephlike
    c = B.CephLikeCluster(n_mds=2, n_osd=5, seed=11)
    m = B.CephLikeMount(c, "c0")
    t = Trace(c.net)
    for i in range(4):
        t.at(100.0 * i, f"write f{i}", m.write_file, f"/f{i}",
             bytes([65 + i]) * (B.OBJECT_SIZE + 500 * i))
    inos = {i: m.stat(f"/f{i}")["inode"] for i in range(4)}
    replica = c.crush(inos[0], 0)[1]
    t.note("victim", replica.node_id)
    t("kill replica", c.net.kill, replica.node_id)
    t.at(10_000.0, "unlink f0", m.unlink, "/f0")
    t.note("left on victim", sorted(replica.objects))
    primary = c.crush(inos[1], 0)[0]
    t("kill primary", c.net.kill, primary.node_id)
    t("unlink f1", m.unlink, "/f1")
    t.at(20_000.0, "rewrite f2", m.write_file, "/f2", b"new")
    t("read f3", m.read_file, "/f3")
    t("revive", c.net.revive, primary.node_id)
    t("revive replica", c.net.revive, replica.node_id)
    for i in (2, 3):
        t.at(30_000.0, f"read f{i}", m.read_file, f"/f{i}")
    t("unlink f2", m.unlink, "/f2")
    return ceph_finish(t, c)


def ceph_fragment(P) -> List[Any]:
    """A directory past ``FRAGMENT_THRESHOLD`` children fragments: later
    entries go to the MDS their name hashes to, through the directory's
    authority (the proxy hop).  Entries made before the split stay where
    they were, so a later lookup of one can reach the wrong MDS and raise
    ``NotFound`` (the reference's behaviour, kept)."""
    B = P.cephlike
    c = B.CephLikeCluster(n_mds=4, n_osd=4, seed=0)
    m = B.CephLikeMount(c, "c0")
    t = Trace(c.net)
    n = B.FRAGMENT_THRESHOLD
    t("mkdir", m.mkdir, "/d")
    t("create below threshold", lambda: [m._create_file(f"/d/f{i}") for i in range(n)])
    t.note("fragmented below", c.fragmented)
    t.note("proxy hops below", c.net.stats.per_kind.get("ceph.proxy", 0))
    for i in range(n, n + 3):
        t(f"create f{i}", m._create_file, f"/d/f{i}")
        t.note(f"fragmented after f{i}", c.fragmented)
    for i in range(4):
        t.at(1_000.0 * i, f"create new n{i}", m._create_file, f"/d/n{i}")
        t.at(1_000.0 * i + 500.0, f"stat new n{i}", m.stat, f"/d/n{i}")
    t.note("proxy hops", c.net.stats.per_kind.get("ceph.proxy", 0))
    t.at(10_000.0, "write new", m.write_file, "/d/w", b"w" * 10)
    t("read new", m.read_file, "/d/w")
    for i in range(8):
        t(f"stat old f{i}", m.stat, f"/d/f{i}")
    t("readdir", lambda: len(m.readdir("/d")))
    t("dir_stat", m.dir_stat, "/d")
    t.at(20_000.0, "dir_stat timed", m.dir_stat, "/d")
    t("unlink old f1", m.unlink, "/d/f1")
    t("unlink new n0", m.unlink, "/d/n0")
    return ceph_finish(t, c)


def ceph_sequence(P, ops) -> List[Any]:
    """A drawn sequence of ``CephLikeMount`` ops on one cluster that holds a
    directory ``/x``, a small file ``/a`` and a two-stripe ``/x/a``; every
    odd op runs timed, every even op untimed."""
    B = P.cephlike
    c = B.CephLikeCluster(n_mds=3, n_osd=5, seed=1, mds_cache_entries=16)
    m = B.CephLikeMount(c, "c0")
    t = Trace(c.net)
    t("mkdir /x", m.mkdir, "/x")
    t("write /a", m.write_file, "/a", b"a" * 1000)
    t("write /x/a", m.write_file, "/x/a", bytes(range(256)) * (B.OBJECT_SIZE // 256 + 1))
    for i, op in enumerate(ops):
        kind, args = op[0], op[1:]
        path = "/" + args[0] if args and isinstance(args[0], str) else None
        call = {"mkdir": lambda: m.mkdir(path),
                "create": lambda: m._create_file(path),
                "write": lambda: m.write_file(path, bytes([args[2]]) * args[1]),
                "overwrite": lambda: m.overwrite(path, args[1], args[2]),
                "read": lambda: m.read_file(path),
                "read_range": lambda: m.read_range(path, args[1], args[2]),
                "stat": lambda: m.stat(path),
                "unlink": lambda: m.unlink(path),
                "readdir": lambda: m.readdir(path),
                "dir_stat": lambda: m.dir_stat(path),
                "add_osd": lambda: c.add_osd(),
                "kill": lambda: c.net.kill(f"osd{args[0]}"),
                "revive": lambda: c.net.revive(f"osd{args[0]}")}[kind]
        if i % 2:
            t.at(1_000.0 * i, repr(op), call)
        else:
            t(repr(op), call)
    return ceph_finish(t, c)
