"""The port's Ceph-like comparison system (``repro_torch.baseline.cephlike``)
against the reference's, on the CPU.

Each scripted workload runs on both packages' clusters and must give the
same trajectory, bit for bit: every return value and exception, every op's
modeled time, and at the end each MDS's dentries, inodes, cache and disk,
each OSD's objects and disk, the placement state and the network
(``torch_core_parity.ceph_fingerprint``).  The drawn sequence of mount ops is
in ``test_torch_core_props.py``.
"""

import pytest

import torch_core_parity as tp

MIB = 1024 * 1024


def _by_label(rows):
    return {label: out for label, out, _ in rows}


def test_seven_metadata_operations():
    rows = tp.both(tp.ceph_metadata)
    by = _by_label(rows)
    assert by["mkdir exists"][:2] == ("raise", "Exists")
    assert by["mkdir under missing"][:2] == ("raise", "NotFound")
    assert by["create exists"][:2] == ("raise", "Exists")
    assert by["stat missing"][:2] == ("raise", "NotFound")
    assert by["unlink missing"][:2] == ("raise", "NotFound")
    assert by["rmdir again"][:2] == ("raise", "NotFound")
    listed = by["dir_stat 0"][1][1]
    assert [dict(e[1])["name"] for e in listed] == [f"f{i}" for i in range(16)] + ["g"]
    assert by["tree readdir"] == ("ok", ("list", ("t0", "t1")))
    assert by["readdir after"] == ("ok", ("list", ("s",)))
    assert [dict(e[1])["name"] for e in by["dir_stat after"][1][1]] == ["g"]
    timed = [timing for label, _, timing in rows if label.startswith("rmdir d")]
    assert all(end > start for start, end, *_ in timed)


def test_striped_file_read_overwrite_and_unlink():
    rows = tp.both(tp.ceph_large_file)
    by = _by_label(rows)
    data = bytearray(bytes(range(256)) * (9 * MIB // 256))
    data[4 * MIB - 50: 4 * MIB + 50] = b"Z" * 100
    data[10:20] = b"Y" * 10
    assert by["read whole"] == ("ok", bytes(data))
    assert by["read across again"] == ("ok", bytes(data[4 * MIB - 60: 4 * MIB + 60]))
    stripes = [name for _, names in by["stripes"][1][1] for name in names[1][1]]
    assert len(stripes) == 3 * 3                  # three stripes, three replicas each
    assert by["objects left"] == ("note", ("list", (0, 0, 0, 0, 0)))
    assert by["read gone"][:2] == ("raise", "NotFound")


def test_add_osd_rebalances_with_and_without_a_timed_op():
    rows = tp.both(tp.ceph_add_osd)
    by = _by_label(rows)
    moved = [by[f"migrated after {how}"][1] for how in ("bare", "untimed", "timed")]
    assert 0 < moved[0] < moved[1] < moved[2]
    for label, out, timing in rows:
        if label.startswith("read /f"):
            assert out[0] == "ok", (label, out)
    timed = {label: timing for label, _, timing in rows}
    assert timed["add_osd bare"] is None
    start, end = timed["add_osd timed"][:2]
    assert start == 200_000.0 and end > start


def test_small_mds_cache_evicts_and_reads_its_disk():
    rows = tp.both(tp.ceph_small_cache)
    by = _by_label(rows)
    assert max(max(by[f"cache sizes {i}"][1][1]) for i in range(15)) <= 8
    reads = [by[f"disk reads {r}"][1][1] for r in range(2)]
    assert sum(reads[1]) > sum(reads[0]) > 0


def test_dead_osd_on_unlink_is_swallowed():
    rows = tp.both(tp.ceph_dead_osd)
    by = _by_label(rows)
    victim = by["victim"][1]
    assert by["unlink f0"] == ("ok", None)         # the delete to the dead replica failed
    assert by["left on victim"][1][1]              # and its copy stays behind
    assert by["unlink f1"] == ("ok", None)
    assert by["rewrite f2"] == ("raise", "NodeDown", None, victim)   # not swallowed
    assert all(by[f"read f{i}"][0] == "ok" for i in (2, 3))


def test_fragmentation_and_the_lookup_that_misses():
    """Past the threshold a directory fragments; an entry made before the
    split is looked up at the MDS its name hashes to and can be missed
    there, at the same row in both packages."""
    rows = tp.both(tp.ceph_fragment)
    by = _by_label(rows)
    n = tp.REF.cephlike.FRAGMENT_THRESHOLD
    assert by["fragmented below"] == ("note", ("dict", ()))
    assert by[f"fragmented after f{n}"][1][1]
    assert by["proxy hops below"] == ("note", 0) and by["proxy hops"][1] > 0
    assert all(by[f"stat new n{i}"][0] == "ok" for i in range(4))
    assert by["read new"] == ("ok", b"w" * 10)
    old = [by[f"stat old f{i}"] for i in range(8)]
    assert any(o[:2] == ("raise", "NotFound") for o in old)
    assert any(o[0] == "ok" for o in old)
    assert by["dir_stat"][:2] == ("raise", "NotFound")
    assert by["unlink old f1"][:2] == ("raise", "NotFound")


@pytest.mark.parametrize("scenario", ["ceph_metadata", "ceph_large_file", "ceph_add_osd",
                                      "ceph_small_cache", "ceph_dead_osd"])
def test_rerun_gives_the_same_trajectory(scenario):
    """A scenario run twice in one package, with the network serial started
    at the same value, is the same: the comparison above rests on this."""
    fn = getattr(tp, scenario)
    net = tp.PORT.simnet.Network
    serial = net._created
    first = fn(tp.PORT)
    net._created = serial
    tp.assert_same(first, fn(tp.PORT))


def test_ceph_trajectories_see_a_difference():
    """The comparison is not vacuous: one more byte in one OSD is found."""
    ref = tp.ceph_large_file(tp.REF)

    def port(P):
        B = P.cephlike
        orig = B.OSD.write_object

        def write_object(self, name, data):
            return orig(self, name, data + b"!" if name.endswith(":2") else data)
        B.OSD.write_object = write_object
        try:
            return tp.ceph_large_file(P)
        finally:
            B.OSD.write_object = orig

    with pytest.raises(AssertionError, match="differs"):
        tp.assert_same(ref, port(tp.PORT))
