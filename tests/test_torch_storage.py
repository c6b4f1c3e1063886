"""The port's storage (``repro_torch.storage``) against ``repro.storage``, on the CPU.

The port's volume is a local directory (``LocalMount``); the reference's is
a simulated CFS volume.  Checkpoint files cross between the two byte for
byte, and each package restores the other's bit for bit.  The six tests of
``tests/test_storage_training.py`` that do not need replicas are ported
below.  ``test_hedged_read_avoids_straggler`` is not: it races the CFS
volume's replicas against a straggler, and a local directory has no
replicas, so the port reads a shard with a plain ``read_file``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import CfsCluster
from repro.models import get_model as jax_model
from repro.storage.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.storage.datapipe import ShardReader as JaxShardReader
from repro.storage.datapipe import ShardWriter as JaxShardWriter
from repro_torch import interop
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.storage.checkpoint import CheckpointManager, bytes_to_tensor, tensor_to_bytes
from repro_torch.storage.datapipe import ShardReader, ShardWriter
from repro_torch.storage.volume import LocalMount, NotFound
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(scope="module")
def cluster():
    c = CfsCluster(n_meta=4, n_data=6, extent_max_size=1024 * 1024,
                   data_disk_capacity=4 * 1024 * 1024 * 1024)
    c.create_volume("train", n_meta_partitions=3, n_data_partitions=8)
    return c


def _write(writer_cls, mnt, base):
    """tests/test_storage_training.py's dataset: arithmetic token sequences."""
    w = writer_cls(mnt, base, tokens_per_shard=4096)
    rng = np.random.RandomState(0)
    for _ in range(8):
        start = rng.randint(0, 97)
        w.add_document([(start + 3 * i) % 97 for i in range(3000)])
    return w.finish()


@pytest.fixture(scope="module")
def data_volume(tmp_path_factory):
    mnt = LocalMount(tmp_path_factory.mktemp("volume"))
    _write(ShardWriter, mnt, "/data")
    return mnt


def make_trainer(mnt, base="/ckpt", seed=0):
    cfg = torch_get_arch("minicpm-2b").reduced()
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=2, total_steps=50)
    tc = TrainerConfig(ckpt_every=3, ckpt_base=base, max_steps=10)
    reader = ShardReader(mnt, "/data", rank=0, world=1, batch=2, seq_len=32)
    return Trainer(cfg, oc, tc, mnt, reader, seed=seed, device="cpu")


def _bits(x):
    """The raw bits of a numpy array or torch tensor, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.dtype.itemsize])


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        elif tree[k] is not None:
            yield prefix + (k,), tree[k]


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path in want:
        g, w = _bits(got[path]), _bits(want[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


# ---------------------------------------------------------------- LocalMount

def test_local_mount_maps_volume_paths_to_files(tmp_path):
    mnt = LocalMount(tmp_path)
    assert not mnt.exists("/ckpt")
    mnt.mkdir("/ckpt")
    mnt.write_file("/ckpt/LATEST", b"3")
    mnt.write_file("/ckpt/LATEST", b"12")          # replaces
    assert (tmp_path / "ckpt" / "LATEST").read_bytes() == b"12"
    assert mnt.read_file("/ckpt/LATEST") == b"12"
    mnt.write_file("/ckpt/a~b.shard0", b"x")
    assert mnt.readdir("/ckpt") == ["LATEST", "a~b.shard0"]
    with pytest.raises(FileExistsError):
        mnt.mkdir("/ckpt")
    with pytest.raises(OSError):
        mnt.rmdir("/ckpt")                           # not empty
    mnt.unlink("/ckpt/LATEST")
    mnt.unlink("/ckpt/a~b.shard0")
    mnt.rmdir("/ckpt")
    assert os.listdir(tmp_path) == []
    with pytest.raises(NotFound):
        mnt.read_file("/ckpt/LATEST")
    for bad in ("ckpt", "/ckpt/../../etc", "/./x"):
        with pytest.raises(ValueError):
            mnt.exists(bad)
    with pytest.raises(NotADirectoryError):
        LocalMount(tmp_path / "missing")


# ---------------------------------------------------------------- RPT1 files

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tensor_files_are_the_reference_bytes(dtype):
    from repro.storage.checkpoint import bytes_to_tensor as jax_b2t
    from repro.storage.checkpoint import tensor_to_bytes as jax_t2b
    a = np.random.default_rng(0).standard_normal((6, 5)) * 100
    a = a.astype(jnp.dtype(dtype))
    t = interop.to_torch({"a": a}, "cpu")["a"]
    data = tensor_to_bytes(t)
    assert data == jax_t2b(a)
    back = bytes_to_tensor(jax_t2b(a))
    assert back.dtype == t.dtype and torch.equal(back, t)
    np.testing.assert_array_equal(_bits(jax_b2t(data)), _bits(a))
    assert tensor_to_bytes(torch.tensor(7, dtype=torch.int32)) == jax_t2b(np.asarray(7, np.int32))
    with pytest.raises(ValueError, match="RPT1"):
        bytes_to_tensor(b"XXXX" + data[4:])


# ---------------------------------------------------------------- across packages

def _state_numpy(seed):
    """A Trainer's state tree: bf16 params, fp32 moments and master weights,
    the int32 step scalar."""
    cfg = get_arch("minicpm-2b").reduced()
    params = jax.tree.map(np.asarray,
                          jax_model(cfg).init(jax.random.PRNGKey(seed), jnp.bfloat16))
    rng = np.random.default_rng(seed)
    f32 = lambda: jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                               params)
    return {"params": params, "mu": f32(), "nu": f32(), "master": f32(),
            "step": np.asarray(7, np.int32)}


def _zeros_like_torch(tree):
    return {k: _zeros_like_torch(v) if isinstance(v, dict) else
            torch.zeros_like(interop.to_torch({"x": v}, "cpu")["x"]) for k, v in tree.items()}


def _volume_files(mnt, base):
    """{path: bytes} of a checkpoint directory on a CFS volume or a LocalMount."""
    out = {}
    for name in mnt.readdir(base):
        if name.startswith("step_"):
            for f in mnt.readdir(f"{base}/{name}"):
                out[f"{base}/{name}/{f}"] = mnt.read_file(f"{base}/{name}/{f}")
        else:
            out[f"{base}/{name}"] = mnt.read_file(f"{base}/{name}")
    return out


def _copy_files(files, mnt):
    for path in sorted(files, key=lambda p: p.count("/")):
        parent = path.rsplit("/", 1)[0]
        for d in (parent.rsplit("/", 1)[0], parent):
            if d and not mnt.exists(d):
                mnt.mkdir(d)
        mnt.write_file(path, files[path])


def test_jax_checkpoint_restores_bit_exactly_in_the_port(cluster, tmp_path):
    mnt = cluster.mount("train")
    state = _state_numpy(0)
    JaxCheckpointManager(mnt, "/x_jax", shards=2).save(7, state)
    files = _volume_files(mnt, "/x_jax")
    assert any(p.endswith(".shard1") for p in files) and "/x_jax/LATEST" in files
    local = LocalMount(tmp_path)
    _copy_files(files, local)
    restored, step = CheckpointManager(local, "/x_jax", shards=2).restore(
        _zeros_like_torch(state))
    assert step == 7
    assert restored["params"]["layers"]["mlp"]["w1"].dtype == torch.bfloat16
    assert restored["step"].dtype == torch.int32 and restored["step"].shape == ()
    _assert_bit_equal(restored, state)

    # the port writes the same tree as the same files, byte for byte
    (tmp_path / "port").mkdir()
    out = LocalMount(tmp_path / "port")
    CheckpointManager(out, "/x_jax", shards=2).save(7, interop.to_torch(state, "cpu"))
    assert _volume_files(out, "/x_jax") == files


def test_port_checkpoint_restores_bit_exactly_in_jax(cluster, tmp_path):
    state = _state_numpy(1)
    local = LocalMount(tmp_path)
    CheckpointManager(local, "/x_port", shards=2).save(3, interop.to_torch(state, "cpu"))
    mnt = cluster.mount("train")
    _copy_files(_volume_files(local, "/x_port"), mnt)
    zeros = jax.tree.map(np.zeros_like, state)
    restored, step = JaxCheckpointManager(mnt, "/x_port", shards=2).restore(zeros)
    assert step == 3
    _assert_bit_equal(restored, state)


# ---------------------------------------------------------------- the six ported tests

def test_loss_decreases(data_volume):
    t = make_trainer(data_volume, base="/ck_a")
    hist = t.train(10)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first, f"loss did not decrease: {first} -> {last}"


def test_crash_resume_is_bit_exact(data_volume):
    t1 = make_trainer(data_volume, base="/ck_b1", seed=1)
    t1.train(8)
    t2 = make_trainer(data_volume, base="/ck_b2", seed=1)
    with pytest.raises(RuntimeError, match="injected"):
        t2.train(8, crash_at=5)
    t3 = make_trainer(data_volume, base="/ck_b2", seed=1)
    assert t3.resume()
    assert t3.step == 3          # last durable checkpoint
    t3.train(8 - t3.step)
    # bit for bit, where the reference allows 1e-6: the port's CPU path is deterministic
    _assert_bit_equal(t3.state_tree(), t1.state_tree())
    assert [h["loss"] for h in t3.history] == [h["loss"] for h in t1.history[3:]]


def test_checkpoint_crash_safety(data_volume):
    t = make_trainer(data_volume, base="/ck_c", seed=2)
    t.train(3)                   # durable ckpt at step 3
    t.train(2)
    with pytest.raises(RuntimeError, match="injected"):
        t.save(crash_after=3)    # dies mid-save of the step-5 ckpt
    t2 = make_trainer(data_volume, base="/ck_c", seed=2)
    assert t2.resume()
    assert t2.step == 3          # torn step-5 ckpt invisible (no MANIFEST)


def test_checkpoint_detects_corruption(tmp_path):
    mnt = LocalMount(tmp_path)
    cm = CheckpointManager(mnt, "/ck_d", shards=2)
    cm.save(1, {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)})
    name = [n for n in mnt.readdir("/ck_d/step_1") if n != "MANIFEST"][0]
    with open(tmp_path / "ck_d" / "step_1" / name, "r+b") as f:
        f.seek(20)
        f.write(b"\xff\xff\xff")
    with pytest.raises(IOError, match="checksum mismatch"):
        cm.restore({"w": torch.zeros((8, 8))})


def test_elastic_restore_different_shard_count(tmp_path):
    mnt = LocalMount(tmp_path)
    emb = torch.from_numpy(np.random.RandomState(3).randn(16, 8).astype(np.float32))
    CheckpointManager(mnt, "/ck_e", shards=4).save(7, {"emb": emb})
    assert len(mnt.readdir("/ck_e/step_7")) == 5             # 4 shards + MANIFEST
    restored, step = CheckpointManager(mnt, "/ck_e", shards=2).restore(
        {"emb": torch.zeros((16, 8))})
    assert step == 7
    assert torch.equal(restored["emb"], emb)
    with pytest.raises(ValueError, match="shape"):
        CheckpointManager(mnt, "/ck_e").restore({"emb": torch.zeros((8, 8))})


def test_datapipe_deterministic_batches(cluster, data_volume):
    r1 = ShardReader(data_volume, "/data", 0, 2, batch=2, seq_len=16)
    r2 = ShardReader(data_volume, "/data", 0, 2, batch=2, seq_len=16)
    b1, b2 = r1.batch_at(5), r2.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    ra = ShardReader(data_volume, "/data", 0, 2, batch=2, seq_len=16)
    rb = ShardReader(data_volume, "/data", 1, 2, batch=2, seq_len=16)
    assert not set(ra.my_shards()) & set(rb.my_shards())

    # the same dataset on a CFS volume, written and read by the reference
    mnt = cluster.mount("train")
    mnt.mkdir("/pipe")
    assert _write(JaxShardWriter, mnt, "/pipe/data") == 6
    assert _volume_files(mnt, "/pipe/data") == {
        p.replace("/data", "/pipe/data"): b for p, b in _volume_files(data_volume, "/data").items()}
    for rank, world, seed in ((0, 1, 0), (1, 2, 0), (0, 2, 5)):
        mine = ShardReader(data_volume, "/data", rank, world, batch=3, seq_len=50, seed=seed)
        ref = JaxShardReader(mnt, "/pipe/data", rank, world, batch=3, seq_len=50, seed=seed)
        assert mine.my_shards() == ref.my_shards()
        for step in (0, 1, 7, 40):
            got, want = mine.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------- torn checkpoints

def _torn_save(cm_cls, mnt, base, tree):
    cm = cm_cls(mnt, base, shards=2)
    cm.save(3, tree)
    with pytest.raises(RuntimeError, match="injected"):
        cm.save(5, tree, crash_after=2)          # step_5 holds 2 shard files, no MANIFEST
    assert mnt.exists(f"{base}/step_5") and not mnt.exists(f"{base}/step_5/MANIFEST")
    return cm


def test_reference_keeps_a_torn_checkpoint_for_good(cluster):
    """The reference's fault, pinned: ``save`` returns at once when step_5/
    exists, MANIFEST or not, so the torn step is never written again, and the
    garbage collection (which lists committed steps only) never removes it."""
    mnt = cluster.mount("train")
    tree = {"a": np.ones((4, 2), np.float32), "b": np.zeros((4,), np.float32)}
    cm = _torn_save(JaxCheckpointManager, mnt, "/torn_jax", tree)
    cm.save(5, tree)
    assert cm.latest_step() == 3 and cm.list_steps() == [3]
    assert len(mnt.readdir("/torn_jax/step_5")) == 2
    for s in (7, 9, 11):
        cm.save(s, tree)
    assert mnt.exists("/torn_jax/step_5") and cm.list_steps() == [9, 11]


def test_port_rewrites_and_collects_a_torn_checkpoint(tmp_path):
    mnt = LocalMount(tmp_path)
    tree = {"a": torch.ones((4, 2)), "b": torch.zeros(4)}
    cm = _torn_save(CheckpointManager, mnt, "/torn", tree)
    cm.save(5, tree)                              # cleared and written again
    assert cm.latest_step() == 5 and cm.list_steps() == [3, 5]
    assert sorted(mnt.readdir("/torn/step_5")) == ["MANIFEST", "a.shard0", "a.shard1",
                                                   "b.shard0", "b.shard1"]
    restored, _ = cm.restore({"a": torch.zeros((4, 2)), "b": torch.ones(4)})
    _assert_bit_equal(restored, tree)
    # a torn step that is never saved again goes once a later step commits
    with pytest.raises(RuntimeError, match="injected"):
        cm.save(6, tree, crash_after=1)
    cm.save(7, tree)
    assert not mnt.exists("/torn/step_6") and cm.list_steps() == [5, 7]
