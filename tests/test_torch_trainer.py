"""The port's Trainer and training launcher against the JAX package, on the CPU.

The JAX Trainer trains on a volume of the reference's simulated CFS
cluster, the port's on a volume of the port's own copy of it (built by
``repro_torch.launch.train.build_cluster``, as the launcher builds it);
both volumes hold the same dataset, written by each package's
``ShardWriter``.  The port's Trainer starts from the JAX Trainer's initial
parameters (carried across with ``repro_torch.interop``), assigned after
construction.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import CfsCluster
from repro.launch.train import write_dataset as jax_write_dataset
from repro.storage.datapipe import ShardReader as JaxShardReader
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch import interop
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.launch import train as launch_train
from repro_torch.core import CfsMount
from repro_torch.storage.datapipe import ShardReader
from repro_torch.storage.volume import LocalMount
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

STEPS = 10


def test_trainer_matches_jax_over_ten_steps():
    """Reduced minicpm-2b, fp32 params with fp32 master weights, WSD: the
    loss and the grad norm of every step within 1e-4 (relative).  Both are
    fp32 and differ only in the order of summation; over 10 AdamW steps
    that noise grows (measured on the CPU: at most 1.7e-7 on the loss and
    5.0e-6 on the grad norm)."""
    cluster = CfsCluster(n_meta=4, n_data=6, extent_max_size=1024 * 1024,
                         data_disk_capacity=1024 * 1024 * 1024)
    cluster.create_volume("train", n_meta_partitions=3, n_data_partitions=8)
    jmnt, tmnt = cluster.mount("train"), launch_train.build_cluster().mount("train")
    jcfg, tcfg = get_arch("minicpm-2b").reduced(), torch_get_arch("minicpm-2b").reduced()
    jax_write_dataset(jmnt, jcfg.vocab)
    launch_train.write_dataset(tmnt, tcfg.vocab)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    jreader = JaxShardReader(jmnt, "/data", rank=0, world=1, batch=2, seq_len=32)
    treader = ShardReader(tmnt, "/data", rank=0, world=1, batch=2, seq_len=32)
    for step in range(STEPS):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(treader.batch_at(step)[k], jreader.batch_at(step)[k])

    jt = JaxTrainer(jcfg, jopt.opt_config_for(jcfg, **kw), JaxTrainerConfig(ckpt_every=3),
                    jmnt, jreader, seed=0)
    toc = topt.opt_config_for(tcfg, **kw)
    tt = Trainer(tcfg, toc, TrainerConfig(ckpt_every=3), tmnt, treader, device="cpu")
    assert toc.master_weights and toc.schedule == "wsd"
    tt.params = interop.to_torch(jax.tree.map(np.asarray, jt.params), "cpu")
    tt.opt_state = topt.init_opt_state(toc, tt.params)

    want, got = jt.train(STEPS), tt.train(STEPS)
    assert [h["step"] for h in got] == [h["step"] for h in want] == list(range(1, STEPS + 1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    assert got[-1]["loss"] < got[0]["loss"]
    assert tt.ckpt.list_steps() == [6, 9] == jt.ckpt.list_steps()


def test_build_cluster_is_the_references():
    """The launcher's cluster is the reference's launcher's, state for state:
    every raft member, partition, disk and the RM's tables."""
    import torch_core_parity as tp
    from repro.launch.train import build_cluster as jax_build_cluster
    tp.align_serials()
    tp.assert_same([tp.fingerprint(jax_build_cluster())],
                   [tp.fingerprint(launch_train.build_cluster())])


def test_state_tree_is_the_reference_tree(tmp_path):
    """The checkpointed leaves: params, mu, nu, master and step, by name."""
    cfg = torch_get_arch("minicpm-2b").reduced()
    mnt = LocalMount(tmp_path)
    launch_train.write_dataset(mnt, cfg.vocab)
    oc = topt.opt_config_for(cfg)
    t = Trainer(cfg, oc, TrainerConfig(), mnt, ShardReader(mnt, "/data", 0, 1, 2, 16),
                device="cpu")
    tree = t.state_tree()
    assert sorted(tree) == ["master", "mu", "nu", "params", "step"]
    assert tree["step"].dtype == torch.int32 and tree["step"].shape == ()
    assert TrainerConfig().micro_batches == 1     # a field nothing reads, as in the reference


@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-1.6b", "zamba2-7b"])
def test_launch_train_crash_and_resume_on_cpu(capsys, arch):
    """``--crash-at 3`` with ``--ckpt-every 2``: the run crashes after step 3,
    resumes from the step-2 checkpoint and finishes; steps 3 to 6 and the
    final params match an uninterrupted run bit for bit.  The default arch, and
    the ssm and hybrid families, whose scans' backward runs here through their
    plain chunked forms.  Each run has a cluster of its own."""
    common = ["--device", "cpu", "--steps", "6", "--ckpt-every", "2", "--seq", "16",
              "--arch", arch]
    whole = launch_train.main(common)
    capsys.readouterr()
    resumed = launch_train.main(common + ["--crash-at", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
    assert "injected trainer crash at step 3" in out and "resumed at step 2" in out
    assert "checkpoints on volume: [4, 6]" in out
    assert resumed.step == whole.step == 6
    assert resumed.ckpt.mnt is not whole.ckpt.mnt
    assert resumed.history == whole.history[2:]
    for (path, a), (_, b) in zip(topt.flatten_with_paths(resumed.params),
                                 topt.flatten_with_paths(whole.params)):
        assert torch.equal(a, b), path


def test_launch_train_default_volume_is_temporary(capsys, tmp_path, monkeypatch):
    """The launcher's volume is volume ``train`` of a cluster it builds in
    memory: nothing is written to the working directory."""
    monkeypatch.chdir(tmp_path)
    trainer = launch_train.main(["--device", "cpu", "--steps", "2", "--ckpt-every", "1",
                                 "--seq", "8", "--arch", "mixtral-8x22b"])
    out = capsys.readouterr().out
    assert "arch=mixtral-8x22b" in out and "checkpoints on volume: [1, 2]" in out
    mnt = trainer.ckpt.mnt
    assert isinstance(mnt, CfsMount) and mnt.client.volume == "train"
    assert sorted(mnt.readdir("/ckpt")) == ["LATEST", "step_1", "step_2"]
    assert list(tmp_path.iterdir()) == []


def test_cuda_trainer_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1"])


def test_reduced_config_takes_the_scan_kernels_sizes_on_the_card():
    """On the CPU the launchers run the reference's reduced configs; on the card the
    ssm and hybrid families' scan head size and SSD state become 64, the sizes the
    WKV6 and SSD kernels are compiled for, and nothing else changes."""
    import dataclasses
    from repro_torch.configs import ARCH_NAMES
    for arch in ARCH_NAMES:
        reduced = torch_get_arch(arch).reduced()
        assert launch_train.reduced_config(arch, "cpu") == reduced
        on_card = launch_train.reduced_config(arch, "cuda")
        if reduced.family == "ssm":
            assert on_card == dataclasses.replace(reduced, ssm_head_dim=64)
        elif reduced.family == "hybrid":
            assert on_card == dataclasses.replace(reduced, ssm_head_dim=64, ssm_state=64)
        else:
            assert on_card == reduced
