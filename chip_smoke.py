#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each fatal on failure:
  (a) device: the card's name and power limit (nvidia-smi);
  (b) build: nvcc compiles the port's nine CUDA sources for sm_90a, all at once;
      cuobjdump proves the bf16 flash kernels run on the tensor cores (HGMMA in
      the forward, HMMA in the backward) and the fp32 ones do not, and that
      every kernel of the WKV6 and SSD scans, forward and backward, issues
      tensor-core instructions (3xTF32 mma.sync; the backward's sums over
      partials have no products) and none spills, beside each kernel's
      registers and spills from ptxas;
  (c) kernels: each kernel against its plain PyTorch version on the card at
      the shapes the serving and training paths give it (flash attention
      forward at hd 128, 112 and minicpm-2b's 64, and at mixtral-8x22b's
      serving shape with its 4096 window biting, its backward at minicpm-2b's
      training shape and in bf16 at hd 128 with (f2)'s group sizes 6 and 8, the
      checksum bit for bit at the size of minicpm-2b's
      largest parameter, the WKV6 and SSD scans, with ragged, windowed, offset
      and nonzero-state cases, T at the scans' tile borders, WKV6 decays down to
      the reference's 1e-30 clamp and SSD decays that underflow within a chunk),
      the scans' backward kernels at the training shapes of (i) against the
      plain backward (autograd through the chunked forms), with a nonzero
      initial state and final-state cotangent, a ragged T and strong decays
      (WKV6's dw exactly 0 where w < 1e-30), each with its time, the plain
      version's, one library call's where there is one, and its bound; for the
      scans' backward also each CUDA kernel's device time (profiler), threads,
      shared memory a block and blocks an SM, and the workspace's bytes beside
      the I/O bound; then the four scan kernels again at the reduced configs'
      sizes (K = V = 32; (P, N) = (32, 16)), timed at the full models' widths
      with those head sizes, and at the launchers' shapes, a ragged T, a T
      shorter than one chunk, 11 heads and strong decays; the decode kernel
      (K5) against the plain version in fp32 at every head dim and group size
      the served archs give it, its slots past n_valid NaN, timed at
      minicpm-2b's decode cell (B 32, 36 heads of 64, 2,304 slots, 2,100
      valid) beside the model's plain path and SDPA on the valid slots;
  (d) serving, one model after another, each at full published width with
      random bf16 weights from a seed: codeqwen1.5-7b, zamba2-7b and
      rwkv6-1.6b each serve 8 requests through ``BatchServer``.  Every
      kernel's launch count over that run is checked against the path's
      layers (the decode kernel once a layer a decode step); then
      prefill/decode consistency and kernel-path vs plain-path prefill and
      decode logits, on the bf16 weights and on an fp32 copy of them
      (``SERVE_TOL``, ``FP32_TOL``); last, one wave's prefill and decode steps run under
      torch.profiler for device time by kernel.  Each model's weights and
      caches are freed before the next one is made; (d2) after (h), the five
      archs served nowhere else (phi3-medium-14b, qwen1.5-32b, musicgen-large,
      chameleon-34b, arctic-480b), each at full width in bf16, cut to the layers
      that fit beside ``MOE_HEADROOM_BYTES`` (reckoned from param_count()), one
      wave of ``EXTRA_REQUESTS`` shorter requests, its launches checked, then
      decode vs prefill and kernel path vs plain path (arctic-480b on shared
      expert choices);
  (d3) serving zamba2-7b-instruct (``PUB_ARCH``, the published Zamba2-7B, whole, the
      model of the benchmark's decode cell): K1 and K5 at head dim 224 with its
      softmax scale, K3 with B and C in 2 groups and K6 (the Mamba2 decode step)
      against their plain versions at the decode cell's shapes, each timed; one wave
      of 4 requests through ``BatchServer``, every kernel's launches checked with
      the counters zeroed just before it (K6 once a layer and K5 once a site a decode
      step, the graphs' replays counted); the wave again with the server's graphs
      off, token for token; the kernel path's prefill and decode logits within twice
      the bf16 plain paths' distance from the plain paths on an fp32 copy;
  (f) training: minicpm-2b at full published width, random bf16 weights with
      fp32 master weights and moments, takes ``TRAIN_STEPS`` steps of
      ``make_train_step`` at B=2, T=2048 on the arithmetic token sequences of
      ``repro.launch.train``; the flash kernels' launches are checked per
      step (forward twice per layer, with the remat recompute, backward once)
      and every trained parameter is digested by the checksum kernel, bit for
      bit against its plain version; one more step runs under torch.profiler.
      Then, at 4 layers and full width, the kernel path against the plain
      path (loss, every gradient, the params after 2 steps) in fp32 and bf16
      (``FP32_TOL``, ``TRAIN_TOL``);
  (f2) training the other attention archs (``F2_ARCHS``: codeqwen1.5-7b,
      phi3-medium-14b, musicgen-large, qwen1.5-32b, chameleon-34b, mixtral-8x22b) as
      (f) trains minicpm-2b, each at full width with bf16 params and its config's own
      optimizer (mixtral-8x22b: bf16 moments, no master weights), cut in depth only
      to the most layers whose step fits the card by a rule reckoned from
      param_count() (``train_depth_cut``, logged with its bytes); the kernel path
      against the plain one in fp32 and bf16 at ``CHECK_LAYERS`` layers or fewer
      (``check_depth_cut``), both paths on the kernel path's expert choices (MoE)
      and loss argmax, the plain path's own noise floor (half its flash blocks)
      beside the bf16 gradients (``BF16_GRAD_TOL``).  arctic-480b has no (f2) run:
      one layer's training state (13.611 B params at 8 bytes) is 108.9 GB;
  (g) the trainer: minicpm-2b at full width cut to ``TRAINER_LAYERS`` layers
      (stated in the JSON), bf16 params with fp32 master weights and moments,
      B=2, T=2048, trains through ``Trainer`` on volume ``train`` of the port's
      simulated CFS cluster (``repro_torch.launch.train.build_cluster``: 4 meta
      nodes, 6 data nodes, 1 MiB extents, three replicas; the data disks
      raised from 4 GiB to 8, stated in the JSON: ``TRAINER_DISK_BYTES``), holding
      ``repro_torch.launch.train``'s dataset, its shards read by hedged reads:
      run U takes 3 steps with no checkpoint; run C saves step 2 and crashes
      after step 3; a fresh Trainer restores step 2 and takes step 3.  Every
      leaf of params, mu, nu and master after step 3 must have the same
      checksum-kernel digest in U and in the resumed run, and ``fsck`` of the
      volume must find no fault.  Save and restore GB/s, by stage, beside the
      cluster's modeled time (its virtual clock) for each; the datapipe's
      hedged reads from its client's counters;
  (h) MoE serving: mixtral-8x22b at full width, cut to the most layers that fit
      the card beside ``MOE_HEADROOM_BYTES`` for the wave's buffers, serves 8
      requests with prompts of 3072-6144 tokens (past its 4096 window) through
      ``BatchServer``, with the window's flash kernel launched once per layer a
      wave; then decode against a prompt longer than the window and the kernel
      path against the plain one, on shared expert choices, in bf16 at the cut
      and in fp32 at 2 layers; and one wave under torch.profiler;
  (i) training the ssm and hybrid families: (f)'s phase for rwkv6-1.6b at full
      width and depth and zamba2-7b at full width cut to ``SSM_TRAIN_LAYERS``
      layers (stated in the JSON), their scans running K4/K3 forward (twice a
      layer, with the recompute) and K4-bwd/K3-bwd backward (once), zamba2's
      shared block K1 and K1-bwd at hd 112; the launch counts checked per step,
      and the kernel path against the plain one at ``SSM_CHECK_LAYERS`` layers;
  (j) the mesh paths (``repro_torch.parallel``), on a world of one NCCL rank
      joined through a rendezvous file and a 1 x 1 ("data", "model") mesh:
      (j1) after (g), (g)'s minicpm-2b (full width, ``TRAINER_LAYERS`` layers,
      bf16 params, fp32 master weights and moments, (f)'s batches) takes 3
      steps without a mesh, then 3 steps of ``make_train_step`` from the same
      weights on DTensor params and optimizer state placed by
      ``param_shardings``/``opt_shardings``, and 3 more with FSDP forced (the
      params split over "data", so each layer's gather and its backward's
      reduce-scatter run on the group of one): the flash kernels' launches per
      step, every leaf after 2 steps bit for bit by K2 digests, the parameter
      gathers and gradient reduce-scatters a step, each run's step ms and
      peak GB, and one more step of each under torch.profiler; and after
      each of (i)'s models, that model at full width cut to
      ``SSM_MESH_LAYERS`` layers takes 2 steps without a mesh and 2 on
      placed params (its rwkv6 or Mamba2 blocks and zamba2's shared block
      split over "model"): every leaf bit for bit by K2 digests, K4-bwd or
      K3-bwd (and zamba2's K1-bwd) launched as the mesh-free step launches
      them;
      (j2) in (h), on its weights and after its checks, one prefill wave
      through the expert-parallel ``moe_block_shard_map`` (8 experts a
      rank) against the local dispatch in groups = dp = 1, on shared expert
      choices (``SERVE_TOL``), with the tokens dropped by layer and both
      waves' tok/s; (j3) in (f), after its
      moments and master weights are freed, ``compress_tree`` twice (the
      second carrying the first's residual) over the gradient tree of
      full-width minicpm-2b, every leaf checked (int8 in [-127, 127], error
      within 1.51 of its block's scale, residual = corrected - deq exactly,
      packed under a 3.5th of the fp32 bytes) and one leaf's q and scales bit
      for bit against the CPU's, with its ms beside its bytes bound; (j4) in
      (d), on each served model's weights (full width and depth) after its
      checks, the first wave's 4 prompts through ``placed_prefill`` and
      ``PLACED_STEPS`` ``placed_decode`` steps on DTensor params, tokens and
      cache placed as the reference places its serving calls (rwkv6's and
      zamba2's blocks, states and K/V split over "model"), against the
      mesh-free wave: every step's logits and tokens bit for bit; then, for
      codeqwen1.5-7b and zamba2-7b, the same wave with the K/V split by its
      sequence (``ctx.force_sequence_split``: the context-parallel decode
      attention), teacher-forced with the first wave's tokens, within
      ``SERVE_TOL``; each prefill launching the kernels
      ``expected_launches`` names, each decode step the decode kernel once a
      layer (none with the sequence split), and each run's prefill and
      decode tok/s and peak GB;
  (k) counts against the card (``repro_torch.launch.roofline``): in (d), one
      prefill wave (B=4, the longest of the 8 prompts) of each served model on
      its weights, and in (f), (i) and (f2), one more train step of each trained
      model, each counted twice by ``roofline.Count``: on the card (the
      kernels launch, their counters checked) and on fake CPU twins through
      the kernels' operators (``ops.kernel_path``, the dry run's lowering);
      fatal if the lowering's flops or bytes differ from the card's count at
      all, if its peak of live bytes differs from the card's count by more
      than 1%, or if it launches a kernel.  Beside the call's measured ms (the
      median of 5 timed waves; of (f)'s, (i)'s and (f2)'s steps after the first): its
      bound on the H100's published peaks and the term that sets it,
      ``roofline_share`` (bound / measured), ``mfu`` (6 or 2 x params x
      tokens / (measured s x 989e12)), and the dry run's peak of live device
      bytes against max_memory_allocated(); then the host time a kernel's
      operator adds to a call, and, after every timed phase,
      ``python -m repro_torch.launch.dryrun`` on two production cells
      (``DRYRUN_CELLS``, 256 fake ranks) in subprocesses that see no card;
  (l) host work, run first after the build: (l1) the port's determinism lint
      (``repro_torch.analysis.lint``) over its shipped tree, fatal unless it
      exits 0 with no grandfathered key; (l2) the paper's seven metadata
      operations (mdtest's DirCreation, DirStat, DirRemoval, FileCreation,
      FileRemoval, TreeCreation, TreeRemoval, ``benchmarks/mdtest.py``) on the
      port's CFS (``CfsVfs`` fd calls) and on its Ceph-like baseline
      (``repro_torch.baseline.cephlike``), one client, ``MD_PROCS`` procs, each
      op a timed op on the simulation's virtual clock, every operation's work
      read back; then an OSD joins after a three-stripe ``write_file`` and must
      migrate bytes.  The whole of (l2) runs twice with one seed and must give
      the same trajectory.  Each operation's modeled us per op on both systems
      and their ratio are printed as virtual-clock figures, not times of the
      card, and no ratio is asserted;
  (m) the launchers: ``repro_torch.launch.train`` (4 steps, a crash and the
      resume) and ``repro_torch.launch.serve`` for every arch on the card, at the
      reference's reduced configs (scan head 32, SSD state 16; head 32 and
      mixtral-8x22b's window 64), the scan or flash kernels' launches checked;
  (e) output: a ``kernels`` JSON line, one ``serving`` JSON line per model
      (mixtral-8x22b's too), a ``training`` and a ``trainer`` JSON line, one
      ``training`` line each for (i)'s and (f2)'s models, a ``roofline`` line with (k)'s
      numbers, a ``parallel`` line with (j)'s, a ``storage_baseline`` line with
      (l)'s, a ``launchers`` line with (m)'s, the nvidia-smi line, and last the
      ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.autograd import DeviceType
from torch.distributed.tensor import DTensor
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import lint  # noqa: E402
from repro_torch.baseline.cephlike import CephLikeCluster, CephLikeMount  # noqa: E402
from repro_torch.configs import ARCH_NAMES, ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    O_CREAT, O_TRUNC, O_WRONLY, CfsClient, CfsCluster, EventScheduler, Network)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.checksum import checksum as checksum_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as decode_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.mamba2_ssd import ssd_bwd, ssd_fwd  # noqa: E402
from repro_torch.kernels.mamba2_step import mamba2_step as step_kernel  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6_bwd, wkv6_fwd  # noqa: E402
from repro_torch.kernels.work import (  # noqa: E402
    checksum_work, decode_attention_work, flash_bwd_work, flash_fwd_work, mamba2_step_work,
    ssd_bwd_work, ssd_work, wkv6_bwd_work, wkv6_work)
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import init_process_group, make_host_mesh  # noqa: E402
from repro_torch.core.fsck import fsck  # noqa: E402
from repro_torch.launch.train import build_cluster, write_dataset  # noqa: E402
from repro_torch.models import get_model, layers, moe, transformer, zamba2  # noqa: E402
from repro_torch.parallel import compress, ctx, spmd  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.serve.server import (  # noqa: E402
    BatchServer, Request, placed_decode, placed_prefill)
from repro_torch.storage.datapipe import ShardReader  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet, roofline.PEAK_FLOPS), at a 700 W
# power limit: bf16 on the tensor cores, fp32 on the CUDA cores, and TF32 on the tensor
# cores, the rate that bounds the fp32 scans, whose products run there (3xTF32: three
# passes a product; the bound counts the function's flops once)
PEAK_FLOPS = {torch.bfloat16: roofline.PEAK_FLOPS["bf16"],
              torch.float32: roofline.PEAK_FLOPS["fp32"], "tf32": roofline.PEAK_FLOPS["tf32"]}
HBM_BYTES_S = roofline.HBM_BW
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}   # tests/test_kernels_pallas.py
SCAN_TOL = 3e-3     # fp32 WKV6 / SSD scans, tests/test_kernels_pallas.py:57,76-77
# Full-width serving vs itself (decode vs prefill) and vs the plain path,
# checked as |a-b| <= tol*(1 + |b|), twice: on the bf16 serving weights and
# on an fp32 copy of them.  In fp32 the paths differ only in the order of
# summation (measured <= 6.2e-5 on zamba2-7b and rwkv6-1.6b on an H100;
# PERF.md) and, for codeqwen1.5-7b, in the bf16 KV cache its decode reads
# whatever the weights' dtype (6.6e-4), hence FP32_TOL.  In bf16 (8-bit
# mantissa) a path that rounds a value to the neighbouring bf16 number (the
# attention's probabilities, a scan's output) sends a one-ulp step through
# every later layer, and these random-weight models carry it to the logits:
# measured within 1.5e-2 for codeqwen1.5-7b's 32 layers, 0.16 for zamba2-7b's
# 81 and 0.09 for rwkv6-1.6b's 24.  mixtral-8x22b (its 12-layer cut) is
# checked on shared expert choices (check_consistency): so held, its layers
# carry the step as codeqwen1.5-7b's do, measured 1.64e-2 (kernel vs plain)
# and 1.70e-2 (decode vs prefill) on an H100, hence 5e-2.  With each path's
# own choices, a one-ulp step flips near-tied top-2 choices (21-322 of 8,792
# tokens a layer) and the logits move by 0.195: no tolerance of the rounding
# bounds that.  Its fp32 copy, at 2 layers, decodes twice: against the bf16
# cache, whose rounding alone moves its logits by 9.8e-3, held to the bf16
# SERVE_TOL; and against an fp32 cache (fp32_kv_cache), which leaves 1.2e-5
# (both on an H100 80GB HBM3 at 700 W), held to FP32_TOL.  (d2)'s archs, in bf16 at
# their cuts (H100 80GB HBM3, 700 W): kernel vs plain and decode vs prefill within
# 1.51e-2 and 1.48e-2 for phi3-medium-14b's 40 layers, 1.39e-2 and 1.30e-2 for
# qwen1.5-32b's 55 and 2.33e-2 and 2.23e-2 for chameleon-34b's 42, hence 5e-2 as for
# codeqwen1.5-7b; 3.36e-2 and 3.95e-2 for musicgen-large's 48 layers of 32 heads of
# 64, hence 0.1; arctic-480b's 1 layer, on shared expert choices as mixtral-8x22b,
# 1.71e-2 and 2.77e-2, hence 5e-2.
SERVE_TOL = {"codeqwen1.5-7b": 5e-2, "zamba2-7b": 0.25, "rwkv6-1.6b": 0.15,
             "mixtral-8x22b": 5e-2, "phi3-medium-14b": 5e-2, "qwen1.5-32b": 5e-2,
             "musicgen-large": 0.1, "chameleon-34b": 5e-2, "arctic-480b": 5e-2}
FP32_TOL = 1e-3
# Training, kernel path vs plain path at 4 layers of minicpm-2b, bf16 weights:
# the loss, each gradient leaf (against its largest value) and the params
# after 2 steps (against 1 + |b|).  In bf16 the two backward passes round
# dq/dk/dv, and so every later gradient, to neighbouring bf16 numbers: the
# gradients differ by up to 9.1e-3 of their leaf's largest value (about two
# bf16 ulps), and the params after 2 steps by 2.9e-3, the bound AdamW gives
# (a step is about +-lr, 5e-4 then 1e-3, for a gradient near zero whichever
# rounding put it there); the loss by 7.5e-6 (measured on an H100; PERF.md).
TRAIN_TOL = 2e-2
# (i) and (f2) in bf16, both paths on the kernel path's loss argmax (and expert choices,
# check_train_consistency): the plain path differs from itself, with its scans at half
# the chunk and its flash blocks halved, by 5.7e-3 to 1.59e-2 (rwkv6-1.6b) of a gradient
# leaf's largest value, and the kernel path from the plain one by 1.14e-2 to 1.98e-2
# (rwkv6-1.6b; zamba2-7b 1.95e-2, phi3-medium-14b 1.89e-2), largest in an embedding (H100
# 80GB HBM3, 700 W; PERF.md).  So their gradients are held to BF16_GRAD_TOL, about three
# times the largest noise floor, which the check reports beside them; the loss, the params after
# 2 steps and the fp32 check keep TRAIN_TOL and FP32_TOL.  With each path's own argmax,
# 53-108 of 4,096 rows flip in bf16 (0-1 in fp32, where one flip moved phi3-medium-14b's
# gradients by 2.4e-3), and rwkv6-1.6b's and zamba2-7b's gradients differed by 1.03e-1
# and 9.6e-2, their floors 7.1e-2 and 4.0e-2
BF16_GRAD_TOL = 5e-2
TRAIN_ARCH, TRAIN_B, TRAIN_T, TRAIN_STEPS = "minicpm-2b", 2, 2048, 4
# (g): run C checkpoints every 2 steps and crashes after step 3; minicpm-2b cut
# to TRAINER_LAYERS of its 40 layers at full width (a 7.4 GB checkpoint: the
# 38.2 GB one of all 40 layers took 155 s to save and restore to a local
# directory on an H100 80GB HBM3 at 700 W, and doubled the script's time).  The
# simulated cluster holds three replicas in host memory, with buffers about 5x
# the bytes written: the host must have HOST_MARGIN times the checkpoint free
TRAINER_CKPT_EVERY, TRAINER_CRASH_AT, TRAINER_LAYERS, HOST_MARGIN = 2, 3, 4, 6.0
# (g)'s data disks: build_cluster's 4 GiB overflow on the fullest disk under the
# 7.38 GB checkpoint's replicas (DiskFull on an H100 host; each file goes to one random
# partition, so the fill is lumpy), so the disks are doubled until one of them could
# hold a replica of every byte (g) writes (checkpoint, and the dataset within
# TRAINER_DATA_BYTES): a node holds at most one replica of any byte, so that always fits
TRAINER_DISK_BYTES, TRAINER_DATA_BYTES = 4 << 30, 1 << 20
# (h): mixtral-8x22b keeps as many layers as fit the card beside this much
# for the serving wave's activations, MoE buffers and checks
MOE_ARCH, MOE_HEADROOM_BYTES = "mixtral-8x22b", 24e9
# (d2): the five archs that (d) and (h) do not serve, each at full width in bf16, cut to
# the most layers that fit the card beside MOE_HEADROOM_BYTES (reckoned from
# param_count()) and whose init fits it (depth_cut): one wave of EXTRA_REQUESTS
# requests, prompts drawn from EXTRA_PROMPT_LENGTHS, EXTRA_MAX_NEW new tokens each
# (fewer, shorter and shorter-lived than (d)'s 8 requests of 1024-2048 tokens and 32 new
# ones, to keep the script within its time limit), then (d)'s consistency checks in
# bf16 at T=512
EXTRA_SERVE = ("phi3-medium-14b", "qwen1.5-32b", "musicgen-large", "chameleon-34b",
               "arctic-480b")
EXTRA_REQUESTS, EXTRA_PROMPT_LENGTHS, EXTRA_MAX_NEW = 4, (256, 513), 8
# the init's own room: at 2 layers arctic-480b's init held 3 (81.7 GB) and ran out of
# memory on an H100 80GB HBM3 (700 W)
INIT_SPARE_BYTES = 4e9
# (m): the launchers at the reference's reduced configs, on the card: every arch
LAUNCH_ARCHS = tuple(ARCH_NAMES)
# (f2): the attention archs that (f) does not train, each at full width in bf16 with its
# config's own optimizer, cut in depth only to the layers whose training state fits the
# card (train_depth_cut), then held to the plain path at CHECK_LAYERS layers or fewer
# (check_depth_cut).  arctic-480b has no (f2) run: one layer is 13.611 B params at 8
# bytes each (bf16 param, grad and two moments, no master weights), 108.9 GB
F2_ARCHS = ("codeqwen1.5-7b", "phi3-medium-14b", "musicgen-large", "qwen1.5-32b",
            "chameleon-34b", "mixtral-8x22b")
CHECK_LAYERS = 4
# room the depth rules leave for one layer's working set under remat (its recompute,
# its activations' gradients) and the allocator's blocks
TRAIN_SPARE_BYTES = 8e9
# (j): the mesh train step's steps (params compared after the second); the
# rendezvous's and every collective's time limit; the bytes a value that
# compress_tree must move at least (read bf16 g and fp32 r, write bf16 deq
# and fp32 r), and its rounding noise's read (4)
MESH_TRAIN_STEPS, PG_TIMEOUT_S, COMPRESS_BYTES, NOISE_BYTES = 3, 60, 12, 4
MESH_NAMED_OPS = ("nccl", "Memcpy", "copy", "fill", "zero")
# (j4): the served models whose first wave of (d) also runs placed on the mesh, each
# with its decode steps (zamba2-7b and rwkv6-1.6b fewer: a placed decode step costs
# host time a layer)
PLACED_STEPS = {"codeqwen1.5-7b": 31, "zamba2-7b": 16, "rwkv6-1.6b": 16}
# (d3): the published Zamba2-7B, whole, and the decode cell's shapes its kernels take there:
# a wave of 32 prompts of up to 2,048 tokens, 2,304 cache slots, about 2,100 of them valid
PUB_ARCH, PUB_CELL = "zamba2-7b-instruct", (32, 2048, 2304, 2100)
# (i): rwkv6-1.6b whole; zamba2-7b cut to SSM_TRAIN_LAYERS of its 81 layers (a multiple
# of its attn_every, so every shared-block site is whole); kernel vs plain training at
# SSM_CHECK_LAYERS layers
SSM_TRAIN = ("rwkv6-1.6b", "zamba2-7b")
SSM_TRAIN_LAYERS = {"zamba2-7b": 36}
SSM_CHECK_LAYERS = {"rwkv6-1.6b": 2, "zamba2-7b": 6}
# (j1): their mesh train step at full width, cut to these layers (zamba2-7b's 6: one
# site of its shared block, so that K1 and K1-bwd run placed too)
SSM_MESH_LAYERS, SSM_MESH_STEPS = {"rwkv6-1.6b": 4, "zamba2-7b": 6}, 2
SCAN_SOURCES = ("rwkv6_scan", "mamba2_ssd", "rwkv6_scan_bwd", "mamba2_ssd_bwd")
KERNELS = {"flash_attention_fwd": flash_attention_fwd,
           "flash_attention_bwd": flash_attention_bwd, "checksum": checksum_kernel,
           "ssd_fwd": ssd_fwd, "wkv6_fwd": wkv6_fwd, "ssd_bwd": ssd_bwd, "wkv6_bwd": wkv6_bwd,
           "decode_attention": decode_kernel, "mamba2_step": step_kernel}
PLAIN_OPS = {       # the plain forms are differentiable: their backward is autograd's
    "flash_attention": lambda q, k, v, window=0, q_offset=0, scale=None: ref.flash_attention(
        q, k, v, q_offset=q_offset, window=window, scale=scale),
    "mamba2_ssd": ref.mamba2_ssd,
    "wkv6": ref.rwkv6_chunked,
    "takes_decode_attention": lambda q, cache: False,     # the model's einsums
    "decode_attention": ref.decode_attention,             # the published Zamba2's decode
    "mamba2_step": ref.mamba2_step,
}


def _half_chunk(fn, default: int):
    """A plain chunked scan at half the chunk it is called with: the same function,
    summed in another order."""
    def call(*args, chunk=default):
        if len(args) > 6:
            args, chunk = args[:6], args[6]
        return fn(*args, chunk=chunk // 2)
    return call


# the plain forms summed in another order: the scans at half the chunk, the flash
# attention at half its query and key blocks
PLAIN_HALF_CHUNK = {
    **PLAIN_OPS, "mamba2_ssd": _half_chunk(ref.mamba2_ssd, 128),
    "wkv6": _half_chunk(ref.rwkv6_chunked, 64),
    "flash_attention": lambda q, k, v, window=0, q_offset=0, scale=None: ref.flash_attention(
        q, k, v, q_offset=q_offset, window=window, block_q=256, block_k=512, scale=scale)}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


@contextlib.contextmanager
def plain_ops(routes=PLAIN_OPS):
    """``ops`` routed to the plain versions for the duration, and checked to
    launch no kernel."""
    before = launches()
    saved = {name: getattr(ops, name) for name in routes}
    for name, fn in routes.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    if launches() != before:
        raise AssertionError("the plain path launched a kernel")


# ------------------------------------------------------------------ (a) device

def device_line() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs "
                 "an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ (b) build

def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {n: n for n in names}
    return {n: d.replace("(anonymous namespace)::", "").split("(")[0]
            for n, d in zip(names, out)}


def kernel_resources(source: str) -> dict:
    """Per kernel of a built source: tensor-core instructions in its SASS
    (cuobjdump) and the registers and spill bytes ptxas reported."""
    sass, usage = _build.sass_counts(source), _build.ptxas_usage(source)
    names = _demangle(sorted(sass))
    return {names[n]: {**sass[n], **usage.get(n, {})} for n in sorted(sass)}


def tensor_core_proof() -> dict:
    """The bf16 flash forward must issue wgmma (HGMMA) and the bf16 backward
    mma.sync or wgmma (HMMA/HGMMA); the fp32 flash instantiations none; every
    kernel of the fp32 scans, forward and backward, HMMA or HGMMA (TF32), but the
    backward's sums over partials (``*reduce*``), which have no products; no scan
    kernel spills."""
    res = {src: kernel_resources(src)
           for src in ("flash_attention", "flash_attention_bwd", *SCAN_SOURCES)}

    def count(src, kernels, opcodes):
        return sum(r[op] for name, r in res[src].items() for op in opcodes
                   if any(k in name for k in kernels))
    proof = {"fwd_bf16_HGMMA": count("flash_attention", ("flash_fwd_sm90",), ("HGMMA",)),
             "bwd_bf16_HMMA_HGMMA": count("flash_attention_bwd", ("dkdv_mma", "dq_mma"),
                                          ("HMMA", "HGMMA")),
             "fp32_HMMA_HGMMA": count("flash_attention", ("flash_fwd_kernel",), ("HMMA", "HGMMA"))
             + count("flash_attention_bwd", ("dkdv_kernel", "dq_kernel"), ("HMMA", "HGMMA")),
             **{f"{src}_HMMA_HGMMA": count(src, ("",), ("HMMA", "HGMMA"))
                for src in SCAN_SOURCES}}
    log(f"  tensor cores: {json.dumps(proof)}")
    for src, kernels in res.items():
        for name, r in kernels.items():
            log(f"  {src}: {name}: {json.dumps(r)}")
    if proof["fwd_bf16_HGMMA"] == 0 or proof["bwd_bf16_HMMA_HGMMA"] == 0:
        raise AssertionError(f"a bf16 flash kernel issues no tensor-core instruction: {proof}")
    if proof["fp32_HMMA_HGMMA"]:
        raise AssertionError(f"an fp32 flash kernel issues tensor-core instructions: {proof}")
    for src in SCAN_SOURCES:
        idle = [n for n, r in res[src].items()
                if r["HMMA"] + r["HGMMA"] == 0 and "reduce" not in n]
        spills = {n: r for n, r in res[src].items()
                  if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
        if idle or spills:
            raise AssertionError(f"{src}: kernels without tensor-core instructions {idle}, "
                                 f"or spilling {spills}")
    return {"counts": proof, "kernels": res}


# ------------------------------------------------------------------ (c) kernels

def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_name(key: str) -> str:
    return key.replace("(anonymous namespace)::", "").split("(")[0]


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` launches (torch.profiler),
    without the host's work between them."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = _kernel_name(e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / iters / 1e3
    return out


def device_ms(fn, iters: int) -> float:
    """Device time of ``fn``'s kernels per call."""
    return sum(device_ms_by_kernel(fn, iters).values())


def bound(flops: int, nbytes: int, dtype) -> dict:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def flash_case(b, tq, tk, kv, g, hd, window, q_offset, dtype, seed, timed=False, scale=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, tq, kv, g, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dtype)
    out, lse = flash_attention_fwd(q, k, v, window=window, q_offset=q_offset, scale=scale)
    torch.cuda.synchronize()
    want, want_lse = ref._flash_fwd_impl(q, k, v, q_offset, window, 512, 1024, scale)
    tol = TOL[dtype]
    err = (out.float() - want.float()).abs()
    lse_err = (lse - want_lse).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all()
              and (lse_err <= 2e-3 + 2e-3 * want_lse.abs()).all()
              and torch.isfinite(out).all())
    case = {"shape": {"B": b, "Tq": tq, "Tk": tk, "KV": kv, "G": g, "hd": hd},
            "window": window, "q_offset": q_offset, "scale": scale,
            "dtype": str(dtype).split(".")[-1],
            "max_abs_err": float(err.max()), "lse_max_abs_err": float(lse_err.max()),
            "tolerance": tol, "ok": ok}
    log(f"  flash case {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version: {case}")
    if timed:
        case.update(bound(*flash_fwd_work(b, tq, tk, kv, g, hd, window, q_offset,
                                          q.element_size()), dtype))
        case["ms"] = cuda_ms(lambda: flash_attention_fwd(q, k, v, window, q_offset, scale), 20)
        case["plain_ms"] = cuda_ms(
            lambda: ref._flash_fwd_impl(q, k, v, q_offset, window, 512, 1024, scale), 5)
        if not (g == 1 and window == 0 and q_offset == 0 and tq == tk):
            raise ValueError("the SDPA yardstick computes plain causal MHA only")
        qs, ks, vs = (x.reshape(b, x.shape[1], kv, hd).transpose(1, 2).contiguous()
                      for x in (q, k, v))
        case["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=scale), 20)
        log(f"  flash timed {json.dumps(case)}")
    return case


def _scan_errors(got, want):
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float(((g - w).abs() / (1 + w.abs())).max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    return abs_err, rel_err, finite


def scan_case(name, kernel, plain, inputs, shape, work=None, note=None):
    got = kernel(*inputs)
    torch.cuda.synchronize()
    want = plain(*inputs)
    abs_err, rel_err, finite = _scan_errors(got, want)
    again = kernel(*inputs)
    rerun_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    case = {"shape": shape, **({"inputs": note} if note else {}), "max_abs_err": abs_err,
            "max_rel_err": rel_err, "tolerance": SCAN_TOL, "rerun_bit_identical": rerun_equal,
            "ok": finite and rel_err <= SCAN_TOL and rerun_equal}
    log(f"  {name} case {json.dumps(case)}")
    if not case["ok"]:
        raise AssertionError(f"{name} kernel disagrees with its plain version "
                             f"(y and final state), or a rerun differs: {case}")
    if work is not None:
        flops, trans, nbytes = work
        case.update(bound(flops, nbytes, "tf32"), exps=trans,
                    bound_ms_fp32_cuda_cores=bound(flops, nbytes, torch.float32)["bound_ms"])
        case["ms"] = cuda_ms(lambda: kernel(*inputs), 20)
        case["plain_ms"] = cuda_ms(lambda: plain(*inputs), 3, warmup=1)
        case["library_ms"] = None     # no single PyTorch call computes the scan
        log(f"  {name} timed {json.dumps(case)}")
    return case


def wkv6_inputs(seed, b, t, h, d=64, strong=False):
    """tests/test_kernels_pallas.py's value ranges, and a nonzero state.  ``strong``:
    decays w = e^-U(0, 69) spread down to the reference's 1e-30 clamp, and w = 0 in
    every 16th key column, where the chunk's factors underflow."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")
    r, k, v = n(b, t, h, d) * 0.5, n(b, t, h, d) * 0.5, n(b, t, h, d) * 0.5
    w = torch.sigmoid(n(b, t, h, d) - 1.0)
    if strong:
        w = torch.exp(-69.0 * torch.rand((b, t, h, d), generator=gen, device="cuda"))
        w[..., ::16] = 0.0
    return r, k, v, w, n(h, d) * 0.3, n(b, h, d, d) * 0.2


def ssd_inputs(seed, b, t, h, p=64, n=64, strong=False):
    """``strong``: A scaled by 50, so that e^cl underflows within a chunk."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x, dt, A = r(b, t, h, p) * 0.5, F.softplus(r(b, t, h) - 1.0), -r(h).abs()
    return (x, dt, A * 50.0 if strong else A, r(b, t, n) * 0.5, r(b, t, n) * 0.5,
            r(b, h, p, n) * 0.2)


def grouped_ssd_inputs(seed, b, t, h, groups, p=64, n=64):
    """``ssd_inputs`` with B and C [Bt,T,G,N], head h reading group h // (H/G)."""
    x, dt, A, _, _, s = ssd_inputs(seed, b, t, h, p, n)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    B, C = (torch.randn((b, t, groups, n), generator=gen, device="cuda") * 0.5 for _ in range(2))
    return x, dt, A, B, C, s


def step_case(b, h, p, n, groups, seed, timed=False):
    """K6 against ``ref.mamba2_step`` on the same inputs (a token's bf16 in_proj output,
    conv tail and weights, the fp32 state and per-head parameters at the published
    block's scales), two steps running: the output and the state within the bf16
    tolerance, the conv tail bit for bit.  Timed: beside its byte bound and the plain
    version's ~27 launches."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    bf, din = torch.bfloat16, h * p
    c = din + 2 * groups * n
    xs = [r(b, din + c + h).to(bf), r(b, c, 3).to(bf), (r(4, c) * 0.2).to(bf),
          (r(c) * 0.02).to(bf), r(h) - 4.0,
          -torch.arange(1, h + 1, dtype=torch.float32, device="cuda"),
          torch.ones(h, device="cuda"), r(b, h, p, n) * 0.2, (1 + 0.1 * r(din)).to(bf),
          groups, 1e-5]
    mine = [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
    tol, abs_errs, tails, ok = TOL[bf], [], [], True
    for _ in range(2):
        out = step_kernel(*mine)
        want = ref.mamba2_step(*xs)
        torch.cuda.synchronize()
        for a, w in ((out, want), (mine[7], xs[7])):
            a, w = a.float(), w.float()
            err = (a - w).abs()
            abs_errs.append(float(err.max()))
            ok = ok and bool((err <= tol + tol * w.abs()).all() and torch.isfinite(a).all())
        tails.append(bool(torch.equal(mine[1], xs[1])))
    case = {"shape": {"B": b, "H": h, "P": p, "N": n, "G": groups},
            "dtype": "bf16 u, conv and weights; fp32 state", "max_abs_err": max(abs_errs),
            "tolerance": tol, "conv_tail_bit_identical": all(tails), "ok": ok and all(tails)}
    log(f"  step case {json.dumps(case)}")
    if not case["ok"]:
        raise AssertionError(f"mamba2_step kernel disagrees with its plain version: {case}")
    if timed:
        case.update(bound(*mamba2_step_work(b, h, p, n, groups), torch.float32))
        case["ms"] = cuda_ms(lambda: step_kernel(*mine), 50)
        case["plain_ms"] = cuda_ms(lambda: ref.mamba2_step(*xs), 10)
        case["library_ms"] = None       # no single PyTorch call computes the step
        log(f"  step timed {json.dumps(case)}")
    return case


# the scans' backward: each wrapper's source and its CUDA kernels, in the order of the
# source's <name>_occupancy
SCAN_BWD = {"wkv6_bwd": ("rwkv6_scan_bwd", ("wkv6_bwd_state_kernel", "wkv6_bwd_chunk_kernel",
                                            "wkv6_bwd_du_reduce_kernel")),
            "ssd_bwd": ("mamba2_ssd_bwd", ("ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel",
                                           "ssd_bwd_reduce_kernel", "ssd_bwd_dA_reduce_kernel"))}


def scan_sizes(name: str, shape: dict) -> tuple:
    """The compiled sizes a scan kernel's call takes: (K,) for WKV6, (P, N) for SSD."""
    return (shape["K"],) if name.startswith("wkv6") else (shape["P"], shape["N"])


def bwd_occupancy(name: str, sizes: tuple) -> dict:
    """Per CUDA kernel of a scan's backward at its compiled ``sizes``: its threads and
    dynamic shared memory a block and the blocks an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    source, kernels = SCAN_BWD[name]
    fn = getattr(_build.load(source), f"{name}_occupancy")
    fn.argtypes = [ctypes.c_int] * (1 + len(sizes)) + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = {}
    for i, kernel in enumerate(kernels):
        vals = [ctypes.c_int() for _ in range(3)]
        rc = fn(*sizes, i, *(ctypes.byref(v) for v in vals))
        if rc:
            raise RuntimeError(f"{name}_occupancy({i}) failed: cudaError {rc}")
        out[kernel] = dict(zip(("threads", "smem_bytes", "blocks_per_sm"),
                               (v.value for v in vals)))
    return out


def bwd_workspace(name: str, b: int, t: int, h: int, sizes: tuple) -> dict:
    """A scan backward's workspace (the size its wrapper allocates) and the bytes it adds
    to the inputs and outputs: each chunk's state gradient written and read once, the
    forward's chunk states read once, and the partial sums written and read once (the
    state, K x V = sizes[0]^2 or P x N, is saved every 64 rows)."""
    source, _ = SCAN_BWD[name]
    fn = getattr(_build.load(source), f"{name}_workspace_floats")
    fn.argtypes = [ctypes.c_int] * (3 + len(sizes))
    fn.restype = ctypes.c_longlong
    nc = -(-t // 64)
    rows, cols = (sizes[0], sizes[0]) if name == "wkv6_bwd" else sizes
    states = 4 * b * nc * h * rows * cols
    parts = (4 * b * nc * h * rows if name == "wkv6_bwd"
             else 4 * (2 * b * -(-h // 8) * t * cols + b * nc * h))
    return {"workspace_bytes": 4 * fn(b, t, h, *sizes),
            "workspace_traffic_bytes": 3 * states + 2 * parts}


def scan_bwd_case(name, fwd, bwd, plain_bwd, inputs, shape, work=None, note=None, seed=0,
                  w_index=None):
    """A scan's backward kernel on the forward kernel's chunk states against the plain
    backward (autograd through the chunked form), for random cotangents of y and of the
    final state.  ``w_index``: that input's gradient is held as w * dw (strong decays:
    dw = dlog w / w multiplies the rounding of dlog w by up to 1e30), and must be 0
    exactly where w < 1e-30.  Beside the errors, the plain backward at half the chunk
    against itself: the same function in another order, the inputs' own noise floor."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x0, state = inputs[0], inputs[5]
    y_shape = x0.shape[:3] + (state.shape[-1] if name == "wkv6_bwd" else x0.shape[-1],)
    dy = torch.randn(y_shape, generator=gen, device="cuda")
    ds = torch.randn(state.shape, generator=gen, device="cuda") * 0.5
    _, _, states = fwd(*inputs, chunk_states=True)
    got = bwd(*inputs[:5], states, dy, ds)
    torch.cuda.synchronize()
    want = plain_bwd(*inputs, dy, ds)
    half = plain_bwd(*inputs, dy, ds, chunk=shape["chunk"] // 2)

    def held(grads):     # the gradients as compared: w * dw in place of dw for w_index
        return [g * inputs[i] if i == w_index else g for i, g in enumerate(grads)]

    def rel_errs(grads):
        return [float(((g - w).abs() / (1 + w.abs())).max())
                for g, w in zip(held(grads), held(want))]

    abs_err, rel_err, finite = _scan_errors(held(got), held(want))
    clamped_zero = (w_index is None
                    or bool((got[w_index][inputs[w_index] < 1e-30] == 0).all()))
    noise = rel_errs(half)
    del half
    again = bwd(*inputs[:5], states, dy, ds)
    rerun_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    case = {"shape": shape, **({"inputs": note} if note else {}), "max_abs_err": abs_err,
            "max_rel_err": rel_err, "rel_err_by_grad": rel_errs(got),
            "plain_half_chunk_rel_err": max(noise), "plain_half_chunk_rel_err_by_grad": noise,
            "tolerance": SCAN_TOL, "rerun_bit_identical": rerun_equal,
            "ok": finite and rel_err <= SCAN_TOL and rerun_equal and clamped_zero}
    if w_index is not None:
        case["dw_zero_where_w_below_1e-30"] = clamped_zero
        case["dw_compared_as"] = "w * dw"
    log(f"  {name} case {json.dumps(case)}")
    if not case["ok"]:
        raise AssertionError(f"{name} kernel disagrees with the plain backward, or a rerun "
                             f"differs: {case}")
    if work is not None:
        flops, trans, nbytes = work
        case.update(bound(flops, nbytes, "tf32"), exps=trans,
                    bound_ms_fp32_cuda_cores=bound(flops, nbytes, torch.float32)["bound_ms"])
        call = lambda: bwd(*inputs[:5], states, dy, ds)
        case["ms"] = cuda_ms(call, 10)
        case["sub_kernel_device_ms"] = device_ms_by_kernel(call, 10)
        case["occupancy"] = bwd_occupancy(name, scan_sizes(name, shape))
        case.update(bwd_workspace(name, shape.get("B", shape.get("Bt")), shape["T"], shape["H"],
                                  scan_sizes(name, shape)))
        case["bound_ms_with_workspace"] = ((nbytes + case["workspace_traffic_bytes"])
                                           / HBM_BYTES_S * 1e3)
        case["plain_ms"] = cuda_ms(lambda: plain_bwd(*inputs, dy, ds), 2, warmup=1)
        case["library_ms"] = None     # no single PyTorch call computes the scan's backward
        log(f"  {name} timed {json.dumps(case)}")
    return case


def flash_bwd_case(b, t, kv, g, hd, window, q_offset, dtype, seed, tk=None, timed=False):
    """K1-bwd on the forward kernel's out and lse, against ref._flash_bwd_impl
    on the plain forward's own lse, so a wrong lse from K1 shows here too."""
    tk = tk or t
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, t, kv, g, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dtype)
    do = torch.randn((b, t, kv, g, hd), generator=gen, device="cuda").to(dtype)
    out, lse = flash_attention_fwd(q, k, v, window=window, q_offset=q_offset)
    got = flash_attention_bwd(q, k, v, out, lse, do, window, q_offset)
    torch.cuda.synchronize()
    _, want_lse = ref._flash_fwd_impl(q, k, v, q_offset, window, 512, 1024)
    want = ref._flash_bwd_impl(q, k, v, want_lse, do, q_offset, window, 512, 1024)
    del want_lse
    tol = TOL[dtype]
    errs = [(x.float() - w.float()).abs() for x, w in zip(got, want)]
    ok = all(bool((e <= tol + tol * w.float().abs()).all()) and bool(torch.isfinite(x).all())
             for e, w, x in zip(errs, want, got))
    case = {"shape": {"B": b, "Tq": t, "Tk": tk, "KV": kv, "G": g, "hd": hd},
            "window": window, "q_offset": q_offset, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": max(float(e.max()) for e in errs),
            "max_abs_err_dq_dk_dv": [float(e.max()) for e in errs],
            "grad_absmax_dq_dk_dv": [float(w.float().abs().max()) for w in want],
            "tolerance": tol, "ok": ok}
    log(f"  flash bwd case {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"flash backward kernel disagrees with its plain version: {case}")
    if timed:
        case.update(bound(*flash_bwd_work(b, t, tk, kv, g, hd, window, q_offset,
                                          q.element_size()), dtype))
        case["ms"] = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, window,
                                                         q_offset), 10)
        case["plain_ms"] = cuda_ms(
            lambda: ref._flash_bwd_impl(q, k, v, lse, do, q_offset, window, 512, 1024), 3,
            warmup=1)
        if not (g == 1 and window == 0 and q_offset == 0 and t == tk):
            raise ValueError("the SDPA yardstick computes plain causal MHA only")
        qs, ks, vs = (x.reshape(b, x.shape[1], kv, hd).transpose(1, 2).contiguous()
                      .requires_grad_() for x in (q, k, v))
        o_s = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        do_s = do.reshape(b, t, kv, hd).transpose(1, 2).contiguous()
        # SDPA's backward alone (its forward ran above), as device time: called
        # eagerly, autograd's host work per call shows in an event timing on a slow
        # host (0.34-0.71 ms over four H100 machines for the same device work)
        sdpa_bwd = lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True)
        case["library_eager_ms"] = cuda_ms(sdpa_bwd, 10)
        case["library_ms"] = device_ms(sdpa_bwd, 10)
        log(f"  flash bwd timed {json.dumps(case)}")
    return case


def decode_case(b, smax, kv, g, hd, n_valid, q_dtype, seed, timed=False, scale=None):
    """K5 against the plain version in fp32 on the same bf16 cache, whose slots
    past n_valid hold NaN in the kernel's copy (a read of one would show).  Timed:
    beside its byte bound, the model's plain path (``ref.decode_attention`` on the
    bf16 inputs: its einsums over every slot, masked) and SDPA over the valid
    slots, laid out for it beforehand (a yardstick the port never calls)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, kv * g, hd), generator=gen, device="cuda").to(q_dtype)
    kc, vc = (torch.randn((b, smax, kv, hd), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    want = ref.decode_attention(q.float(), kc.float(), vc.float(), n_valid, scale)
    k, v = kc.clone(), vc.clone()
    k[:, n_valid:] = v[:, n_valid:] = float("nan")
    out = decode_kernel(q, k, v, n_valid, scale)
    torch.cuda.synchronize()
    tol = TOL[q_dtype]
    err = (out.float() - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all() and torch.isfinite(out).all())
    case = {"shape": {"B": b, "Smax": smax, "KV": kv, "G": g, "hd": hd, "n_valid": n_valid},
            "scale": scale, "dtype": f"q {str(q_dtype).split('.')[-1]}, cache bfloat16",
            "max_abs_err": float(err.max()), "tolerance": tol, "ok": ok}
    log(f"  decode case {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"decode kernel disagrees with its plain version: {case}")
    if timed:
        case.update(bound(*decode_attention_work(b, n_valid, kv, g, hd, q.element_size()),
                          torch.float32))
        case["ms"] = cuda_ms(lambda: decode_kernel(q, k, v, n_valid, scale), 50)
        case["plain_ms"] = cuda_ms(lambda: ref.decode_attention(q, kc, vc, n_valid, scale), 10)
        qs = q.reshape(b, kv * g, 1, hd)
        ks, vs = (x[:, :n_valid].transpose(1, 2).contiguous() for x in (kc, vc))
        case["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=g > 1, scale=scale), 50)
        del ks, vs
        log(f"  decode timed {json.dumps(case)}")
    return case


def checksum_case(n, block, seed, timed=False):
    """K2 against ref.checksum, bit for bit; a changed word must change it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    got = checksum_kernel(words, block)
    want = ref.checksum(words, block)
    ok = bool(torch.equal(got, want))
    if n:
        words[n // 3] ^= 1
        ok = ok and not torch.equal(checksum_kernel(words, block), got)
        words[n // 3] ^= 1
    case = {"shape": {"n": n}, "block": block, "digest": got.tolist(),
            "max_abs_err": float((got - want).abs().max()), "tolerance": 0, "ok": ok}
    log(f"  checksum case {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"checksum kernel disagrees with its plain version or misses "
                             f"a changed word: {case}")
    if timed:
        # each word read once; its two integer multiply-adds are not bound by an
        # operation rate (the table of peaks gives none for 32-bit integers)
        case.update(bound(*checksum_work(n), torch.float32), int_ops=4 * n)
        case["ms"] = cuda_ms(lambda: checksum_kernel(words, block), 20)
        case["plain_ms"] = cuda_ms(lambda: ref.checksum(words, block), 3, warmup=1)
        case["library_ms"] = None     # no single PyTorch call computes the digest
        log(f"  checksum timed {json.dumps(case)}")
    return case


def phase_kernels():
    log("(c) kernels vs their plain versions on the card")
    flash = {"main": flash_case(4, 2048, 2048, 32, 1, 128, 0, 0, torch.bfloat16, 10,
                                timed=True),
             # zamba2-7b's shared attention block: 32 heads of 112
             "hd112": flash_case(4, 2048, 2048, 32, 1, 112, 0, 0, torch.bfloat16, 13,
                                 timed=True),
             # minicpm-2b's training shape: 36 heads of 64
             "train_hd64": flash_case(TRAIN_B, TRAIN_T, TRAIN_T, 36, 1, 64, 0, 0,
                                      torch.bfloat16, 14, timed=True),
             # mixtral-8x22b's serving wave: 48 heads of 128 over 8 kv heads, its
             # 4096 window biting on a 5862-token prompt
             "mixtral_window": flash_case(4, 5862, 5862, 8, 6, 128, 4096, 0,
                                          torch.bfloat16, 16),
             # a window, a q offset and G=4 in fp32 (SIMT kernel) and bf16 (wgmma kernel)
             "others": [flash_case(1, 1000, 1100, 2, 4, 64, 256, 100, torch.float32, 11),
                        flash_case(1, 1000, 1100, 2, 4, 64, 256, 100, torch.bfloat16, 15),
                        flash_case(2, 333, 333, 4, 2, 32, 0, 0, torch.bfloat16, 12)]}
    # the main-path shapes (rwkv6-1.6b: B=4, H=32, K=V=64; zamba2-7b: Bt=4,
    # H=112, P=N=64), then a ragged T and a T shorter than one chunk
    wkv6 = {"main": scan_case("wkv6", wkv6_fwd, ref.rwkv6_chunked,
                              wkv6_inputs(20, 4, 2048, 32),
                              {"B": 4, "T": 2048, "H": 32, "K": 64, "V": 64, "chunk": 64},
                              wkv6_work(4, 2048, 32, 64, 64)),
            "others": [scan_case("wkv6", wkv6_fwd, ref.rwkv6_chunked,
                                 wkv6_inputs(21 + t, 2, t, 32),
                                 {"B": 2, "T": t, "H": 32, "K": 64, "V": 64, "chunk": 64})
                       for t in (1000, 37, 65, 2049)]
            # T just past a 16-row sub-chunk and a chunk; strong decays down to 1e-30 and 0
            + [scan_case("wkv6", wkv6_fwd, ref.rwkv6_chunked, wkv6_inputs(24, 2, 17, 32),
                         {"B": 2, "T": 17, "H": 32, "K": 64, "V": 64, "chunk": 64}),
               scan_case("wkv6", wkv6_fwd, ref.rwkv6_chunked,
                         wkv6_inputs(25, 2, 300, 32, strong=True),
                         {"B": 2, "T": 300, "H": 32, "K": 64, "V": 64, "chunk": 64},
                         note="strong decays: w = e^-U(0,69), w = 0 in every 16th column")]}
    ssd = {"main": scan_case("ssd", ssd_fwd, ref.mamba2_ssd, ssd_inputs(30, 4, 2048, 112),
                             {"Bt": 4, "T": 2048, "H": 112, "P": 64, "N": 64, "chunk": 128},
                             ssd_work(4, 2048, 112, 64, 64, 128)),
           "others": [scan_case("ssd", ssd_fwd, ref.mamba2_ssd, ssd_inputs(31 + t, 2, t, 112),
                                {"Bt": 2, "T": t, "H": 112, "P": 64, "N": 64, "chunk": 128})
                      for t in (1000, 100, 33, 129, 2049)]
            # e^cl underflowing within a chunk
            + [scan_case("ssd", ssd_fwd, ref.mamba2_ssd, ssd_inputs(32, 2, 300, 112, strong=True),
                         {"Bt": 2, "T": 300, "H": 112, "P": 64, "N": 64, "chunk": 128},
                         note="strong decays: A scaled by 50")]}
    # the backward kernels at the training shapes (rwkv6-1.6b: B=2, H=32; zamba2-7b:
    # Bt=2, H=112), then a ragged T and strong decays, each with a nonzero initial state
    # and a nonzero cotangent of the final state
    wkv6_bwd_cases = {
        "main": scan_bwd_case("wkv6_bwd", wkv6_fwd, wkv6_bwd, ref.rwkv6_chunked_bwd,
                              wkv6_inputs(60, TRAIN_B, TRAIN_T, 32),
                              {"B": TRAIN_B, "T": TRAIN_T, "H": 32, "K": 64, "V": 64,
                               "chunk": 64}, wkv6_bwd_work(TRAIN_B, TRAIN_T, 32, 64, 64),
                              seed=60),
        "others": [scan_bwd_case("wkv6_bwd", wkv6_fwd, wkv6_bwd, ref.rwkv6_chunked_bwd,
                                 wkv6_inputs(61, 2, 1000, 32),
                                 {"B": 2, "T": 1000, "H": 32, "K": 64, "V": 64, "chunk": 64},
                                 seed=61),
                   scan_bwd_case("wkv6_bwd", wkv6_fwd, wkv6_bwd, ref.rwkv6_chunked_bwd,
                                 wkv6_inputs(62, 2, 300, 32, strong=True),
                                 {"B": 2, "T": 300, "H": 32, "K": 64, "V": 64, "chunk": 64},
                                 note="strong decays: w = e^-U(0,69), w = 0 in every 16th "
                                      "column", seed=62, w_index=3)]}
    ssd_bwd_cases = {
        "main": scan_bwd_case("ssd_bwd", ssd_fwd, ssd_bwd, ref.mamba2_ssd_bwd,
                              ssd_inputs(70, TRAIN_B, TRAIN_T, 112),
                              {"Bt": TRAIN_B, "T": TRAIN_T, "H": 112, "P": 64, "N": 64,
                               "chunk": 128}, ssd_bwd_work(TRAIN_B, TRAIN_T, 112, 64, 64, 128),
                              seed=70),
        "others": [scan_bwd_case("ssd_bwd", ssd_fwd, ssd_bwd, ref.mamba2_ssd_bwd,
                                 ssd_inputs(71, 2, 1000, 112),
                                 {"Bt": 2, "T": 1000, "H": 112, "P": 64, "N": 64,
                                  "chunk": 128}, seed=71),
                   scan_bwd_case("ssd_bwd", ssd_fwd, ssd_bwd, ref.mamba2_ssd_bwd,
                                 ssd_inputs(72, 2, 300, 112, strong=True),
                                 {"Bt": 2, "T": 300, "H": 112, "P": 64, "N": 64,
                                  "chunk": 128}, note="strong decays: A scaled by 50",
                                 seed=72)]}
    reduced = phase_scan_reduced()
    # minicpm-2b's training shape (36 heads of 64, bf16, causal), then fp32 at
    # hd 128 with G=2 and a ragged T, a window with a q offset, hd 112, and bf16 at hd 128
    # with the group sizes (f2) trains: G=6 (mixtral-8x22b, 48 heads over 8) and, at a
    # ragged T, G=8 (chameleon-34b, 64 over 8)
    flash_bwd = {"main": flash_bwd_case(TRAIN_B, TRAIN_T, 36, 1, 64, 0, 0, torch.bfloat16, 40,
                                        timed=True),
                 "others": [flash_bwd_case(1, 1000, 4, 2, 128, 0, 0, torch.float32, 41),
                            flash_bwd_case(1, 777, 2, 4, 64, 256, 323, torch.bfloat16, 42,
                                           tk=1100),
                            flash_bwd_case(2, 333, 4, 1, 112, 0, 0, torch.bfloat16, 43),
                            flash_bwd_case(1, 1024, 8, 6, 128, 0, 0, torch.bfloat16, 44),
                            flash_bwd_case(1, 1100, 8, 8, 128, 0, 0, torch.bfloat16, 45)]}
    # the int32 view of minicpm-2b's largest stacked bf16 leaf (layers.mlp.w1,
    # [40, 2304, 5760]), then tests/test_kernels_pallas.py's sizes and blocks
    # minicpm-2b's decode cell (B 32, 36 heads of 64, 2,304 slots, about 2,100 valid),
    # then n_valid at 1 and at Smax, and the served archs' head dims and groups:
    # zamba2-7b's shared block (hd 112), codeqwen1.5-7b (G 1), phi3-medium-14b (G 4),
    # mixtral-8x22b (G 6), arctic-480b (G 7), chameleon-34b (G 8), an fp32 q, and the
    # reduced configs (hd 32, G 4)
    bf, f32 = torch.bfloat16, torch.float32
    decode = {"main": decode_case(32, 2304, 36, 1, 64, 2100, bf, 80, timed=True),
              "others": [decode_case(*shape, seed=81 + i) for i, shape in enumerate((
                  (32, 2304, 36, 1, 64, 1, bf), (32, 2304, 36, 1, 64, 2304, bf),
                  (4, 4096, 32, 1, 112, 1795, bf), (4, 4096, 32, 1, 128, 4096, bf),
                  (4, 4096, 10, 4, 128, 2049, bf), (4, 4096, 8, 6, 128, 4000, bf),
                  (2, 700, 8, 7, 128, 333, bf), (2, 700, 8, 8, 128, 700, bf),
                  (2, 700, 8, 8, 128, 259, f32), (1, 150, 1, 4, 32, 149, bf)))]}
    cfg = get_arch(TRAIN_ARCH)
    checksum = {"main": checksum_case(cfg.n_layers * cfg.d_model * cfg.d_ff // 2, 4096, 50,
                                      timed=True),
                "others": [checksum_case(n, block, 51 + i) for i, (n, block) in
                           enumerate(((1000, 256), (4096, 4096), (10000, 512), (0, 4096)))]}
    return flash, flash_bwd, checksum, wkv6, ssd, wkv6_bwd_cases, ssd_bwd_cases, reduced, decode


def phase_scan_reduced() -> dict:
    """The scan kernels, forward and backward, at the reduced configs' sizes, which the
    launchers run: rwkv6-1.6b's K = V = 32 and zamba2-7b's (P, N) = (32, 16).  Timed at the
    full models' widths with these sizes (rwkv6-1.6b: 64 heads of 32; zamba2-7b: 224 heads
    of 32), then at the launchers' own shapes (B=2, T=32; 4 and 8 heads), a ragged T, a T
    shorter than one chunk, a head count that is not a multiple of K3-bwd's group of 8
    and strong decays."""
    strong_w = "strong decays: w = e^-U(0,69), w = 0 in every 16th column"
    wkv = lambda b, t, h: {"B": b, "T": t, "H": h, "K": 32, "V": 32, "chunk": 64}  # noqa: E731
    ssdp = lambda b, t, h: {"Bt": b, "T": t, "H": h, "P": 32, "N": 16, "chunk": 128}  # noqa: E731
    small = ((2, 32, None), (2, 1000, None), (2, 37, None))
    out = {
        "wkv6_fwd": {
            "main": scan_case("wkv6", wkv6_fwd, ref.rwkv6_chunked,
                              wkv6_inputs(80, 4, 2048, 64, d=32), wkv(4, 2048, 64),
                              wkv6_work(4, 2048, 64, 32, 64)),
            "others": [scan_case("wkv6", wkv6_fwd, ref.rwkv6_chunked,
                                 wkv6_inputs(81 + t, b, t, 4, d=32), wkv(b, t, 4))
                       for b, t, _ in small]
            + [scan_case("wkv6", wkv6_fwd, ref.rwkv6_chunked,
                         wkv6_inputs(85, 2, 300, 4, d=32, strong=True), wkv(2, 300, 4),
                         note=strong_w)]},
        "ssd_fwd": {
            "main": scan_case("ssd", ssd_fwd, ref.mamba2_ssd,
                              ssd_inputs(90, 4, 2048, 224, p=32, n=16), ssdp(4, 2048, 224),
                              ssd_work(4, 2048, 224, 32, 16, 128)),
            "others": [scan_case("ssd", ssd_fwd, ref.mamba2_ssd,
                                 ssd_inputs(91 + t, b, t, 8, p=32, n=16), ssdp(b, t, 8))
                       for b, t, _ in small]
            + [scan_case("ssd", ssd_fwd, ref.mamba2_ssd,
                         ssd_inputs(95, 2, 300, 8, p=32, n=16, strong=True), ssdp(2, 300, 8),
                         note="strong decays: A scaled by 50")]},
        "wkv6_bwd": {
            "main": scan_bwd_case("wkv6_bwd", wkv6_fwd, wkv6_bwd, ref.rwkv6_chunked_bwd,
                                  wkv6_inputs(100, TRAIN_B, TRAIN_T, 64, d=32),
                                  wkv(TRAIN_B, TRAIN_T, 64),
                                  wkv6_bwd_work(TRAIN_B, TRAIN_T, 64, 32, 64), seed=100),
            "others": [scan_bwd_case("wkv6_bwd", wkv6_fwd, wkv6_bwd, ref.rwkv6_chunked_bwd,
                                     wkv6_inputs(101 + t, b, t, 4, d=32), wkv(b, t, 4),
                                     seed=101 + t) for b, t, _ in small]
            + [scan_bwd_case("wkv6_bwd", wkv6_fwd, wkv6_bwd, ref.rwkv6_chunked_bwd,
                             wkv6_inputs(105, 2, 300, 4, d=32, strong=True), wkv(2, 300, 4),
                             note=strong_w, seed=105, w_index=3)]},
        "ssd_bwd": {
            "main": scan_bwd_case("ssd_bwd", ssd_fwd, ssd_bwd, ref.mamba2_ssd_bwd,
                                  ssd_inputs(110, TRAIN_B, TRAIN_T, 224, p=32, n=16),
                                  ssdp(TRAIN_B, TRAIN_T, 224),
                                  ssd_bwd_work(TRAIN_B, TRAIN_T, 224, 32, 16, 128), seed=110),
            "others": [scan_bwd_case("ssd_bwd", ssd_fwd, ssd_bwd, ref.mamba2_ssd_bwd,
                                     ssd_inputs(111 + t, b, t, h, p=32, n=16), ssdp(b, t, h),
                                     seed=111 + t)
                       for b, t, h in ((2, 32, 8), (2, 1000, 8), (2, 37, 8), (2, 129, 11))]
            + [scan_bwd_case("ssd_bwd", ssd_fwd, ssd_bwd, ref.mamba2_ssd_bwd,
                             ssd_inputs(115, 2, 300, 8, p=32, n=16, strong=True),
                             ssdp(2, 300, 8), note="strong decays: A scaled by 50", seed=115)]},
    }
    return out


# ------------------------------------------------------------------ (d) serving

def rel_close(a: torch.Tensor, b: torch.Tensor, tol: float):
    a, b = a.float(), b.float()
    err = float(((a - b).abs() / (1 + b.abs())).max())
    return err <= tol, err


def timed_api(api, stats):
    def wrap(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stats[name] += time.perf_counter() - t0
            return out
        return call
    return dataclasses.replace(api, prefill=wrap("prefill", api.prefill),
                               decode=wrap("decode", api.decode))


def decode_sites(cfg) -> int:
    """The layers that run attention (a hybrid's sites of its shared blocks), so the
    decode kernel's launches of one decode step over a bf16 cache."""
    if cfg.family == "ssm":
        return 0
    if zamba2.published(cfg):
        return len(zamba2.site_layers(cfg))
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def expected_launches(cfg) -> dict:
    """Kernel launches of one prefill wave: one per layer that runs a kernel."""
    if cfg.family == "ssm":
        return {"wkv6_fwd": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"ssd_fwd": cfg.n_layers, "flash_attention_fwd": decode_sites(cfg)}
    return {"flash_attention_fwd": cfg.n_layers}


def init_serving_params(api, dtype=torch.bfloat16):
    t0 = time.perf_counter()
    params = api.init(0, dtype, "cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"  init {n_params / 1e9:.3f} B params ({str(dtype).split('.')[-1]}) in "
        f"{time.perf_counter() - t0:.1f} s")
    return params, n_params


def phase_serving(arch: str, mesh=None):
    """(d) for ``arch``; and (j4) on ``mesh`` where one is given."""
    cfg = get_arch(arch)
    log(f"(d) serving {arch} at full width: {json.dumps(dataclasses.asdict(cfg))}")
    torch.cuda.reset_peak_memory_stats()
    api = get_model(cfg)
    params, n_params = init_serving_params(api)
    gen = torch.Generator().manual_seed(1)
    lengths = torch.randint(1024, 2049, (8,), generator=gen).tolist()
    prompts = draw_prompts(cfg, lengths, gen)
    serving = serve_requests(arch, cfg, api, params, n_params, prompts, smax=4096)
    serving["consistency"] = check_consistency(cfg, api, params, SERVE_TOL[arch])
    params32 = _tree_map(lambda x: x.float(), params)
    serving["consistency_fp32"] = check_consistency(cfg, api, params32, FP32_TOL)
    del params32
    free_device_memory()
    if mesh is not None:
        serving["placed"] = placed_wave(cfg, api, params, prompts[:4], mesh, smax=4096,
                                        steps=PLACED_STEPS[arch])
        free_device_memory()
    serving["profile"] = profile_wave(cfg, api, params, 4, max(lengths), 4096)
    serving["counts"] = prefill_counts(cfg, api, params, lengths, 4096)
    serving["phase_peak_mem_gb"] = max(torch.cuda.max_memory_allocated() / 1e9,
                                       serving["counts"]["peak_before_gb"])
    return serving


# ------------------------------------------------------------------ (d3) the published Zamba2

def phase_published(arch: str = PUB_ARCH) -> dict:
    """(d3): Zamba2-7B at its published widths and depth, the model of the benchmark's
    decode cell.  Its kernels against their plain versions at the cell's shapes (K1
    and K5 at head dim 224 with its softmax scale, K3 with B and C in 2 groups, K6),
    each timed; then one wave served through ``BatchServer``, every kernel's launches
    checked with the counters zeroed just before it (the decode steps' segments run as
    CUDA graphs from the second step on, each replay adding the launches it holds);
    the same wave served again with the graphs off, token for token; and the kernel
    path's logits against the plain paths' (``check_published``)."""
    cfg = get_arch(arch)
    log(f"(d3) serving {arch} at its published widths: {json.dumps(dataclasses.asdict(cfg))}")
    torch.cuda.reset_peak_memory_stats()
    bf, scale, G = torch.bfloat16, cfg.attn_scale, cfg.ssm_groups
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    nh = cfg.ssm_expand * cfg.d_model // P
    b, t, smax, n_valid = PUB_CELL
    kernels = {
        "flash_hd224": flash_case(b, t, t, cfg.n_kv_heads, 1, cfg.hd, 0, 0, bf, 90, timed=True,
                                  scale=scale),
        "decode_hd224": decode_case(b, smax, cfg.n_kv_heads, 1, cfg.hd, n_valid, bf, 91,
                                    timed=True, scale=scale),
        "ssd_groups2": scan_case("ssd", ssd_fwd, ref.mamba2_ssd,
                                 grouped_ssd_inputs(92, b, t, nh, G),
                                 {"Bt": b, "T": t, "H": nh, "P": P, "N": N, "G": G,
                                  "chunk": 128}, ssd_work(b, t, nh, P, N, 128, G)),
        "mamba2_step": step_case(b, nh, P, N, G, 93, timed=True)}
    free_device_memory()
    api = get_model(cfg)
    params, n_params = init_serving_params(api)
    gen = torch.Generator().manual_seed(6)
    prompts = draw_prompts(cfg, torch.randint(1024, 2049, (4,), generator=gen).tolist(), gen)
    serving = serve_requests(arch, cfg, api, params, n_params, prompts, smax=4096)
    serving["graphs_vs_eager"] = graphs_vs_eager(cfg, params, prompts, smax=4096)
    serving["consistency"] = check_published(cfg, api, params)
    serving["kernels"] = kernels
    serving["phase_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return serving


def graphs_vs_eager(cfg, params, prompts, smax: int, batch: int = 4, max_new: int = 32):
    """The same requests served twice through ``BatchServer``: its decode steps'
    segments as CUDA graphs, and with the server's graphs off.  The same tokens."""
    outs = []
    for graphed in (True, False):
        srv = BatchServer(cfg, params, batch=batch, smax=smax, device="cuda")
        if not graphed:
            srv.graphs = None
        done = srv.serve([Request(rid=i, prompt=p, max_new=max_new)
                          for i, p in enumerate(prompts)])
        outs.append([r.out for r in sorted(done, key=lambda r: r.rid)])
    res = {"requests": len(prompts), "max_new": max_new, "tokens_equal": outs[0] == outs[1]}
    log(f"  graphs vs eager: {json.dumps(res)}")
    if not res["tokens_equal"]:
        raise AssertionError(f"the graphed decode steps served other tokens: {res}")
    return res


def check_published(cfg, api, params, t: int = 512):
    """The kernel path's prefill and decode logits (bf16) against the plain paths' on
    an fp32 copy of the weights, held to twice the distance of the plain paths in
    bf16 from the same: both bf16 paths carry the rounding of 81 layers and a recurrent
    state, which no fixed tolerance bounds at these random weights, and a kernel that
    computed other than its plain version would stand out above it.  Each path
    prefills its own cache; all decode the kernel path's greedy next token."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b = 2
    toks = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")

    def run(p, nxt=None):
        logits_p, cache = api.prefill(p, toks, t + 8)
        nxt = logits_p[:, -1, :cfg.vocab].argmax(-1) if nxt is None else nxt
        logits_d, _ = api.decode(p, nxt[:, None], cache, t)
        return logits_p, logits_d, nxt

    with torch.inference_mode():
        kernel_p, kernel_d, nxt = run(params)
        with plain_ops():
            plain_p, plain_d, _ = run(params, nxt)
            params32 = _tree_map(lambda x: x.float(), params)
            want_p, want_d, _ = run(params32, nxt)
            del params32
    errs = {name: rel_close(got, want, math.inf)[1] for name, got, want in (
        ("kernel_prefill", kernel_p, want_p), ("plain_prefill", plain_p, want_p),
        ("kernel_decode", kernel_d, want_d), ("plain_decode", plain_d, want_d))}
    res = {"consistency_B": b, "consistency_T": t, "errors_vs_fp32_plain": errs,
           "rule": "kernel error <= 2 x the bf16 plain path's",
           "logit_absmax": float(want_p.float().abs().max())}
    log(f"  consistency: {json.dumps(res)}")
    ok = all(errs[f"kernel_{k}"] <= 2 * errs[f"plain_{k}"] for k in ("prefill", "decode"))
    if not (ok and torch.isfinite(kernel_d).all()):
        raise AssertionError(f"the published model's kernel path strays from its plain "
                             f"path: {res}")
    return res


def draw_prompts(cfg, lengths, gen):
    """A prompt of each length, its tokens drawn from ``gen``."""
    return [torch.randint(0, cfg.vocab, (n,), generator=gen).tolist() for n in lengths]


def serve_requests(arch, cfg, api, params, n_params, prompts, smax, batch=4, max_new=32):
    """Serves one request per prompt through ``BatchServer`` after a warm-up,
    and checks the kernels' launch counts and the outputs."""
    n_req = len(prompts)
    lengths = [len(p) for p in prompts]
    reqs = [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    srv = BatchServer(cfg, params, batch=batch, smax=smax, device="cuda")
    srv.serve([Request(rid=0, prompt=list(range(64)), max_new=2)])      # warm-up
    stats = {"prefill": 0.0, "decode": 0.0}
    srv.api = timed_api(srv.api, stats)
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    done = srv.serve(reqs)
    wall = time.perf_counter() - t0
    counts = launches()

    waves = -(-n_req // batch)
    want = {name: n * waves for name, n in expected_launches(cfg).items()}
    want["decode_attention"] = waves * (max_new - 1) * decode_sites(cfg)
    if zamba2.published(cfg):        # its Mamba2 decode step, once a layer a decode step
        want["mamba2_step"] = waves * (max_new - 1) * cfg.n_layers
    want = {name: want.get(name, 0) for name in KERNELS}
    if counts != want:
        raise AssertionError(f"{arch}: kernel launches on the serving path {counts}, "
                             f"expected {want} ({waves} waves)")
    if sorted(r.rid for r in done) != list(range(n_req)):
        raise AssertionError("not every request was served")
    for r in done:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"request {r.rid}: bad output {r.out}")
    padded = sum(batch * max(lengths[w * batch:(w + 1) * batch]) for w in range(waves))
    serving = {
        "arch": arch, "layers": cfg.n_layers, "params": n_params, "requests": n_req,
        "batch": batch, "smax": smax, "max_new": max_new, "prompt_lengths": lengths,
        "waves": waves, "launches": counts, "prompt_tokens": sum(lengths),
        "prefill_padded_tokens": padded,
        "prefill_s": stats["prefill"], "decode_s": stats["decode"], "wall_s": wall,
        "prefill_tok_s": sum(lengths) / stats["prefill"],
        "decode_tok_s": n_req * (max_new - 1) / stats["decode"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"  served: {json.dumps(serving)}")
    return serving


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@contextlib.contextmanager
def moe_routing(forced=()):
    """``moe._route`` patched for the block; yields (chosen, rerouted, dropped):
    each call's top-k experts ([tokens, k], tokens in flat B*T order), for each
    forced call how many tokens chose otherwise, and each call's dropped
    (token, choice) slots.  ``forced[i]`` is (token indices, experts [n, k])
    that replace call i's own choices for those tokens; their weights are
    renormalised from the call's own probabilities, and the slots counted by
    ``moe._slots`` as the port counts them."""
    chosen, rerouted, dropped = [], [], []
    saved = moe._route

    def route(cfg, router, xg, capacity):
        probs, top_w, top_e = moe._top_k(cfg, router, xg)
        flat = top_e.reshape(-1, cfg.top_k)
        if len(chosen) < len(forced):
            idx, experts = forced[len(chosen)]
            rerouted.append(int((flat[idx].sort(-1).values != experts.sort(-1).values)
                                .any(-1).sum()))
            flat = flat.clone()
            flat[idx] = experts
            top_e = flat.reshape(top_e.shape)
            w = probs.gather(-1, top_e)
            top_w = w / w.sum(-1, keepdim=True)
        chosen.append(flat)
        slots = moe._slots(cfg, top_e, capacity)
        dropped.append(int((~slots[2]).sum()))
        return (*slots, top_w)

    moe._route = route
    try:
        yield chosen, rerouted, dropped
    finally:
        moe._route = saved


@contextlib.contextmanager
def loss_argmax(forced=()):
    """``layers.cross_entropy`` for the block with the row max it adds back (with its
    gradient: a one-hot at the argmax, ROADMAP §3) gathered at each row's argmax;
    yields (chosen, flipped): each call's argmax, and for each forced call how many
    rows' own argmax differs from ``forced[i]``, which replaces it.  The value is
    the reference's; the gradient is too but where a row's largest logits tie
    exactly (``amax`` splits it among them)."""
    chosen, flipped = [], []
    saved = layers.cross_entropy

    def cross_entropy(logits, labels, vocab):
        logits = logits.float()
        if logits.shape[-1] > vocab:
            cols = torch.arange(logits.shape[-1], device=logits.device)
            logits = logits.masked_fill(cols >= vocab, -1e30)
        idx = logits.detach().argmax(-1, keepdim=True)
        if len(chosen) < len(forced):
            flipped.append(int((idx != forced[len(chosen)]).sum()))
            idx = forced[len(chosen)]
        chosen.append(idx)
        m = torch.gather(logits, -1, idx)
        logz = torch.log(torch.exp(logits - m.detach()).sum(-1)) + m[..., 0]
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return (logz - gold).mean()

    layers.cross_entropy = cross_entropy
    try:
        yield chosen, flipped
    finally:
        layers.cross_entropy = saved


@contextlib.contextmanager
def fp32_kv_cache():
    """The transformer's prefill allocates its KV cache in fp32, not bf16,
    for the block; decode writes and reads it in the cache's dtype."""
    saved = transformer.kv_cache_spec

    def spec(*args):
        return {name: (shape, torch.float32 if dt == torch.bfloat16 else dt)
                for name, (shape, dt) in saved(*args).items()}

    transformer.kv_cache_spec = spec
    try:
        yield
    finally:
        transformer.kv_cache_spec = saved


def check_consistency(cfg, api, params, tol: float, t: int = 512):
    """decode(prefill(x)) vs prefill(x + token) (tests/test_models_smoke.py), and
    kernel-path vs plain-path prefill and decode logits, on the full-width weights
    (the plain decode on the kernel decode's cache, after it: it writes the same
    slot with its own k/v before reading it).

    An MoE model (at a capacity factor with no drops) is held on shared expert
    choices: the top-k choice is a step function of the router's logits, and a
    one-ulp change flips it wherever two experts are nearly tied, which moves
    that token by an O(1) amount.  So the prefill of x + token takes the
    prefill of x's choices for x and decode's for the token, and the plain
    prefill takes the kernel prefill's; how many tokens would have chosen
    otherwise is reported by layer."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b = 2
    toks = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")
    with torch.inference_mode():
        with moe_routing() as (chosen_p, _, _):
            logits_p, cache = api.prefill(params, toks, t + 8)
        nxt = logits_p[:, -1, :cfg.vocab].argmax(-1)
        with moe_routing() as (chosen_d, _, _):
            logits_d, _ = api.decode(params, nxt[:, None], cache, t)
        with plain_ops(), moe_routing([(slice(None), d) for d in chosen_d]) as \
                (_, rerouted_plain_d, _):
            plain_d, _ = api.decode(params, nxt[:, None], cache, t)
        del cache
        ok_kd, err_kd = rel_close(logits_d, plain_d, tol)
        shared = [(slice(None), torch.cat([p.reshape(b, t, -1), d.reshape(b, 1, -1)], 1)
                   .reshape(b * (t + 1), -1)) for p, d in zip(chosen_p, chosen_d)]
        with moe_routing(shared) as (_, rerouted_full, _):
            full, _ = api.prefill(params, torch.cat([toks, nxt[:, None]], 1), t + 8)
        ok_d, err_d = rel_close(logits_d[:, 0], full[:, -1], tol)

        kernel_choices = [(slice(None), p) for p in chosen_p]
        with plain_ops(), moe_routing(kernel_choices) as (_, rerouted_plain, _):
            plain_p, _ = api.prefill(params, toks, t + 8)
        ok_k, err_k = rel_close(logits_p, plain_p, tol)
    res = {"weights": str(next(_leaves(params)).dtype).split(".")[-1],
           "consistency_B": b, "consistency_T": t, "tolerance": tol,
           "decode_vs_prefill_err": err_d, "kernel_vs_plain_prefill_err": err_k,
           "kernel_vs_plain_decode_err": err_kd,
           "logit_absmax": float(full.float().abs().max())}
    if chosen_p:
        res.update(capacity_factor=cfg.capacity_factor, tokens=b * t,
                   tokens_rerouted_by_layer={"prefill_x_plus_token": rerouted_full,
                                             "plain_prefill": rerouted_plain,
                                             "plain_decode": rerouted_plain_d})
    log(f"  consistency: {json.dumps(res)}")
    if not (ok_d and ok_k and ok_kd and torch.isfinite(logits_d).all()):
        raise AssertionError(f"full-width consistency check failed: {res}")
    return res


PORT_KERNELS = ("flash_fwd_sm90", "flash_fwd_kernel", "delta_kernel", "dkdv_mma", "dq_mma",
                "dkdv_kernel", "dq_kernel", "ssd_gram_kernel", "ssd_scan_kernel",
                "wkv6_state_kernel", "wkv6_out_kernel", "checksum_kernel", "wkv6_bwd_",
                "ssd_bwd_", "decode_attn_")


def _device_summary(prof, wall_s: float, named=()):
    """Device time by kernel from a profiler run, the eight largest rows, every
    row of the port's own kernels and every row whose name holds one of
    ``named``; the idle share is of ``wall_s``."""
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return {"device_time": "not measured (the profiler recorded no device events)"}
    busy_s = sum(us for _, us, _ in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3,
            "idle_share": 1 - busy_s / wall_s,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n,
                     "share_of_busy": us / 1e6 / busy_s} for k, us, n in rows[:8]],
            "port_kernels": [{"kernel": k[:90], "ms": us / 1e3, "calls": n,
                              "share_of_busy": us / 1e6 / busy_s} for k, us, n in rows
                             if any(name in k for name in PORT_KERNELS)],
            **({"named": [{"kernel": k[:90], "ms": us / 1e3, "calls": n,
                           "share_of_busy": us / 1e6 / busy_s} for k, us, n in rows
                          if any(name in k for name in named)]} if named else {})}


def profile_wave(cfg, api, params, batch: int, t: int, smax: int, steps: int = 4, named=()):
    """Where the time goes in one serving wave: a prefill of [batch, t] and
    ``steps`` decode steps, each under torch.profiler (which adds host time)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (batch, t), generator=gen, device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    res = {"batch": batch, "prefill_T": t, "decode_steps": steps}
    with torch.inference_mode():
        for phase in ("prefill", "decode"):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                if phase == "prefill":
                    logits, cache = api.prefill(params, toks, smax)
                else:
                    for i in range(steps):
                        nxt = logits[:, -1, :cfg.vocab].argmax(-1)
                        logits, cache = api.decode(params, nxt[:, None], cache, t + i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            res[phase] = _device_summary(prof, wall, named)
    log(f"  profile: {json.dumps(res)}")
    return res


def free_device_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ (f) training

def train_batch(cfg, b: int, t: int, seed: int) -> dict:
    """repro.launch.train's documents: token i of a row is (start + 3 i) mod
    min(vocab, 97), from a start drawn per row; labels are the tokens shifted
    by one."""
    m = min(cfg.vocab, 97)
    gen = torch.Generator().manual_seed(seed)
    start = torch.randint(0, m, (b, 1), generator=gen)
    seq = ((start + 3 * torch.arange(t + 1)[None]) % m).to("cuda")
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def train_launches(cfg) -> dict:
    """Kernel launches of one train step: each layer's forward kernel twice (the
    remat recompute runs it again), its backward kernel once; every kernel named."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        per = {"wkv6_fwd": 2 * L, "wkv6_bwd": L}
    elif cfg.family == "hybrid":
        sites = L // cfg.attn_every
        per = {"ssd_fwd": 2 * L, "ssd_bwd": L, "flash_attention_fwd": 2 * sites,
               "flash_attention_bwd": sites}
    else:
        per = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L}
    return {name: per.get(name, 0) for name in KERNELS}


SCAN_KERNEL_NAMES = {"ssm": ("wkv6_state_kernel", "wkv6_out_kernel", "wkv6_bwd_"),
                     "hybrid": ("ssd_gram_kernel", "ssd_scan_kernel", "ssd_bwd_")}


def train_oc(cfg):
    """The config's own optimizer (``opt_config_for``) at the smoke run's schedule."""
    return opt.opt_config_for(cfg, lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS + 1)


def train_bytes(cfg, oc, param_bytes: int = 2, kept_grad_bytes: int = 0) -> dict:
    """The device bytes one train step of ``cfg`` (B=TRAIN_B, T=TRAIN_T, remat) holds at
    most, reckoned from param_count(), for an attention family: each param's state (the
    param and its gradient at ``param_bytes``, two moments at the moment dtype's bytes,
    4 bytes of fp32 master weights where kept, and ``kept_grad_bytes`` for gradients
    kept beside the step's, as check_train_consistency keeps them); AdamW's fp32
    temporaries of the largest stacked leaf (``optimizer._update_leaf`` holds 3 whole
    fp32 copies of a leaf with fp32 moments: the update, nu / c2 and its square root; 5
    with bf16 moments, whose fp32 copies join them); under remat each layer's bf16
    input and the logits (fp32, their softmax and gradient: 3 copies); and
    TRAIN_SPARE_BYTES."""
    moment = torch.finfo(oc.moment_dtype).bits // 8
    per_param = 2 * param_bytes + 2 * moment + 4 * oc.master_weights + kept_grad_bytes
    emb = dataclasses.replace(cfg, n_layers=0).param_count()
    layer = dataclasses.replace(cfg, n_layers=1).param_count() - emb
    d, n, tokens = cfg.d_model, cfg.n_layers, TRAIN_B * TRAIN_T
    layer_leaf = max(d * cfg.n_heads * cfg.hd, d * cfg.d_ff,
                     cfg.n_experts * d * (cfg.d_expert or cfg.d_ff))
    largest = max(n * layer_leaf, cfg.vocab * d)
    out = {"state": (emb + n * layer) * per_param,
           "adamw_fp32_temporaries": (3 if moment == 4 else 5) * 4 * largest,
           "activations": n * tokens * d * 2 + 3 * tokens * cfg.vocab * 4,
           "spare": TRAIN_SPARE_BYTES}
    return {"bytes_per_param": per_param, "layer_params": layer, "embedding_params": emb,
            "largest_leaf": largest, **out, "total": sum(out.values())}


def _most_layers(full, fits) -> int:
    n = full.n_layers
    while n and not fits(dataclasses.replace(full, n_layers=n)):
        n -= 1
    return n


def train_depth_cut(full) -> tuple:
    """``full`` cut in depth only to the most layers whose bf16 train step, with the
    config's own optimizer, fits the card by ``train_bytes``; the cut stated with its
    bytes.  (The init holds one layer's bf16 draw beside the stacked leaves,
    ``layers.init_stacked``: 2 bytes a param of one layer, far under the step's.)"""
    total = torch.cuda.get_device_properties(0).total_memory
    oc = train_oc(full)
    n = _most_layers(full, lambda c: train_bytes(c, oc)["total"] <= total)
    if n < 1:
        one = train_bytes(dataclasses.replace(full, n_layers=1), oc)
        raise AssertionError(f"{full.name}: one layer's train step needs "
                             f"{one['total'] / 1e9:.1f} GB of the card's {total / 1e9:.1f}")
    cfg = dataclasses.replace(full, n_layers=n)
    b = train_bytes(cfg, oc)
    cut = (f"{n} of {full.n_layers} layers, full width: {b['layer_params'] / 1e9:.3f} B "
           f"params a layer and {b['embedding_params'] / 1e9:.3f} B of embeddings "
           f"(param_count()) at {b['bytes_per_param']} bytes a param of state, "
           f"{b['state'] / 1e9:.2f} GB, beside AdamW's fp32 temporaries "
           f"{b['adamw_fp32_temporaries'] / 1e9:.2f} GB, activations "
           f"{b['activations'] / 1e9:.2f} GB and {TRAIN_SPARE_BYTES / 1e9:.0f} GB: "
           f"{b['total'] / 1e9:.2f} GB of the card's {total / 1e9:.1f} GB")
    return cfg, cut, b


def check_depth_cut(cfg) -> int:
    """The layers check_train_consistency runs ``cfg`` at: at most CHECK_LAYERS and
    ``cfg``'s own, and no more than the fp32 run fits the card by ``train_bytes`` (fp32
    params and gradients, the gradients at the init kept beside the step's; one path's
    run on the card at a time, the other's results held on the host)."""
    total = torch.cuda.get_device_properties(0).total_memory
    oc = train_oc(cfg)
    capped = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, CHECK_LAYERS))
    n = _most_layers(capped, lambda c: train_bytes(c, oc, 4, 4)["total"] <= total)
    if n < 1:
        raise AssertionError(f"{cfg.name}: not one layer's fp32 check fits the card")
    return n


def phase_training(arch: str = TRAIN_ARCH, n_layers: int = 0, check_layers: int = 4,
                   label: str = "(f)", cut: str = None, bf16_grad_tol: float = None):
    """(f), (i) for the ssm and hybrid families and (f2) for the other attention
    archs: ``arch`` at full width (cut to ``n_layers`` if given, as ``cut`` states),
    TRAIN_STEPS steps of ``make_train_step`` and one under the profiler, every trained
    leaf digested by K2, then the kernel path against the plain one at
    ``check_layers`` layers in fp32 and bf16 (its gradients held to
    ``bf16_grad_tol`` where given, beside the plain path's own noise floor)."""
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers) if n_layers else full
    if n_layers and cut is None:
        cut = f"{cfg.n_layers} of {full.n_layers} layers, full width"
    log(f"{label} training {arch} {f'cut to {cut}' if cut else 'at full width'}: "
        f"{json.dumps(dataclasses.asdict(cfg))}")
    t_phase = time.perf_counter()
    api = get_model(cfg)
    oc = train_oc(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(0, torch.bfloat16, "cuda")
    state = opt.init_opt_state(oc, params)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, p in opt.flatten_with_paths(params))
    log(f"  init {n_params / 1e9:.3f} B params (bf16), moments in {oc.moment_dtype}, "
        f"{'fp32' if oc.master_weights else 'no'} master weights, {oc.schedule}, in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    step = make_train_step(cfg, oc)
    batches = [train_batch(cfg, TRAIN_B, TRAIN_T, 100 + i) for i in range(TRAIN_STEPS + 1)]

    reset_launches()
    steps = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batches[i])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": i + 1, "ms": dt * 1e3, "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"])})
        log(f"  step {json.dumps(steps[-1])}")
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = train_launches(cfg)
    want = {name: n * TRAIN_STEPS for name, n in per_step.items()}
    if counts != want:
        raise AssertionError(f"kernel launches over {TRAIN_STEPS} train steps {counts}, "
                             f"expected {want}")
    if not all(torch.isfinite(torch.tensor([s["loss"], s["grad_norm"]])).all() for s in steps):
        raise AssertionError(f"non-finite loss or grad norm: {steps}")

    # every trained parameter, digested through its int32 view
    digests = {}
    for path, p in opt.flatten_with_paths(params):
        words = p.reshape(-1).view(torch.int32)
        got = ops.tensor_checksum(words)
        if not torch.equal(got, ref.checksum(words)):
            raise AssertionError(f"checksum of {'.'.join(path)}: kernel {got.tolist()} vs "
                                 f"plain {ref.checksum(words).tolist()}")
        digests[".".join(path)] = got.tolist()
    counts["checksum"] = launches()["checksum"]
    if counts["checksum"] != len(digests):
        raise AssertionError(f"{counts['checksum']} checksum launches for {len(digests)} leaves")

    steady_ms = sum(s["ms"] for s in steps[1:]) / (len(steps) - 1)
    training = {
        "arch": arch, "layers": cfg.n_layers, **({"cut": cut} if cut else {}),
        "params": n_params, "batch": TRAIN_B,
        "seq": TRAIN_T, "steps": steps, "launches": counts,
        "launches_per_step": {k: v for k, v in per_step.items() if v},
        "step_ms_steady": steady_ms, "first_step_ms": steps[0]["ms"],
        "trained_tok_s": TRAIN_B * TRAIN_T / (steady_ms / 1e3), "peak_mem_gb": peak,
        "opt": {"lr": oc.lr, "warmup_steps": oc.warmup_steps, "total_steps": oc.total_steps,
                "schedule": oc.schedule, "master_weights": oc.master_weights,
                "moment_dtype": str(oc.moment_dtype).split(".")[-1]},
        "param_digests": digests,
    }
    log(f"  trained: {json.dumps({k: v for k, v in training.items() if k != 'param_digests'})}")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    training["profile"] = {"step": TRAIN_STEPS + 1, "loss": float(metrics["loss"]),
                           **_device_summary(prof, wall,
                                             MOE_NAMED_OPS if cfg.n_experts else ())}
    scans = SCAN_KERNEL_NAMES.get(cfg.family)
    if scans and "port_kernels" in training["profile"]:
        rows = [r for r in training["profile"]["port_kernels"]
                if any(n in r["kernel"] for n in scans)]
        training["profile"]["scan_fwd_ms"] = sum(r["ms"] for r in rows if "bwd" not in r["kernel"])
        training["profile"]["scan_bwd_ms"] = sum(r["ms"] for r in rows if "bwd" in r["kernel"])
    log(f"  profile: {json.dumps(training['profile'])}")
    training["counts"] = train_counts(cfg, oc, step, params, state, batches[0],
                                      [s["ms"] for s in steps[1:]])
    if arch == TRAIN_ARCH:
        del state               # (j3) needs the room of the moments and master weights
        free_device_memory()
        training["compression"] = phase_compress(cfg, api, params, batches[0])
        del params, metrics, step
    else:
        del params, state, metrics, step
    free_device_memory()
    training["consistency"] = check_train_consistency(cfg, torch.float32, FP32_TOL, check_layers)
    free_device_memory()
    training["consistency_bf16"] = check_train_consistency(
        cfg, torch.bfloat16, TRAIN_TOL, check_layers, bf16_grad_tol)
    free_device_memory()
    training["phase_peak_mem_gb"] = max(torch.cuda.max_memory_allocated() / 1e9,
                                        training["counts"]["peak_before_gb"],
                                        training["counts"]["measured_peak_gb"])
    training["phase_s"] = time.perf_counter() - t_phase
    return training


def phase_f2(arch: str) -> dict:
    """(f2) for ``arch``: (f)'s phase at full width, cut in depth only by
    train_depth_cut, its kernel path held to the plain one at check_depth_cut's
    layers; the reckoned bytes beside the measured peak."""
    cfg, cut, reckoned = train_depth_cut(get_arch(arch))
    check = check_depth_cut(cfg)
    training = phase_training(arch, cfg.n_layers, check, "(f2)", cut, BF16_GRAD_TOL)
    training.update(full_layers=get_arch(arch).n_layers, check_layers=check,
                    reckoned_gb={k: v / 1e9 for k, v in reckoned.items()
                                 if k in ("state", "adamw_fp32_temporaries", "activations",
                                          "spare", "total")},
                    reckoned_step_over_measured_peak=(reckoned["total"] - TRAIN_SPARE_BYTES)
                    / 1e9 / training["peak_mem_gb"])
    log(f"  (f2) {arch}: {training['layers']} layers, check at {check}, "
        f"{training['step_ms_steady']:.1f} ms a step, {training['phase_s']:.1f} s")
    return training


def phase_compress(cfg, api, params, batch):
    """(j3): ``compress_tree`` twice over the gradient tree of ``params`` (the
    second call carrying the first's residual), on explicit noise tensors so
    that every leaf can be checked after each call, against the bytes bound."""
    t_phase = time.perf_counter()
    pairs = [(path, p.detach().requires_grad_()) for path, p in opt.flatten_with_paths(params)]
    loss = api.loss(opt.unflatten(pairs), batch)
    grads = opt.unflatten((path, g.detach()) for (path, _), g in
                          zip(pairs, torch.autograd.grad(loss, [p for _, p in pairs])))
    del pairs, loss
    leaves = list(opt.flatten_with_paths(grads))
    n = sum(g.numel() for _, g in leaves)
    log(f"(j3) compress_tree over {cfg.name}'s {len(leaves)} gradient leaves, {n} values")
    gen = torch.Generator(device="cuda").manual_seed(11)
    res, calls, cpu = None, [], None
    for call in range(2):
        noise = [compress.noise_like(g.numel(), gen) for _, g in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, new_res = compress.compress_tree(grads, res, noise)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        worst = {"q_absmax": 0, "err_over_scale": 0.0, "packed_over_raw": 0.0}
        res_of, out_of, new_res_of = (dict(opt.flatten_with_paths(t)) if t is not None else {}
                                      for t in (res, out, new_res))
        for i, (path, g) in enumerate(leaves):
            corrected = g.float()
            if path in res_of:
                corrected += res_of[path]
            q, scale = compress.quantize(corrected, noise[i])
            deq = compress.dequantize(q, scale, g.shape, torch.float32)
            err, _ = compress._pad_to_block(deq - corrected)
            ratio = (err.reshape(-1, compress.BLOCK).abs().amax(1) / scale).max()
            got_out, got_res = out_of[path], new_res_of[path]
            name = ".".join(path)
            if not (torch.equal(got_res, corrected - deq) and torch.equal(got_out, deq.to(g.dtype))):
                raise AssertionError(f"compress_tree's {name}: residual or output is not "
                                     "corrected - deq, deq")
            worst["q_absmax"] = max(worst["q_absmax"], int(q.abs().max()))
            worst["err_over_scale"] = max(worst["err_over_scale"], float(ratio))
            worst["packed_over_raw"] = max(worst["packed_over_raw"],
                                           (q.numel() + 4 * scale.numel()) / (4 * g.numel()))
            if call == 0 and name == "layers.attn.wq":
                # the same leaf and noise on the CPU: q and scales bit for bit
                q_c, s_c = compress.quantize(corrected.cpu(), noise[i].cpu())
                cpu = {"leaf": name, "values": g.numel(),
                       "q_equal": torch.equal(q.cpu(), q_c),
                       "scale_equal": torch.equal(scale.cpu().view(torch.int32),
                                                  s_c.view(torch.int32))}
            del corrected, q, scale, deq, err
        if worst["q_absmax"] > 127 or worst["err_over_scale"] > 1.51 or \
                worst["packed_over_raw"] >= 1 / 3.5:
            raise AssertionError(f"compress_tree call {call + 1}: {worst}")
        calls.append({"call": call + 1, "ms": ms,
                      "gb_s": COMPRESS_BYTES * n / (ms / 1e3) / 1e9, **worst})
        log(f"  call {json.dumps(calls[-1])}")
        del out, noise, res_of, out_of, new_res_of
        res = new_res
        del new_res
    if not (cpu and cpu["q_equal"] and cpu["scale_equal"]):
        raise AssertionError(f"quantize on the card vs the CPU: {cpu}")
    res_out = {"arch": cfg.name, "layers": cfg.n_layers, "leaves": len(leaves), "values": n,
               "grad_dtype": str(leaves[0][1].dtype).split(".")[-1], "calls": calls,
               "bytes_per_value": COMPRESS_BYTES, "bytes": COMPRESS_BYTES * n,
               "bound_ms": COMPRESS_BYTES * n / HBM_BYTES_S * 1e3,
               "bound_ms_with_noise_read": (COMPRESS_BYTES + NOISE_BYTES) * n / HBM_BYTES_S * 1e3,
               "share_of_bound": COMPRESS_BYTES * n / HBM_BYTES_S * 1e3 / calls[1]["ms"],
               "cpu_check": cpu, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "phase_s": time.perf_counter() - t_phase}
    log(f"  compression: {json.dumps(res_out)}")
    del grads, res, leaves
    return res_out


def _train_run(cfg, dtype, batches, to_host: bool = False):
    """Loss and gradients at the init, then the params after a train step per
    batch, all from the same seeded init; with ``to_host`` the gradients and params
    are copied to the host as they come, leaving nothing of the run on the card."""
    api = get_model(cfg)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=2, total_steps=4)
    params = api.init(0, dtype, "cuda")
    pairs = [(path, p.detach().requires_grad_()) for path, p in opt.flatten_with_paths(params)]
    loss = api.loss(opt.unflatten(pairs), batches[0])
    grads = dict(zip((path for path, _ in pairs),
                     torch.autograd.grad(loss, [p for _, p in pairs])))
    del pairs
    if to_host:
        grads = {path: g.cpu() for path, g in grads.items()}
    step, state = make_train_step(cfg, oc), opt.init_opt_state(oc, params)
    for batch in batches:
        params, state, _ = step(params, state, batch)
    del state
    params = {path: p.cpu() if to_host else p for path, p in opt.flatten_with_paths(params)}
    return loss.detach(), grads, params


def _grad_errs(grads, want):
    """Per leaf, the largest difference over the leaf's largest value (a leaf of
    ``grads`` on the host is brought to ``want``'s device)."""
    return {".".join(path): float((grads[path].to(g.device).float() - g.float()).abs().max()
                                  / g.float().abs().max().clamp(min=1e-30))
            for path, g in want.items()}


def check_train_consistency(cfg, dtype, tol: float, n_layers: int = 4, grad_tol=None):
    """The kernel path against the plain path (PLAIN_OPS, forward and backward)
    at ``n_layers`` layers and full width: the loss, every gradient leaf (error
    over the leaf's largest value) and the params after 2 steps (|a-b| / (1 + |b|)),
    and each path's kernel launches.  The kernel path's gradients and params wait on
    the host while the plain path runs.  With ``grad_tol`` the gradients are held to
    it instead of ``tol``, and the plain path is run again with its scans at half
    the chunk, its gradients' distance from the first plain run reported: the
    noise floor of the function's own rounding.

    Both paths share their discrete choices, call by call, the kernel path's
    taken by the plain one (the remat recompute routes again, in the same order in
    both): an MoE model's expert choices (``moe_routing``), and the row argmax of
    the logits that the loss adds back with its gradient (``loss_argmax``).  Each
    flips on a one-ulp difference wherever two candidates nearly tie, and moves
    that token's gradient by an O(1) amount.  How many tokens and rows would have
    chosen otherwise is reported; the drops follow from the shared choices."""
    cfg4 = dataclasses.replace(cfg, n_layers=n_layers)
    batches = [train_batch(cfg, TRAIN_B, TRAIN_T, 200 + i) for i in range(2)]
    reset_launches()
    with moe_routing() as (chosen, _, dropped_k), loss_argmax() as (argmax, _):
        loss_k, grads_k, params_k = _train_run(cfg4, dtype, batches, to_host=True)
    counts = launches()
    free_device_memory()
    # the loss and gradients once, then a step per batch
    want = {name: 3 * n for name, n in train_launches(cfg4).items()}
    if counts != want:
        raise AssertionError(f"kernel launches of the kernel path {counts}, expected {want}")
    shared = [(slice(None), c) for c in chosen]

    def plain_run(routes):
        with plain_ops(routes), moe_routing(shared) as (_, rerouted, dropped_p), \
                loss_argmax(argmax) as (_, flipped):
            out = _train_run(cfg4, dtype, batches)
        if len(rerouted) != len(chosen) or dropped_p != dropped_k or \
                len(flipped) != len(argmax):
            raise AssertionError(f"the plain path routed {len(rerouted)} times with drops "
                                 f"{dropped_p} and took {len(flipped)} losses, the kernel "
                                 f"path {len(chosen)} with {dropped_k} and {len(argmax)}")
        return out, rerouted, flipped

    (loss_p, grads_p, params_p), rerouted, flipped = plain_run(PLAIN_OPS)
    _, loss_err = rel_close(loss_k, loss_p, tol)
    grad_errs = _grad_errs(grads_k, grads_p)
    noise = {}
    if grad_tol is not None:
        (_, grads_h, _), _, _ = plain_run(PLAIN_HALF_CHUNK)
        noise = _grad_errs(grads_h, grads_p)
        del grads_h
    param_errs = {".".join(path): rel_close(params_k[path].to(p.device), p, tol)[1]
                  for path, p in params_p.items()}
    del grads_k, params_k
    res = {"dtype": str(dtype).split(".")[-1], "layers": cfg4.n_layers, "B": TRAIN_B,
           "T": TRAIN_T, "tolerance": tol, "grad_tolerance": grad_tol or tol,
           "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_err": loss_err,
           "grad_err_max": max(grad_errs.values()), "param_err_max": max(param_errs.values()),
           **({"plain_vs_half_chunk_grad_err_max": max(noise.values())} if noise else {}),
           "loss_rows": TRAIN_B * TRAIN_T, "argmax_rows_flipped_by_call": flipped,
           **({"routing_calls": len(chosen), "tokens_a_call": int(chosen[0].shape[0]),
               "tokens_rerouted_by_call": rerouted, "dropped_by_call": dropped_k}
              if cfg.n_experts else {}),
           "launches_kernel_path": counts, "grad_errs": grad_errs, "param_errs": param_errs,
           **({"plain_vs_half_chunk_grad_errs": noise} if noise else {})}
    log(f"  train consistency: {json.dumps(res)}")
    if not (torch.isfinite(loss_k) and max(loss_err, res["param_err_max"]) <= tol
            and res["grad_err_max"] <= (grad_tol or tol)):
        raise AssertionError(f"training kernel path vs plain path ({res['dtype']}): {res}")
    return res


# ------------------------------------------------------------------ (g) the trainer

def _io_report(io: dict, modeled: dict) -> dict:
    """Bytes over wall-clock seconds, each stage's seconds and share, and the
    cluster's modeled seconds for the same bytes (its virtual clock)."""
    stages = {k: v for k, v in io.items() if k.endswith("_s") and k != "s"}
    return {"bytes": io["bytes"], "s": io["s"], "gb_s": io["bytes"] / io["s"] / 1e9,
            "stages_s": stages, "stage_shares": {k: v / io["s"] for k, v in stages.items()},
            "modeled_s": modeled["s"], "modeled_gb_s": io["bytes"] / modeled["s"] / 1e9}


def _on_the_clock(cluster, fn, out: dict):
    """``fn`` run as one timed op of the cluster, from virtual time 0 on idle
    queues; its modeled seconds go into ``out["s"]``."""
    def call(*args, **kw):
        net = cluster.net
        net.reset_accounting()
        op = net.begin_op(at=0.0)
        try:
            return fn(*args, **kw)
        finally:
            net.end_op()
            out["s"] = op.us / 1e6
    return call


def _host_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise AssertionError("no MemAvailable in /proc/meminfo")


def _digests(trainer) -> dict:
    """The checksum kernel's digest of every leaf of params, mu, nu and master."""
    out = {}
    for part in ("params", "mu", "nu", "master"):
        for path, leaf in opt.flatten_with_paths(trainer.state_tree()[part] or {}):
            out["~".join((part, *path))] = ops.tensor_checksum(
                leaf.reshape(-1).view(torch.int32)).tolist()
    return out


def _train_timed(trainer, n: int) -> list:
    """``n`` steps through Trainer.train, each timed (host clock, synchronised)."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(1)
        torch.cuda.synchronize()
        out.append({**trainer.history[-1], "ms": (time.perf_counter() - t0) * 1e3})
        log(f"  step {json.dumps(out[-1])}")
    return out


def phase_trainer():
    """(g): crash and resume through Trainer on the port's CFS, held bit for bit
    to a run without."""
    full = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAINER_LAYERS)
    ckpt_bytes = cfg.param_count() * (2 + 3 * 4)   # bf16 params; fp32 master, mu, nu
    cut = (f"{TRAINER_LAYERS} of {full.n_layers} layers, full width: a checkpoint of "
           f"{ckpt_bytes / 1e9:.1f} GB")
    log(f"(g) training {TRAIN_ARCH} through the Trainer, with a crash and a resume; {cut}")
    torch.cuda.reset_peak_memory_stats()
    host_free = _host_available()
    if host_free < HOST_MARGIN * ckpt_bytes:
        raise AssertionError(f"{host_free / 1e9:.1f} GB of host memory available, under "
                             f"{HOST_MARGIN} x the {ckpt_bytes / 1e9:.1f} GB checkpoint")
    disk = TRAINER_DISK_BYTES
    while disk < ckpt_bytes + TRAINER_DATA_BYTES:
        disk *= 2
    disk_cut = None if disk == TRAINER_DISK_BYTES else (
        f"data disks of {disk >> 30} GiB in place of build_cluster's "
        f"{TRAINER_DISK_BYTES >> 30} GiB, which the checkpoint's replicas overflow")
    cluster = build_cluster(data_disk_capacity=disk)
    data_nodes = list(cluster.data_nodes.values())
    mnt = cluster.mount("train")
    write_dataset(mnt, cfg.vocab)
    # the datapipe on a client of its own: its counters are the datapipe's reads
    reader_mnt = cluster.mount("train")
    reader = ShardReader(reader_mnt, "/data", rank=0, world=1, batch=TRAIN_B,
                         seq_len=TRAIN_T)
    reads_before = dict(reader_mnt.client.stats)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=2, total_steps=TRAINER_CRASH_AT + 1)

    def trainer(ckpt_every: int) -> Trainer:
        tc = TrainerConfig(ckpt_every=ckpt_every, max_steps=TRAINER_CRASH_AT)
        return Trainer(cfg, oc, tc, mnt, reader, seed=0, param_dtype=torch.bfloat16,
                       device="cuda")

    reset_launches()
    # run U: TRAINER_CRASH_AT steps, no checkpoint
    t_u = trainer(ckpt_every=TRAINER_CRASH_AT + 1)
    n_params = sum(p.numel() for _, p in opt.flatten_with_paths(t_u.params))
    steps_u = _train_timed(t_u, TRAINER_CRASH_AT)
    digests_u = _digests(t_u)
    for path, leaf in opt.flatten_with_paths(t_u.params):
        words = leaf.reshape(-1).view(torch.int32)
        if ref.checksum(words).tolist() != digests_u["~".join(("params", *path))]:
            raise AssertionError(f"checksum kernel vs plain on params {path}")
    step_u = int(t_u.opt_state.step)
    del t_u
    free_device_memory()

    # run C: saves step TRAINER_CKPT_EVERY, crashes after step TRAINER_CRASH_AT
    t_c = trainer(ckpt_every=TRAINER_CKPT_EVERY)
    save_clock: dict = {}
    t_c.ckpt.save = _on_the_clock(cluster, t_c.ckpt.save, save_clock)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        t_c.train(TRAINER_CRASH_AT, crash_at=TRAINER_CRASH_AT)
    except RuntimeError as e:
        if f"injected trainer crash at step {TRAINER_CRASH_AT}" not in str(e):
            raise
    else:
        raise AssertionError("run C did not crash")
    run_c_s = time.perf_counter() - t0
    if t_c.ckpt.list_steps() != [TRAINER_CKPT_EVERY]:
        raise AssertionError(f"checkpoints after the crash: {t_c.ckpt.list_steps()}")
    save = _io_report(t_c.ckpt.last_io, save_clock)
    log(f"  run C crashed after step {TRAINER_CRASH_AT} ({run_c_s:.1f} s); "
        f"save {json.dumps(save)}")
    del t_c
    free_device_memory()

    # resume: a fresh Trainer restores step TRAINER_CKPT_EVERY and trains on
    t_r = trainer(ckpt_every=TRAINER_CRASH_AT + 1)
    restore_clock: dict = {}
    t_r.ckpt.restore = _on_the_clock(cluster, t_r.ckpt.restore, restore_clock)
    if not t_r.resume() or t_r.step != TRAINER_CKPT_EVERY:
        raise AssertionError(f"resume: step {t_r.step}")
    restore = _io_report(t_r.ckpt.last_io, restore_clock)
    log(f"  restored step {t_r.step}: {json.dumps(restore)}")
    steps_r = _train_timed(t_r, TRAINER_CRASH_AT - TRAINER_CKPT_EVERY)
    digests_r = _digests(t_r)
    step_r = int(t_r.opt_state.step)
    counts = launches()
    del t_r
    free_device_memory()
    reads = {k: reader_mnt.client.stats[k] - reads_before[k]
             for k in ("data_calls", "hedged_reads", "retries")}
    report = fsck(cluster, "train")
    if not report.clean:
        raise AssertionError(f"fsck of volume train after the resume: {report}")
    disks = {n.node_id: n.disk.used / n.disk.capacity for n in data_nodes}
    files = {"inodes": report.inodes_scanned, "dentries": report.dentries_scanned}
    log(f"  fsck clean ({json.dumps(files)}); datapipe reads {json.dumps(reads)}; "
        f"data disks used {json.dumps(disks)}")
    disk_gb = data_nodes[0].disk.capacity / 1e9
    del cluster, data_nodes, mnt, reader, reader_mnt, trainer    # frees the volume's replicas
    gc.collect()

    differ = sorted(k for k in digests_u if digests_r.get(k) != digests_u[k])
    if differ or step_r != step_u or digests_r.keys() != digests_u.keys():
        raise AssertionError(f"resumed run differs from run U: leaves {differ}, "
                             f"steps {step_r} vs {step_u}")
    n_steps = 2 * TRAINER_CRASH_AT + TRAINER_CRASH_AT - TRAINER_CKPT_EVERY   # U, C, resumed
    want = {name: n * n_steps for name, n in train_launches(cfg).items()}
    want["checksum"] = 2 * len(digests_u)
    if counts != want:
        raise AssertionError(f"kernel launches through the Trainer {counts}, expected {want}")
    steady = [s["ms"] for s in steps_u[1:]]
    trainer_res = {
        "arch": TRAIN_ARCH, "layers": cfg.n_layers, "cut": cut, "params": n_params,
        "batch": TRAIN_B, "seq": TRAIN_T, "ckpt_every": TRAINER_CKPT_EVERY,
        "crash_at": TRAINER_CRASH_AT, "host_available_gb": host_free / 1e9,
        "cluster": {"build": "launch.train.build_cluster", "n_meta": 4, "n_data": 6,
                    "data_disk_gb": disk_gb,
                    "extent_max_bytes": 1024 * 1024, "replicas": 3, "cut": disk_cut,
                    "data_disks_used": disks, "fsck_clean": True, **files},
        "datapipe_reads": reads, "steps_u": steps_u,
        "steps_resumed": steps_r, "run_c_s": run_c_s,
        "step_ms_steady_u": sum(steady) / len(steady), "save": save, "restore": restore,
        "launches": counts, "train_steps": n_steps, "leaves_digested": len(digests_u),
        "digests_bit_identical": True, "step_after": step_r,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "digests": digests_u,
    }
    log(f"  trainer: {json.dumps({k: v for k, v in trainer_res.items() if k != 'digests'})}")
    return trainer_res


# ------------------------------------------------------------------ (j1) the mesh train step

def _timed_step(step, params, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    return params, state, {"ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"])}


def _profiled_step(step, params, state, batch):
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return params, state, _device_summary(prof, wall, named=MESH_NAMED_OPS)


def _local_words(p):
    return (p.to_local() if isinstance(p, DTensor) else p).reshape(-1).view(torch.int32)


def _mesh_steps(step, cfg, api, oc, mesh, batches, want, want_digests, fsdp: bool):
    """(j1)'s steps on DTensor params and ZeRO-1 state placed by the rules (with
    ``fsdp``: as FSDP places them, split over "data" too, so that each layer's
    gather and its backward's reduce-scatter run NCCL collectives on the group
    of one) from seed 0's weights: step ms, the K2 digests after 2 steps, the
    kernels' launches, the parameter gathers and reduce-scatters a step, the
    steps' own peak of device memory, and one more step under the profiler."""
    needs_fsdp = shd.needs_fsdp
    whole = api.init(0, torch.bfloat16, "cuda")
    if fsdp:
        shd.needs_fsdp = lambda cfg: True
    try:
        params = shd.distribute_tree(whole, shd.param_shardings(cfg, whole, mesh), mesh)
        state = opt.init_opt_state(oc, params, shd.opt_shardings(cfg, whole, mesh))
    finally:
        shd.needs_fsdp = needs_fsdp
    del whole
    split = sorted(".".join(path) for path, p in opt.flatten_with_paths(params)
                   if any(pl.is_shard() for pl, a in zip(p.placements, mesh.mesh_dim_names)
                          if a == "data"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    spmd.GATHERS.clear()
    steps = []
    for i, batch in enumerate(batches[:-1]):
        params, state, m = _timed_step(step, params, state, batch)
        steps.append(m)
        if i == 1:
            leaves = dict(opt.flatten_with_paths(params))
            digests = {path: ops.tensor_checksum(_local_words(p)).tolist()
                       for path, p in leaves.items()}
            differ = {".".join(path): rel_close(leaves[path].full_tensor(), want[path],
                                                TRAIN_TOL)[1]
                      for path in digests if digests[path] != want_digests[path]}
            del leaves
    counts = launches()
    gathers = {k: v / len(steps) for k, v in spmd.GATHERS.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    params, state, profile_ = _profiled_step(step, params, state, batches[-1])
    placed = all(isinstance(p, DTensor) for _, p in opt.flatten_with_paths(params)) and all(
        isinstance(x, DTensor) for t in (state.mu, state.nu, state.master) if t is not None
        for _, x in opt.flatten_with_paths(t))
    res = {"fsdp_forced": fsdp, "leaves_split_over_data": split, "steps": steps,
           "step_ms": steps[-1]["ms"], "peak_mem_gb": peak, "launches": counts,
           "param_gathers_per_step": gathers.get("gather", 0.0),
           "grad_reduce_scatters_per_step": gathers.get("reduce_scatter", 0.0),
           "leaves": len(digests), "leaves_bit_identical_after_2_steps": len(digests) - len(differ),
           "differing_leaves_err": differ, "placed_as_dtensors": placed, "profile": profile_}
    del params, state
    free_device_memory()
    return res, counts


def phase_mesh_train(mesh):
    """(j1): (g)'s minicpm-2b through ``make_train_step`` on DTensor params and
    ZeRO-1 optimizer state on ``mesh``, against the mesh-free step from the
    same weights: K2 digests of every leaf after 2 steps, bit for bit, the
    kernels' launches, and each path's step ms; twice, as the rules place the
    params and with FSDP forced."""
    t_phase = time.perf_counter()
    full = get_arch(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAINER_LAYERS)
    log(f"(j1) mesh train step: {TRAIN_ARCH} cut to {cfg.n_layers} of {full.n_layers} layers, "
        f"full width, on a {tuple(mesh.shape)} {mesh.mesh_dim_names} mesh of one NCCL rank")
    api = get_model(cfg)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS + 1)
    # the steps, then one more under the profiler
    batches = [train_batch(cfg, TRAIN_B, TRAIN_T, 100 + i) for i in range(MESH_TRAIN_STEPS + 1)]
    step = make_train_step(cfg, oc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    params = api.init(0, torch.bfloat16, "cuda")
    state = opt.init_opt_state(oc, params)
    plain_steps = []
    for i, batch in enumerate(batches[:-1]):
        params, state, m = _timed_step(step, params, state, batch)
        plain_steps.append(m)
        if i == 1:
            want = {path: p.clone() for path, p in opt.flatten_with_paths(params)}
            want_digests = {path: ops.tensor_checksum(_local_words(p)).tolist()
                            for path, p in want.items()}
    plain_peak = torch.cuda.max_memory_allocated() / 1e9
    params, state, plain_profile = _profiled_step(step, params, state, batches[-1])
    del params, state
    free_device_memory()

    per_step = train_launches(cfg)
    expect = {name: n * MESH_TRAIN_STEPS for name, n in per_step.items()}
    expect["checksum"] = len(want_digests)
    # a gather a layer in the forward and one in its recompute, and the tied
    # embedding's for the lookup and for the head; a reduce-scatter each
    want_gathers = (2 * cfg.n_layers + 2, cfg.n_layers + 2)
    runs = {}
    for name, fsdp in (("rules", False), ("fsdp", True)):
        res, counts = _mesh_steps(step, cfg, api, oc, mesh, batches, want, want_digests, fsdp)
        runs[name] = res
        if counts != expect:
            raise AssertionError(f"kernel launches over the mesh train steps ({name}) {counts}, "
                                 f"expected {expect}")
    res = {"arch": TRAIN_ARCH, "layers": cfg.n_layers, "mesh": list(mesh.shape),
           "mesh_axes": list(mesh.mesh_dim_names), "backend": dist.get_backend(), "world": 1,
           "batch": TRAIN_B, "seq": TRAIN_T, "steps": MESH_TRAIN_STEPS,
           "plain_steps": plain_steps, "step_ms_plain": plain_steps[-1]["ms"],
           "peak_mem_gb_plain": plain_peak, "profile_plain": plain_profile,
           "step_ms_mesh": runs["rules"]["step_ms"], "step_ms_mesh_fsdp": runs["fsdp"]["step_ms"],
           "mesh_host_ms_added": runs["rules"]["step_ms"] - plain_steps[-1]["ms"],
           "want_gathers_per_step": list(want_gathers), "expected_launches": expect,
           "launches": runs["rules"]["launches"],
           "peak_mem_gb": max(plain_peak, *(r["peak_mem_gb"] for r in runs.values())),
           "launches_per_step": {k: v for k, v in per_step.items() if v},
           "runs": runs, "phase_s": time.perf_counter() - t_phase}
    log(f"  mesh train: {json.dumps(res)}")
    # bit for bit as the rules place the params; with FSDP forced, a gathered
    # weight split along a dim other than its first is a strided view of the
    # gathered buffer (wo, w2, emb/tok), and cuBLAS may take another kernel for
    # it than for the contiguous weight: within TRAIN_TOL there
    for name, run in runs.items():
        finite = all(torch.isfinite(torch.tensor([m["loss"], m["grad_norm"]])).all()
                     for m in run["steps"])
        got_gathers = (run["param_gathers_per_step"], run["grad_reduce_scatters_per_step"])
        differ = run["differing_leaves_err"]
        if not run["placed_as_dtensors"] or not finite or got_gathers != want_gathers or \
                (name == "fsdp") != bool(run["leaves_split_over_data"]) or \
                (differ if name == "rules" else any(e > TRAIN_TOL for e in differ.values())):
            raise AssertionError(f"mesh train step ({name}) against the mesh-free one: {res}")
    del want
    return res


def phase_ssm_mesh_train(arch: str, mesh):
    """(j1) for the ssm and hybrid families: ``arch`` at full width cut to
    ``SSM_MESH_LAYERS`` layers takes ``SSM_MESH_STEPS`` steps of
    ``make_train_step`` without a mesh and as many on DTensor params and
    ZeRO-1 state placed by the rules on ``mesh`` (its rwkv6 or Mamba2 blocks,
    and zamba2's shared block, split over "model"), from the same weights
    and batches: the K2 digest of every leaf after the last step bit for
    bit, the steps' launches (K4/K3 forward twice a layer, K4-bwd/K3-bwd
    once; zamba2's K1 and K1-bwd at its site), each step's ms (the first of
    each run pays its first-call costs), and the parameter gathers and
    gradient reduce-scatters a step."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch), n_layers=SSM_MESH_LAYERS[arch])
    log(f"(j1) mesh train step: {arch} cut to {cfg.n_layers} layers, full width, on a "
        f"{tuple(mesh.shape)} {mesh.mesh_dim_names} mesh of one NCCL rank")
    api = get_model(cfg)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS + 1)
    step = make_train_step(cfg, oc)
    batches = [train_batch(cfg, TRAIN_B, TRAIN_T, 100 + i) for i in range(SSM_MESH_STEPS)]
    runs, digests = {}, {}
    for name in ("mesh_free", "placed"):
        params = api.init(0, torch.bfloat16, "cuda")
        if name == "placed":
            params = shd.distribute_tree(params, shd.param_shardings(cfg, params, mesh), mesh)
            state = opt.init_opt_state(oc, params, shd.opt_shardings(cfg, params, mesh))
        else:
            state = opt.init_opt_state(oc, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        spmd.GATHERS.clear()
        spmd.MODEL_GATHERS.clear()
        steps = []
        for batch in batches:
            params, state, m = _timed_step(step, params, state, batch)
            steps.append(m)
        digests[name] = {".".join(path): ops.tensor_checksum(_local_words(p)).tolist()
                         for path, p in opt.flatten_with_paths(params)}
        runs[name] = {"steps": steps, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": launches(),
                      "param_gathers": spmd.GATHERS["gather"] / len(steps),
                      "grad_reduce_scatters": spmd.GATHERS["reduce_scatter"] / len(steps),
                      "model_gathers": dict(spmd.MODEL_GATHERS)}
        del params, state
        free_device_memory()
    expect = {name: n * len(batches) for name, n in train_launches(cfg).items()}
    expect["checksum"] = len(digests["placed"])
    sites = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    # a gather a layer (and shared-block site) in the forward and one in its
    # recompute, and the embedding's for the lookup and for the head; a
    # reduce-scatter each
    want_gathers = (2 * (cfg.n_layers + sites) + 2, cfg.n_layers + sites + 2)
    differ = sorted(k for k, v in digests["placed"].items() if v != digests["mesh_free"][k])
    res = {"arch": arch, "layers": cfg.n_layers, "shared_block_sites": sites,
           "mesh": list(mesh.shape), "batch": TRAIN_B, "seq": TRAIN_T,
           "expected_launches": expect, "launches": runs["placed"]["launches"],
           "want_gathers_per_step": list(want_gathers), "leaves": len(digests["placed"]),
           "leaves_bit_identical": len(digests["placed"]) - len(differ),
           "differing_leaves": differ, "step_ms_mesh_free": runs["mesh_free"]["steps"][-1]["ms"],
           "step_ms_placed": runs["placed"]["steps"][-1]["ms"],
           "peak_mem_gb": max(r["peak_mem_gb"] for r in runs.values()), "runs": runs,
           "phase_s": time.perf_counter() - t_phase}
    log(f"  mesh train: {json.dumps(res)}")
    got_gathers = (runs["placed"]["param_gathers"], runs["placed"]["grad_reduce_scatters"])
    if differ or any(r["launches"] != expect for r in runs.values()) or \
            got_gathers != want_gathers or runs["placed"]["model_gathers"] or \
            not all(math.isfinite(m[k]) for r in runs.values() for m in r["steps"]
                    for k in ("loss", "grad_norm")):
        raise AssertionError(f"mesh train step of {arch} against the mesh-free one: {res}")
    return res


# ------------------------------------------------------------------ (j4) placed serving

def _wave_tokens(prompts) -> torch.Tensor:
    """The wave's prompts left-padded with token 0, as ``BatchServer`` pads them."""
    toks = torch.zeros((len(prompts), max(map(len, prompts))), dtype=torch.long)
    for i, prompt in enumerate(prompts):
        toks[i, toks.shape[1] - len(prompt):] = torch.tensor(prompt)
    return toks.cuda()


def _wave(cfg, prefill, decode, toks, steps: int, forced=None, decode_kernel_steps=True):
    """A prefill of ``toks`` and ``steps`` greedy decode steps through
    ``prefill(toks)``/``decode(token, cache, cache_len)`` (whose logits are
    whole tensors), each token the argmax of the step before or, teacher
    forced, ``forced[i]``; each phase timed, the kernels' launches of the
    prefill counted, the decode kernel's launches of the decode steps checked
    (once a layer with attention a step, or none where not
    ``decode_kernel_steps``), and the run's own peak of device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = prefill(toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    counts = launches()
    steps_logits, tokens = [logits], [logits[:, -1, :cfg.vocab].argmax(-1)]
    t0 = time.perf_counter()
    for i in range(steps):
        nxt = tokens[-1] if forced is None else forced[i]
        logits, cache = decode(nxt[:, None], cache, toks.shape[1] + i)
        steps_logits.append(logits)
        tokens.append(logits[:, -1, :cfg.vocab].argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del cache
    want = {**counts, "decode_attention": counts["decode_attention"]
            + (steps * decode_sites(cfg) if decode_kernel_steps else 0)}
    if launches() != want:
        raise AssertionError(f"decode launches {launches()} after prefill's {counts}, "
                             f"expected {want}")
    return steps_logits, tokens, {"prefill_s": prefill_s, "decode_s": decode_s,
                                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                                  "launches": counts}


def placed_wave(cfg, api, params, prompts, mesh, smax: int, steps: int):
    """(j4): one wave of (d)'s prompts through ``placed_prefill`` and ``steps``
    ``placed_decode`` steps on DTensor params, tokens and cache placed as the
    reference places its serving calls on ``mesh``, against the mesh-free
    wave on the same weights: every step's logits and tokens bit for bit (a
    group of one changes no sum), each prefill launching the kernels
    ``expected_launches`` names and each decode step the decode kernel once a
    layer with attention.  Then, for a model with a K/V cache, the same wave
    with it split by its sequence (``ctx.force_sequence_split``: the
    context-parallel decode attention, its softmax reduced over "model", the
    einsums and no decode kernel), teacher-forced with the first wave's
    tokens, within ``SERVE_TOL``, and with the same prefill launches."""
    t_phase = time.perf_counter()
    log(f"(j4) placed serving {cfg.name}: one wave of {len(prompts)} prompts and {steps} decode "
        f"steps on a {tuple(mesh.shape)} {mesh.mesh_dim_names} mesh of one NCCL rank")
    toks = _wave_tokens(prompts)
    n_tokens = sum(map(len, prompts))
    placed = shd.distribute_tree(params, shd.param_shardings(cfg, params, mesh), mesh)

    def place(x):
        return shd.distribute(x, shd.input_shardings(mesh, {"x": x})["x"], mesh)

    def whole_logits(out):
        logits, cache = out
        return logits.full_tensor(), cache

    def placed_fns():
        return (lambda t: whole_logits(placed_prefill(cfg, placed, place(t), smax, "bfloat16",
                                                      mesh)),
                lambda tok, cache, n: whole_logits(placed_decode(cfg, placed, place(tok), cache,
                                                                 n, mesh)))

    with torch.no_grad():
        placed_fns()[0](toks[:, :64])      # warm-up: the group's first collectives
        want, want_tokens, plain = _wave(cfg, lambda t: api.prefill(params, t, smax),
                                         lambda tok, c, n: api.decode(params, tok, c, n),
                                         toks, steps)
        got, got_tokens, run = _wave(cfg, *placed_fns(), toks, steps)
        runs = {"mesh_free": plain, "placed": run}
        seq = []
        if cfg.family != "ssm":
            with ctx.force_sequence_split():
                seq, _, runs["placed_sequence_split"] = _wave(cfg, *placed_fns(), toks, steps,
                                                              forced=want_tokens[:-1],
                                                              decode_kernel_steps=False)
    for r in runs.values():
        r.update(prefill_tok_s=n_tokens / r["prefill_s"],
                 decode_tok_s=len(prompts) * steps / r["decode_s"])
    identical = sum(torch.equal(g, w) for g, w in zip(got, want))
    seq_errs = [rel_close(g, w, SERVE_TOL[cfg.name])[1] for g, w in zip(seq, want)]
    want_launches = {name: expected_launches(cfg).get(name, 0) for name in KERNELS}
    res = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": list(mesh.shape),
           "mesh_axes": list(mesh.mesh_dim_names), "batch": len(prompts),
           "prompt_lengths": list(map(len, prompts)), "smax": smax, "decode_steps": steps,
           "steps_bit_identical": identical, "steps": len(want),
           "tokens_equal": all(torch.equal(g, w) for g, w in zip(got_tokens, want_tokens)),
           "sequence_split_tolerance": SERVE_TOL[cfg.name],
           "sequence_split_max_err": max(seq_errs, default=None),
           "sequence_split_errs": seq_errs,
           "expected_launches": want_launches, "runs": runs,
           "phase_s": time.perf_counter() - t_phase}
    log(f"  placed serving: {json.dumps(res)}")
    if identical != len(want) or not res["tokens_equal"] or \
            max(seq_errs, default=0.0) > SERVE_TOL[cfg.name] or \
            any(r["launches"] != want_launches for r in runs.values()) or \
            not all(torch.isfinite(g).all() for g in got + seq):
        raise AssertionError(f"placed serving against the mesh-free wave: {res}")
    return res


# ------------------------------------------------------------------ (h) MoE serving

def depth_cut(full, headroom: float) -> tuple:
    """``full`` cut to the most layers whose bf16 weights fit the card beside ``headroom``
    bytes, reckoned from param_count(), and whose init fits it: ``layers.init_stacked``
    holds the first layer's draw beside the stacked leaves, so n + 1 layers and the
    embeddings, with INIT_SPARE_BYTES to spare; and the cut stated with its bytes."""
    emb_bytes = 2 * dataclasses.replace(full, n_layers=0).param_count()
    layer_bytes = 2 * dataclasses.replace(full, n_layers=1).param_count() - emb_bytes
    total = torch.cuda.get_device_properties(0).total_memory
    serve_fit = int((total - headroom - emb_bytes) // layer_bytes)
    init_fit = int((total - INIT_SPARE_BYTES - emb_bytes) // layer_bytes) - 1
    n_layers = min(full.n_layers, serve_fit, init_fit)
    if n_layers < 1:
        raise AssertionError(f"{full.name}: not one layer fits beside {headroom / 1e9} GB")
    cut = (f"{n_layers} of {full.n_layers} layers, full width: {layer_bytes / 1e9:.3f} GB of "
           f"bf16 a layer and {emb_bytes / 1e9:.3f} GB of embeddings (param_count()); "
           f"{serve_fit} fit beside {headroom / 1e9:.0f} GB left free of the card's "
           f"{total / 1e9:.1f} GB, {init_fit} beside the init's extra layer and "
           f"{INIT_SPARE_BYTES / 1e9:.0f} GB")
    return dataclasses.replace(full, n_layers=n_layers), cut, layer_bytes, emb_bytes


MOE_NAMED_OPS = ("index", "gather", "scatter", "sort", "cumsum", "topk", "nvjet", "gemm")


@contextlib.contextmanager
def moe_groups(groups: int):
    """The local dispatch routes in ``groups`` groups for the block."""
    saved = moe.moe_block

    def block(cfg, p, x, groups_=16, mlp=None):
        return saved(cfg, p, x, groups=groups, mlp=mlp)

    moe.moe_block = block
    try:
        yield
    finally:
        moe.moe_block = saved


def ep_prefill(cfg, api, params, mesh, b: int, t: int, smax: int, tol: float):
    """(j2): one prefill wave through the expert-parallel ``moe_block_shard_map``
    on ``mesh`` (routing in one group a data rank), against the local
    dispatch routed in dp groups on the same weights and the mesh wave's
    expert choices; logits, dropped slots by layer, and each wave's tok/s."""
    t_phase = time.perf_counter()
    mp = mesh.size(mesh.mesh_dim_names.index("model"))
    dp = mesh.size(mesh.mesh_dim_names.index("data"))
    log(f"(j2) {cfg.name}: one prefill wave (B={b}, T={t}) through moe_block_shard_map, "
        f"{cfg.n_experts // mp} experts a rank")
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")
    with torch.inference_mode():
        api.prefill(params, toks[:, :64], 64)      # warm-up
        reset_launches()
        with ctx.mesh_context(mesh), moe_routing() as (chosen, _, dropped_mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_m, cache = api.prefill(params, toks, smax)
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
        counts = launches()
        del cache
        shared = [(slice(None), c) for c in chosen]
        with moe_groups(dp), moe_routing(shared) as (_, rerouted, dropped_local):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_l, cache = api.prefill(params, toks, smax)
            torch.cuda.synchronize()
            local_s = time.perf_counter() - t0
        del cache
    ok, err = rel_close(logits_m, logits_l, tol)
    want = {name: (cfg.n_layers if name == "flash_attention_fwd" else 0) for name in KERNELS}
    res = {"arch": cfg.name, "layers": cfg.n_layers, "mesh": list(mesh.shape),
           "experts_per_rank": cfg.n_experts // mp, "batch": b, "seq": t, "smax": smax,
           "capacity_factor": cfg.capacity_factor, "tolerance": tol,
           "mesh_vs_local_groups_dp_err": err, "dropped_by_layer_mesh": dropped_mesh,
           "dropped_by_layer_local": dropped_local, "tokens_rerouted_by_layer": rerouted,
           "prefill_s_mesh": mesh_s, "prefill_s_local": local_s,
           "prefill_tok_s_mesh": b * t / mesh_s, "prefill_tok_s_local_groups_dp": b * t / local_s,
           "launches": counts, "logit_absmax": float(logits_l.float().abs().max()),
           "phase_s": time.perf_counter() - t_phase}
    log(f"  ep prefill: {json.dumps(res)}")
    if not (ok and counts == want and dropped_mesh == dropped_local
            and torch.isfinite(logits_m).all()):
        raise AssertionError(f"expert-parallel prefill against the local dispatch: {res}")
    return res


def phase_moe_serving(mesh):
    """(h): mixtral-8x22b at full width, cut to the layers the card holds; and
    (j2) on ``mesh``."""
    cfg, cut, _, _ = depth_cut(get_arch(MOE_ARCH), MOE_HEADROOM_BYTES)
    log(f"(h) serving {MOE_ARCH}, cut to {cut}: {json.dumps(dataclasses.asdict(cfg))}")
    torch.cuda.reset_peak_memory_stats()
    api = get_model(cfg)
    params, n_params = init_serving_params(api)
    gen = torch.Generator().manual_seed(1)
    lengths = torch.randint(3072, 6145, (8,), generator=gen).tolist()
    if sum(n > cfg.swa_window for n in lengths) < 2:
        raise AssertionError(f"fewer than two prompts longer than the window: {lengths}")
    serving = serve_requests(MOE_ARCH, cfg, api, params, n_params,
                             draw_prompts(cfg, lengths, gen), smax=8192)
    serving.update(cut=cut, window=cfg.swa_window,
                   prompts_past_window=sum(n > cfg.swa_window for n in lengths))
    # no token can drop at capacity_factor = E / k (an expert takes at most one
    # choice a token), so decode and a longer prefill route alike
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    t_long = cfg.swa_window + 300
    serving["consistency"] = check_consistency(no_drop, get_model(no_drop), params,
                                               SERVE_TOL[MOE_ARCH], t_long)
    free_device_memory()
    serving["ep_prefill"] = ep_prefill(cfg, api, params, mesh, 4, max(lengths[:4]), 8192,
                                       SERVE_TOL[MOE_ARCH])
    free_device_memory()
    serving["profile"] = profile_wave(cfg, api, params, 4, max(lengths), 8192,
                                      named=MOE_NAMED_OPS)
    del params
    free_device_memory()
    cfg2 = dataclasses.replace(no_drop, n_layers=2)
    api2 = get_model(cfg2)
    params32, _ = init_serving_params(api2, torch.float32)
    serving["consistency_fp32"] = {
        "layers": 2,
        "bf16_kv_cache": check_consistency(cfg2, api2, params32, SERVE_TOL[MOE_ARCH], t_long)}
    with fp32_kv_cache():
        serving["consistency_fp32"]["fp32_kv_cache"] = check_consistency(cfg2, api2, params32,
                                                                         FP32_TOL, t_long)
    del params32
    free_device_memory()
    serving["phase_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return serving



# ------------------------------------------------------------------ (d2) the other archs

def phase_serving_extra(arch: str):
    """(d2) for ``arch``: one wave through ``BatchServer`` at full width in bf16 (cut in
    depth where the card requires), its launches checked, then decode vs prefill and
    kernel path vs plain path (an MoE model on shared expert choices, at a capacity
    factor with no drops)."""
    full = get_arch(arch)
    cfg, cut, layer_bytes, emb_bytes = depth_cut(full, MOE_HEADROOM_BYTES)
    log(f"(d2) serving {arch}, {cut}: {json.dumps(dataclasses.asdict(cfg))}")
    torch.cuda.reset_peak_memory_stats()
    api = get_model(cfg)
    params, n_params = init_serving_params(api)
    gen = torch.Generator().manual_seed(1)
    lengths = torch.randint(*EXTRA_PROMPT_LENGTHS, (EXTRA_REQUESTS,), generator=gen).tolist()
    serving = serve_requests(arch, cfg, api, params, n_params, draw_prompts(cfg, lengths, gen),
                             smax=1024, batch=EXTRA_REQUESTS, max_new=EXTRA_MAX_NEW)
    serving.update(cut=cut, full_layers=full.n_layers, layer_bytes=layer_bytes,
                   embedding_bytes=emb_bytes)
    checked = cfg
    if cfg.n_experts:   # no token can drop at capacity_factor = E / k
        checked = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    serving["consistency"] = check_consistency(checked, get_model(checked), params,
                                               SERVE_TOL[arch])
    del params
    free_device_memory()
    serving["phase_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return serving


# ------------------------------------------------------------------ (m) the launchers

def launcher_kernels(cfg) -> tuple:
    """The kernels a reduced ``cfg`` must launch through ``launch.train`` (forward and
    backward) and through ``launch.serve`` (forward): the scans' for the ssm and
    hybrid families, the flash kernels' and the decode kernel for the attention
    families (zamba2's shared-block cache takes the weights' dtype, fp32 in the
    serving launcher, so its decode runs the einsums)."""
    if cfg.family == "ssm":
        return ("wkv6_fwd", "wkv6_bwd"), ("wkv6_fwd",)
    if cfg.family == "hybrid":
        return ("ssd_fwd", "ssd_bwd"), ("ssd_fwd",)
    return ("flash_attention_fwd", "flash_attention_bwd"), ("flash_attention_fwd",
                                                            "decode_attention")


def phase_launchers() -> dict:
    """(m): ``python -m repro_torch.launch.train`` (4 steps, a crash after step 3 and the
    resume) and ``python -m repro_torch.launch.serve`` for each of ``LAUNCH_ARCHS`` on
    the card, in this process: the reference's reduced configs (scan head size 32,
    zamba2-7b's SSD state 16; head size 32 and, for mixtral-8x22b, a window of 64)
    through the scan kernels or the flash kernels, forward and backward."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    out = {}
    for arch in LAUNCH_ARCHS:
        t0 = time.perf_counter()
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            trainer = launch_train.main(["--arch", arch, "--steps", "4", "--ckpt-every", "2",
                                         "--crash-at", "3"])
        train_counts = launches()
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as served:
            launch_serve.main(["--arch", arch])
        serve_counts = launches()
        cfg = trainer.cfg
        train_kernels, serve_kernels = launcher_kernels(cfg)
        res = {"arch": arch, "config": dataclasses.asdict(cfg), "steps": trainer.step,
               "losses": [h["loss"] for h in trainer.history],
               "train_launches": train_counts, "serve_launches": serve_counts,
               "served": served.getvalue().strip().splitlines()[-1],
               "wall_s": time.perf_counter() - t0}
        log(f"(m) launchers: {json.dumps(res)}")
        if not (cfg == get_arch(arch).reduced() and trainer.step == 4
                and all(math.isfinite(x) for x in res["losses"])
                and all(train_counts[k] > 0 for k in train_kernels)
                and all(serve_counts[k] > 0 for k in serve_kernels)
                and "resumed at step" in printed.getvalue()):
            raise AssertionError(f"{arch}: the launchers on the card: {res}")
        out[arch] = res
    return out


# ------------------------------------------------------------------ (k) counts against the card

BF16_PEAK = roofline.PEAK_FLOPS["bf16"]
# the dry run's peak of live bytes against the card's count of the same call: a copy
# that one makes and the other does not (strides; see roofline.Count) may be live at
# the peak
PEAK_COUNT_TOL = 0.01
PREFILL_WAVES = 5           # timed waves of each (k) prefill; the shares read their median
# the dry run's production cells run in a subprocess (which imports no JAX), each one
DRYRUN_CELLS = (("minicpm-2b", "train_4k"), ("mixtral-8x22b", "decode_32k"))
DRYRUN_TIMEOUT_S = 300
# (l2): mdtest's seven metadata operations (benchmarks/mdtest.py) on mdtest's smoke
# clusters of MD_NODES nodes, one client with MD_PROCS procs, MD_ITEMS items a proc,
# MD_DIR_STATS listings a proc of a directory of MD_STAT_FILES files, a binary tree of
# MD_TREE_DEPTH levels; then an OSD joins after a three-stripe write_file
MD_NODES = 4
MD_PROCS = 4
MD_ITEMS = 12
MD_STAT_FILES = 64
MD_DIR_STATS = 4
MD_TREE_DEPTH = 4
MD_STRIPED_BYTES = 9 * 1024 * 1024


def _work(count) -> dict:
    """What the counts compare: flops by rate, bytes, collectives (copies apart)."""
    return {k: v for k, v in count.totals().items() if k != "copy_bytes"}


def _counted(fn, args, tracks, device: str, grad: bool):
    count = roofline.Count(device)
    for i, category in tracks:
        count.track(args[i], category)
    with torch.set_grad_enabled(grad), count:
        fn(*args)
    return count


def count_against_card(label, fn, args, tracks, grad, timing, model_flops, want_launches):
    """(k): ``fn(*args)``, a call of the main path, counted twice by ``roofline.Count``:
    on the card with real tensors (the kernels launch, and their counters rise by
    ``want_launches``), and as the dry run lowers it, on fake CPU twins of ``args``
    through the kernels' operators (``ops.kernel_path``).  Fatal if the lowering's
    flops or bytes differ from the card's count at all, if its peak of live bytes (the
    dry run's memory column) differs from the card's count by more than
    ``PEAK_COUNT_TOL``, or if it moved a launch counter.  Beside the call's measured ms
    (``timing``: the median and spread of several timed calls): the roofline bound on
    the H100's published peaks, ``roofline_share`` (bound / measured), ``mfu`` (model
    flops / (measured s x the bf16 peak)), and the dry run's peak against
    max_memory_allocated()."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    free_device_memory()
    allocated_before = torch.cuda.memory_allocated()
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    real = _counted(fn, args, tracks, "cuda", grad)
    torch.cuda.synchronize()
    measured_peak = torch.cuda.max_memory_allocated()
    real_launches = launches()
    with FakeTensorMode(), ops.kernel_path():
        lowered = _counted(fn, dryrun.fake_twin(args, "cpu"), tracks, "cpu", grad)
    FakeTensorMode.cache_clear()    # its class-wide cache would stay in the heap
    moved = launches() != real_launches
    want = {name: want_launches.get(name, 0) for name in KERNELS}
    terms = roofline.roofline_terms(lowered.totals())
    measured_ms = timing["ms"]
    predicted, counted_peak = lowered.memory()["peak_bytes"], real.memory()["peak_bytes"]
    res = {"call": label, "measured_ms": measured_ms, "timing": timing,
           "bound_ms": terms["bound_s"] * 1e3, "dominant": terms["dominant"],
           "terms_ms": {k: terms[f"{k}_s"] * 1e3 for k in ("compute", "memory", "collective")},
           "roofline_share": terms["bound_s"] * 1e3 / measured_ms,
           "model_flops": model_flops, "mfu": model_flops / (measured_ms / 1e3 * BF16_PEAK),
           "totals": lowered.totals(), "dryrun_lowering_equal": _work(lowered) == _work(real),
           "copy_bytes": {"card": real.copy_bytes, "dryrun_lowering": lowered.copy_bytes},
           "kernel_calls": dict(real.kernel_calls), "launches": real_launches,
           "fake_lowering_moved_launches": moved,
           "predicted_peak_gb": predicted / 1e9,
           "predicted_peak_by_category_gb": {k: v / 1e9 for k, v in
                                             lowered.memory()["peak_by_category"].items()},
           "card_count_peak_gb": counted_peak / 1e9,
           "predicted_over_card_count": predicted / counted_peak,
           "measured_peak_gb": measured_peak / 1e9,
           "allocated_before_gb": allocated_before / 1e9, "peak_before_gb": peak_before / 1e9,
           "predicted_over_measured": predicted / measured_peak,
           "memory_gap_over_15pct": abs(predicted / measured_peak - 1) > 0.15,
           "phase_s": time.perf_counter() - t0}
    log(f"(k) {label}: {json.dumps(res)}")
    if not res["dryrun_lowering_equal"] or moved or real_launches != want \
            or dict(lowered.kernel_calls) != res["kernel_calls"] \
            or abs(predicted / counted_peak - 1) > PEAK_COUNT_TOL:
        raise AssertionError(f"(k) {label}: the lowering's and the card's counts differ, the "
                             f"lowering launched, or the launches {real_launches} are not "
                             f"{want}: card {_work(real)} peak {counted_peak}, lowered "
                             f"{_work(lowered)} peak {predicted}")
    return res


def _timing(runs_ms) -> dict:
    """The median of several timed calls (ms), which the shares read, and their spread."""
    return {"ms": statistics.median(runs_ms), "runs_ms": runs_ms,
            "min_ms": min(runs_ms), "max_ms": max(runs_ms)}


def prefill_counts(cfg, api, params, lengths, smax):
    """(k) for a serving model: one prefill wave of (d)'s longest prompts (B=4), timed
    PREFILL_WAVES times uncounted after a warm call, then counted."""
    b, t = 4, max(lengths)
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")
    call = lambda p, x: api.prefill(p, x, smax)  # noqa: E731
    runs = []
    with torch.inference_mode():
        call(params, toks)
        for _ in range(PREFILL_WAVES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(params, toks)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
    flops = roofline.model_flops_per_device(cfg, _shape("prefill", b, t), 1)
    return count_against_card(f"{cfg.name} prefill B={b} T={t}", call, (params, toks),
                              ((0, "params"), (1, "other")), False, _timing(runs), flops,
                              expected_launches(cfg))


def train_counts(cfg, oc, step, params, state, batch, step_ms):
    """(k) for a training model: one more ``make_train_step`` step, counted; the
    measured ms is the median of (f)'s, (i)'s or (f2)'s steps after the first."""
    b, t = batch["tokens"].shape
    flops = roofline.model_flops_per_device(cfg, _shape("train", b, t), 1)
    return count_against_card(
        f"{cfg.name} train step ({cfg.n_layers} layers) B={b} T={t}", step,
        (params, state, batch), ((0, "params"), (1, "opt_state"), (2, "other")), True,
        _timing(step_ms), flops, train_launches(cfg))


def _shape(kind: str, batch: int, seq: int) -> ShapeConfig:
    return ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)


def dispatch_overhead(iters: int = 2000) -> dict:
    """Host microseconds a call that a kernel's operator adds to its wrapper: K1 at
    B=1, T=64, 2 heads of 64 (a few microseconds of device time, so the loop waits on
    the host), timed over ``iters`` calls each way after a warm-up.  These launches
    are outside every main path's count."""
    q, k, v = _inputs_small()

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e6
    rounds = [(per_call(lambda: flash_attention_fwd(q, k, v)),
               per_call(lambda: torch.ops.repro_torch.flash_attention_fwd(q, k, v, 0, 0)))
              for _ in range(2)]
    wrapper, op = min(r[0] for r in rounds), min(r[1] for r in rounds)
    res = {"kernel": "flash_attention_fwd", "shape": list(q.shape), "iters": iters,
           "wrapper_us": wrapper, "operator_us": op, "added_us": op - wrapper}
    log(f"(k) operator dispatch: {json.dumps(res)}")
    return res


def _inputs_small():
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn((1, 64, 2, 1, 64), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, 64, 2, 64), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, k.clone()


def dryrun_cells() -> dict:
    """The dry run's production cells, each in a subprocess (the command a user runs;
    it imports no JAX and touches no card: CUDA_VISIBLE_DEVICES is empty), both at
    once after the last timed phase, so that they share the host with no timing;
    returns their records' lower_s and bound_s.  The processes are killed on the way
    out."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", "single", "--out", out], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for arch, shape in DRYRUN_CELLS]
        try:
            outputs = [p.communicate(timeout=DRYRUN_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        cells = []
        for (arch, shape), p, text in zip(DRYRUN_CELLS, procs, outputs):
            path = Path(out) / f"{arch}__{shape}__pod16x16.json"
            if p.returncode != 0 or not path.exists():
                raise AssertionError(f"dry run of {arch} {shape} failed "
                                     f"({p.returncode}):\n{text[-3000:]}")
            rec = json.loads(path.read_text())
            cells.append({k: rec[k] for k in (
                "arch", "shape", "mesh", "ok", "lower_s", "total_s", "roofline", "memory",
                "cost", "collective_bytes", "flops_over_model_flops")})
    res = {"cells": cells, "waited_s": time.perf_counter() - t0}
    log(f"(k) dry run: {json.dumps(res)}")
    return res


# ------------------------------------------------------------------ (l) lint and baseline

def phase_lint() -> dict:
    """(l1): the port's determinism lint over its shipped tree, as
    ``python -m repro_torch.analysis.lint`` runs it; fatal on a finding or a
    grandfathered key."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lint.main([])
    keys = lint.load_baseline(lint.BASELINE_PATH)
    res = {"rc": rc, "report": out.getvalue().strip(), "grandfathered_keys": len(keys)}
    log(f"(l1) lint: {json.dumps(res)}")
    if rc != 0 or keys:
        raise AssertionError(f"the port's lint is not clean: {res}")
    return res


def _md_systems():
    """mdtest's smoke clusters (benchmarks/mdtest.py make_cfs(4), make_ceph(4)) and
    one client's mount of each, as the benchmark spells its ops: CFS through the
    ``CfsVfs`` fd calls, the Ceph-like system through ``CephLikeMount``."""
    cfs = CfsCluster(n_meta=MD_NODES, n_data=MD_NODES, meta_mem_capacity=512 * 1024 * 1024,
                     extent_max_size=8 * 1024 * 1024, seed=42)
    cfs.create_volume("bench", n_meta_partitions=MD_NODES, n_data_partitions=3 * MD_NODES)
    ceph = CephLikeCluster(n_mds=MD_NODES, n_osd=MD_NODES, seed=42, mds_cache_entries=3000)
    return {"cfs": (cfs, cfs.mount("bench", client_id="c0").vfs),
            "ceph": (ceph, CephLikeMount(ceph, "c0"))}


def _md_ops(system: str, mnt):
    """mdtest's file creation and DirStat as each system spells them."""
    if system == "cfs":
        def creat(path):
            mnt.close(mnt.open(path, O_WRONLY | O_CREAT | O_TRUNC))
        return creat, mnt.readdir_plus
    return (lambda path: mnt.write_file(path, b"")), mnt.dir_stat


def _md_run(net, streams, rows: list, label: str) -> dict:
    """One operation's streams on the event scheduler from a fresh timeline, as
    ``benchmarks/common.py``'s ``run_streams`` runs them (less its FUSE queue):
    each stream's next op is dispatched, as a timed op, when its last one
    completes.  Appends each op's (label, stream, start, end, msgs, bytes, disk
    IOs) to ``rows``; returns the op count, makespan and mean modeled us per op."""
    net.reset_accounting()
    sched = EventScheduler()
    lat = []

    def dispatch(t, si, it):
        thunk = next(it, None)
        if thunk is None:
            return
        op = net.begin_op(at=t)
        try:
            thunk()
        finally:
            net.end_op()
        rows.append((label, si, t, op.now_us, op.msgs, op.bytes, op.disk_ops))
        lat.append(op.now_us - t)
        sched.at(op.now_us, dispatch, si, it)

    for si, ops in enumerate(streams):
        sched.at(0.0, dispatch, si, iter(ops))
    makespan = sched.run()
    return {"ops": len(lat), "makespan_us": makespan, "us_per_op": sum(lat) / len(lat)}


def _md_tree(root: str) -> list:
    paths, frontier = [root], [root]
    for _ in range(MD_TREE_DEPTH):
        frontier = [f"{p}/t{b}" for p in frontier for b in range(2)]
        paths += frontier
    return paths


def metadata_run() -> tuple:
    """(l2)'s workload once: the seven operations on both systems, then a
    multi-stripe file and an OSD join on the Ceph-like one.  Returns the
    trajectory (every op's modeled time and counts, the join), each operation's
    figures and the join's."""
    rows, figures = [], {}
    for system, (cluster, mnt) in _md_systems().items():
        net, creat, dir_stat = cluster.net, *_md_ops(system, mnt)
        base, procs = "/md", range(MD_PROCS)
        mnt.mkdir(base)
        names = [f"{pi}_{i}" for pi in procs for i in range(MD_ITEMS)]

        def listed(prefix):
            return sorted(n for n in mnt.readdir(base) if n.startswith(prefix))

        def per_proc(fn):
            return [[lambda pi=pi, i=i: fn(f"{pi}_{i}") for i in range(MD_ITEMS)]
                    for pi in procs]
        figures[system] = fig = {}
        fig["DirCreation"] = _md_run(net, per_proc(lambda n: mnt.mkdir(f"{base}/d{n}")),
                                     rows, f"{system} DirCreation")
        assert listed("d") == sorted(f"d{n}" for n in names), system
        mnt.mkdir(f"{base}/statdir")
        for i in range(MD_STAT_FILES):
            creat(f"{base}/statdir/f{i}")
        counts = []
        fig["DirStat"] = _md_run(
            net, [[lambda: counts.append(len(dir_stat(f"{base}/statdir")))] * MD_DIR_STATS
                  for _ in procs], rows, f"{system} DirStat")
        assert counts == [MD_STAT_FILES] * (MD_PROCS * MD_DIR_STATS), (system, counts)
        fig["DirRemoval"] = _md_run(net, per_proc(lambda n: mnt.rmdir(f"{base}/d{n}")),
                                    rows, f"{system} DirRemoval")
        assert listed("d") == [], system
        fig["FileCreation"] = _md_run(net, per_proc(lambda n: creat(f"{base}/f{n}")),
                                      rows, f"{system} FileCreation")
        assert listed("f") == sorted(f"f{n}" for n in names), system
        fig["FileRemoval"] = _md_run(net, per_proc(lambda n: mnt.unlink(f"{base}/f{n}")),
                                     rows, f"{system} FileRemoval")
        assert listed("f") == [], system
        # tree ops are dependent (each mkdir needs its parent): one serial chain
        tree = _md_tree(f"{base}/tree")
        fig["TreeCreation"] = _md_run(net, [[lambda p=p: mnt.mkdir(p) for p in tree]],
                                      rows, f"{system} TreeCreation")
        assert sorted(mnt.readdir(tree[-1].rsplit("/", 1)[0])) == ["t0", "t1"], system
        bottom_up = sorted(tree, key=lambda p: -p.count("/"))
        fig["TreeRemoval"] = _md_run(net, [[lambda p=p: mnt.rmdir(p) for p in bottom_up]],
                                     rows, f"{system} TreeRemoval")
        assert mnt.readdir(base) == ["statdir"], (system, mnt.readdir(base))
        rows.append((system, "net", net.stats.msgs, net.stats.bytes))
    ceph, mnt = _md_systems()["ceph"]
    data = bytes(range(256)) * (MD_STRIPED_BYTES // 256)
    mnt.write_file("/striped", data)
    op = ceph.net.begin_op(at=0.0)
    try:
        osd, moved = ceph.add_osd()
    finally:
        ceph.net.end_op()
    assert moved > 0 and ceph.migrated_bytes == moved, (moved, ceph.migrated_bytes)
    assert mnt.read_file("/striped") == data
    join = {"osd": osd, "file_bytes": len(data), "migrated_bytes": moved,
            "modeled_us": op.now_us, "disk_ios": op.disk_ops}
    rows.append(("ceph add_osd", join))
    return rows, figures, join


def phase_metadata() -> dict:
    """(l2): ``metadata_run`` twice with one seed; fatal unless both give the same
    trajectory.  The process-wide counters that number networks and extents are
    set back between the runs, so that the second starts where the first did.
    Prints each operation's modeled us per op on both systems (the simulation's
    virtual clock, not a time of the card) and their ratio."""
    t0 = time.perf_counter()
    counters = (Network._created, CfsClient._extent_counter)
    first, figures, join = metadata_run()
    Network._created, CfsClient._extent_counter = counters
    second = metadata_run()[0]
    if first != second:
        diff = next((i for i, (a, b) in enumerate(zip(first, second)) if a != b),
                    min(len(first), len(second)))
        raise AssertionError(f"(l2) reruns part at row {diff} of {len(first)} and "
                             f"{len(second)}")
    ops = {name: {"cfs_us_per_op": figures["cfs"][name]["us_per_op"],
                  "ceph_us_per_op": figures["ceph"][name]["us_per_op"],
                  "ceph_over_cfs": figures["ceph"][name]["us_per_op"]
                  / figures["cfs"][name]["us_per_op"]} for name in figures["cfs"]}
    res = {"clock": "modeled us on the simulation's virtual clock, not a time of the card",
           "procs": MD_PROCS, "items_a_proc": MD_ITEMS, "dir_stat_entries": MD_STAT_FILES,
           "tree_dirs": len(_md_tree("/")), "ops": ops, "figures": figures, "add_osd": join,
           "trajectory_rows": len(first), "wall_s": time.perf_counter() - t0}
    for name, o in ops.items():
        log(f"(l2) {name}: modeled {o['cfs_us_per_op']:.3f} us/op on CFS, "
            f"{o['ceph_us_per_op']:.3f} us/op on the Ceph-like baseline, ratio "
            f"{o['ceph_over_cfs']:.3f} (virtual clock, not a time of the card)")
    log(f"(l2) add_osd after a {join['file_bytes'] / 2**20:.0f} MiB write_file: "
        f"{json.dumps(join)}")
    return res


# ------------------------------------------------------------------ main

def kernel_line(name, source, replaces, case, launches_by_path, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
            "max_abs_err": case["max_abs_err"], "tolerance": case["tolerance"],
            "ms": case["ms"], "kernel_ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"], "shape": case["shape"],
            "flops": case["flops"], "bytes": case["bytes"], **extra}


def _bwd_extra(case) -> dict:
    keys = ("sub_kernel_device_ms", "occupancy", "workspace_bytes", "workspace_traffic_bytes",
            "bound_ms_with_workspace")
    return {k: case[k] for k in keys}


def _scan_extra(case, tensor_cores, source) -> dict:
    keys = ("bound_ms_fp32_cuda_cores", "rerun_bit_identical")
    return {**{k: case[k] for k in keys},
            "bound_peak": "bytes at 3.35 TB/s, flops at the 494.7 TFLOP/s TF32 peak",
            "sass_HMMA_HGMMA": tensor_cores["counts"][f"{source}_HMMA_HGMMA"],
            "kernels_resources": tensor_cores["kernels"][source]}


def main() -> None:
    smi = device_line()
    name = torch.cuda.get_device_name(0)
    log(f"(a) device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    sources = ["flash_attention", "flash_attention_bwd", "checksum", *SCAN_SOURCES,
               "decode_attention", "mamba2_step"]
    t0 = time.perf_counter()
    _build.build_all(sources)
    build_s = time.perf_counter() - t0
    log(f"(b) built {', '.join(s + '.cu' for s in sources)} in {build_s:.1f} s")
    tensor_cores = tensor_core_proof()

    # (j): a world of one NCCL rank, through a rendezvous file; NCCL failing is fatal
    with tempfile.TemporaryDirectory() as rendezvous:
        init_process_group(str(Path(rendezvous) / "pg"), 0, 1, "nccl", PG_TIMEOUT_S)
        try:
            run_phases(smi, name, t_start, build_s, tensor_cores,
                       make_host_mesh(1, 1, "cuda"))
        finally:
            dist.destroy_process_group()
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def run_phases(smi, name, t_start, build_s, tensor_cores, mesh) -> None:
    """Phases (c) to (l) and the JSON lines of (e), all but the last two."""
    t0 = time.perf_counter()
    baseline = {"lint": phase_lint(), "metadata": phase_metadata()}
    baseline["wall_s"] = time.perf_counter() - t0
    log(f"(l) the lint and the metadata operations took {baseline['wall_s']:.3f} s wall "
        f"on the host beside {smi}")
    flash, flash_bwd, checksum, wkv6, ssd, wkv6_bwd_cases, ssd_bwd_cases, reduced, decode = \
        phase_kernels()
    peaks = [torch.cuda.max_memory_allocated() / 1e9]
    free_device_memory()
    servings = {}
    for arch in ("codeqwen1.5-7b", "zamba2-7b", "rwkv6-1.6b"):
        servings[arch] = phase_serving(arch, mesh)
        peaks.append(servings[arch]["phase_peak_mem_gb"])
        free_device_memory()
    servings[PUB_ARCH] = phase_published()
    published = servings[PUB_ARCH]["kernels"]
    peaks.append(servings[PUB_ARCH]["phase_peak_mem_gb"])
    free_device_memory()
    training = phase_training()
    peaks.append(training["phase_peak_mem_gb"])
    free_device_memory()
    trainer = phase_trainer()
    peaks.append(trainer["peak_mem_gb"])
    free_device_memory()
    mesh_train = phase_mesh_train(mesh)
    peaks.append(mesh_train["peak_mem_gb"])
    free_device_memory()
    servings[MOE_ARCH] = phase_moe_serving(mesh)
    peaks.append(servings[MOE_ARCH]["phase_peak_mem_gb"])
    free_device_memory()
    for arch in EXTRA_SERVE:
        servings[arch] = phase_serving_extra(arch)
        peaks.append(servings[arch]["phase_peak_mem_gb"])
        free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    launched = phase_launchers()
    peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    free_device_memory()
    ssm_training = {}
    ssm_mesh_train = {}
    for arch in SSM_TRAIN:
        ssm_training[arch] = phase_training(arch, SSM_TRAIN_LAYERS.get(arch, 0),
                                            SSM_CHECK_LAYERS[arch], "(i)",
                                            bf16_grad_tol=BF16_GRAD_TOL)
        peaks.append(ssm_training[arch]["phase_peak_mem_gb"])
        free_device_memory()
        ssm_mesh_train[arch] = phase_ssm_mesh_train(arch, mesh)
        peaks.append(ssm_mesh_train[arch]["peak_mem_gb"])
        free_device_memory()
    f2_training = {}
    for arch in F2_ARCHS:
        f2_training[arch] = phase_f2(arch)
        peaks.append(f2_training[arch]["phase_peak_mem_gb"])
        free_device_memory()
    counted = [servings[a]["counts"] for a in ("codeqwen1.5-7b", "zamba2-7b", "rwkv6-1.6b")] \
        + [training["counts"]] + [t["counts"] for t in ssm_training.values()] \
        + [t["counts"] for t in f2_training.values()]
    dispatch = dispatch_overhead()
    cells = dryrun_cells()
    paths = {**{a: s["launches"] for a, s in servings.items()},
             **{c["call"]: c["launches"] for c in counted},
             f"{TRAIN_ARCH}-train": training["launches"],
             f"{TRAIN_ARCH}-trainer": trainer["launches"],
             f"{TRAIN_ARCH}-mesh-train": mesh_train["launches"],
             f"{TRAIN_ARCH}-mesh-train-fsdp": mesh_train["runs"]["fsdp"]["launches"],
             f"{MOE_ARCH}-ep-prefill": servings[MOE_ARCH]["ep_prefill"]["launches"],
             **{f"{a}-{name}": run["launches"] for a in PLACED_STEPS for name, run in
                servings[a]["placed"]["runs"].items() if name != "mesh_free"},
             **{f"{a}-train": t["launches"] for a, t in ssm_training.items()},
             **{f"{a}-train": t["launches"] for a, t in f2_training.items()},
             **{f"{a}-mesh-train": t["launches"] for a, t in ssm_mesh_train.items()},
             **{f"{a}-reduced-launch.train": r["train_launches"] for a, r in launched.items()},
             **{f"{a}-reduced-launch.serve": r["serve_launches"] for a, r in launched.items()}}

    def by_path(kernel):
        return {a: n[kernel] for a, n in paths.items() if n.get(kernel, 0)}

    kernels = [
        kernel_line("flash_attention_fwd", "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:70", flash["main"],
                    by_path("flash_attention_fwd"), dtype=flash["main"]["dtype"],
                    library="torch.nn.functional.scaled_dot_product_attention(is_causal=True)",
                    hd112=flash["hd112"], hd224=published["flash_hd224"],
                    train_hd64=flash["train_hd64"],
                    mixtral_window=flash["mixtral_window"],
                    other_cases=flash["others"], sass_HGMMA=tensor_cores["counts"]["fwd_bf16_HGMMA"],
                    kernels_by_dtype=tensor_cores["kernels"]["flash_attention"]),
        kernel_line("flash_attention_bwd",
                    "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                    "src/repro/kernels/ref.py:105", flash_bwd["main"],
                    by_path("flash_attention_bwd"),
                    replaces_note="no Pallas kernel: the reference differentiates through "
                                  "the custom VJP's plain _flash_bwd_impl",
                    dtype=flash_bwd["main"]["dtype"],
                    library="backward of torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True), device time (torch.profiler)",
                    library_eager_ms=flash_bwd["main"]["library_eager_ms"],
                    other_cases=flash_bwd["others"],
                    sass_HMMA_HGMMA=tensor_cores["counts"]["bwd_bf16_HMMA_HGMMA"],
                    kernels_by_dtype=tensor_cores["kernels"]["flash_attention_bwd"]),
        kernel_line("checksum", "src/repro_torch/kernels/csrc/checksum.cu",
                    "src/repro/kernels/checksum.py:32", checksum["main"], by_path("checksum"),
                    dtype="uint32 words", int_ops=checksum["main"]["int_ops"], library=None,
                    other_cases=checksum["others"]),
        kernel_line("wkv6_fwd", "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                    "src/repro/kernels/rwkv6_scan.py:68", wkv6["main"], by_path("wkv6_fwd"),
                    dtype="float32 (3xTF32 on the tensor cores)", exps=wkv6["main"]["exps"],
                    library=None, max_rel_err=wkv6["main"]["max_rel_err"],
                    **_scan_extra(wkv6["main"], tensor_cores, "rwkv6_scan"),
                    other_cases=wkv6["others"], reduced_sizes=reduced["wkv6_fwd"]),
        kernel_line("ssd_fwd", "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                    "src/repro/kernels/mamba2_ssd.py:65", ssd["main"], by_path("ssd_fwd"),
                    dtype="float32 (3xTF32 on the tensor cores)", exps=ssd["main"]["exps"],
                    library=None, max_rel_err=ssd["main"]["max_rel_err"],
                    **_scan_extra(ssd["main"], tensor_cores, "mamba2_ssd"),
                    other_cases=ssd["others"], reduced_sizes=reduced["ssd_fwd"],
                    groups2=published["ssd_groups2"]),
        kernel_line("wkv6_bwd", "src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
                    "src/repro/kernels/ref.py:285", wkv6_bwd_cases["main"], by_path("wkv6_bwd"),
                    replaces_note="no Pallas kernel: the reference differentiates "
                                  "ref.rwkv6_chunked (ref.py:285-345) by JAX's autodiff",
                    dtype="float32 (3xTF32 on the tensor cores)",
                    exps=wkv6_bwd_cases["main"]["exps"], library=None,
                    max_rel_err=wkv6_bwd_cases["main"]["max_rel_err"],
                    **_scan_extra(wkv6_bwd_cases["main"], tensor_cores, "rwkv6_scan_bwd"),
                    **_bwd_extra(wkv6_bwd_cases["main"]),
                    other_cases=wkv6_bwd_cases["others"], reduced_sizes=reduced["wkv6_bwd"]),
        kernel_line("ssd_bwd", "src/repro_torch/kernels/csrc/mamba2_ssd_bwd.cu",
                    "src/repro/kernels/ref.py:366", ssd_bwd_cases["main"], by_path("ssd_bwd"),
                    replaces_note="no Pallas kernel: the reference differentiates "
                                  "ref.mamba2_ssd (ref.py:366-420) by JAX's autodiff",
                    dtype="float32 (3xTF32 on the tensor cores)",
                    exps=ssd_bwd_cases["main"]["exps"], library=None,
                    max_rel_err=ssd_bwd_cases["main"]["max_rel_err"],
                    **_scan_extra(ssd_bwd_cases["main"], tensor_cores, "mamba2_ssd_bwd"),
                    **_bwd_extra(ssd_bwd_cases["main"]),
                    other_cases=ssd_bwd_cases["others"], reduced_sizes=reduced["ssd_bwd"]),
        kernel_line("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "src/repro/models/layers.py:205", decode["main"], by_path("decode_attention"),
                    replaces_note="no TPU kernel: the reference's decode attention is plain jnp "
                                  "einsums",
                    dtype=decode["main"]["dtype"],
                    library="torch.nn.functional.scaled_dot_product_attention over the valid "
                            "slots, laid out [B, KV, n_valid, hd] beforehand",
                    other_cases=decode["others"], hd224=published["decode_hd224"]),
        kernel_line("mamba2_step", "src/repro_torch/kernels/csrc/mamba2_step.cu",
                    "src/repro/kernels/ref.py:348", published["mamba2_step"],
                    by_path("mamba2_step"),
                    replaces_note="no TPU kernel: the reference's Mamba2 decode step is "
                                  "ref.mamba2_naive in jnp",
                    dtype=published["mamba2_step"]["dtype"], library=None),
    ]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on any main path")
    print(json.dumps({"kernels": kernels, "device": name, "nvidia_smi": smi,
                      "build_s": build_s, "script_peak_mem_gb": max(peaks),
                      "script_s": time.perf_counter() - t_start}))
    for serving in servings.values():
        print(json.dumps({"serving": serving, "device": name, "nvidia_smi": smi}))
    print(json.dumps({"training": training, "device": name, "nvidia_smi": smi}))
    print(json.dumps({"trainer": trainer, "device": name, "nvidia_smi": smi}))
    for t in (*ssm_training.values(), *f2_training.values()):
        print(json.dumps({"training": t, "device": name, "nvidia_smi": smi}))
    print(json.dumps({"roofline": {"targets": roofline.TARGETS, "calls": counted,
                                   "dryrun": cells, "operator_dispatch": dispatch},
                      "device": name, "nvidia_smi": smi}))
    print(json.dumps({"parallel": {"mesh_train": mesh_train, "ssm_mesh_train": ssm_mesh_train,
                                   "placed_serving": {a: servings[a]["placed"]
                                                      for a in PLACED_STEPS},
                                   "ep_prefill": servings[MOE_ARCH]["ep_prefill"],
                                   "compression": training["compression"]},
                      "device": name, "nvidia_smi": smi}))
    print(json.dumps({"storage_baseline": baseline, "device": name, "nvidia_smi": smi}))
    print(json.dumps({"launchers": launched, "device": name, "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
