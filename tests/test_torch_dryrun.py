"""The port's dry run and roofline (``repro_torch.launch.{dryrun,roofline}``)
against the JAX package's, on the CPU.

* ``input_specs`` and ``kv_dtype_for_cell`` against JAX's for all 33 cells,
  ``model_flops_per_device`` for every cell at 256 and 512 devices, and
  ``_wire_bytes`` for every kind and group size: equal, exactly (the same
  integer and float arithmetic in the same order).
* A reduced cell's train step, prefill and decode (dense, moe, ssm, hybrid)
  counted on fake tensors equals the same call counted on real CPU tensors,
  exactly: flops, bytes and collectives read only shapes and dtypes.  Copies
  (``copy_bytes``) are not compared: whether ``contiguous`` copies depends on
  strides, which a fake tensor takes from the meta functions (the plain
  zamba2 step's ``softplus_backward`` of two operands laid out differently
  gives another layout on fake tensors, and one copy fewer follows).
* The dot flops of a reduced dense prefill against
  ``repro.launch.roofline.fold_totals`` of JAX's compiled HLO of the same
  prefill, on one CPU device.  The port's plain path (its CPU route, the same
  blocked attention as JAX's ``ref.flash_attention``) is held within 1%; it
  agrees exactly.  The kernel route that the dry run counts differs by one
  term, held exactly: the flash kernel's operator counts 4·hd flops per
  (query, key) pair the causal mask lets through (``work.flash_fwd_work``),
  where the blocked product computes every pair of its blocks, masked or not
  (here T = 64 < the 512-row block: all T² pairs).
* Each kernel operator's fake implementation gives the wrapper's outputs
  (shapes, dtypes, strides), and a fake lowering on fake CUDA tensors, where
  ``ops`` routes to the operators, launches nothing: every ``.launches``
  counter stays at 0.
* A reduced dense train step with FSDP forced, lowered on a fake world of 8
  ranks: its all-gather and reduce-scatter payloads against the specs,
  exactly, and the peak of live gathered parameters against one layer's.
* A reduced placed prefill and decode (``serve.server.placed_prefill``/
  ``placed_decode``) lowered on a fake world of 256 ranks: a rank's dot
  flops against the same call's on whole tensors (a dense arch, rwkv6 and
  zamba2, each split over both axes: under 1/64), and its cache's bytes
  against the specs' share.
* Full-width cells through the CLI in a subprocess: a train step and a
  decode step.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import all_cells as jax_all_cells
from repro.configs import get_arch as jax_get_arch
from repro.configs import get_shape as jax_get_shape
from repro.launch import roofline as jax_roofline
from repro.models import get_model as jax_model
from repro.models import input_specs as jax_input_specs
from repro.models import kv_dtype_for_cell as jax_kv_dtype_for_cell
from repro_torch import interop
from repro_torch.configs import all_cells, get_arch, get_shape
from repro_torch.kernels import flash_attention, mamba2_ssd, ops, rwkv6_scan, work
from repro_torch.kernels import checksum as checksum_mod
from repro_torch.launch import dryrun, roofline
from repro_torch.models import get_model, input_specs, kv_dtype_for_cell
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
CELLS = all_cells()
WRAPPERS = (flash_attention.flash_attention_fwd, flash_attention.flash_attention_bwd,
            rwkv6_scan.wkv6_fwd, rwkv6_scan.wkv6_bwd, mamba2_ssd.ssd_fwd, mamba2_ssd.ssd_bwd,
            checksum_mod.checksum)


def test_the_grid_is_the_reference_grid():
    assert CELLS == jax_all_cells() and len(CELLS) == 33


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_kv_dtype_match_jax(arch, shape):
    cfg, sh = get_arch(arch), get_shape(shape)
    jcfg, jsh = jax_get_arch(arch), jax_get_shape(shape)
    for mode in (None, "train", "prefill", "decode"):
        mine = {k: (tuple(s), str(dt).split(".")[-1])
                for k, (s, dt) in input_specs(cfg, sh, mode).items()}
        ref = {k: (tuple(x.shape), str(x.dtype)) for k, x in
               jax_input_specs(jcfg, jsh, mode).items()}
        assert mine == ref, mode
    assert kv_dtype_for_cell(cfg, shape) == jax_kv_dtype_for_cell(jcfg, shape)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_per_device_matches_jax(arch, shape):
    for n in (256, 512):
        assert roofline.model_flops_per_device(get_arch(arch), get_shape(shape), n) == \
            jax_roofline.model_flops_per_device(jax_get_arch(arch), jax_get_shape(shape), n)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                  "collective-permute", "broadcast"])
def test_wire_bytes_matches_jax(kind):
    for g in (1, 2, 8, 16, 32):
        for payload in (0.0, 1.0, 12345.0, 3.5e9):
            assert roofline._wire_bytes(kind, payload, g) == \
                jax_roofline._wire_bytes(kind, payload, g)


def test_roofline_terms_take_the_h100_peaks():
    t = roofline.roofline_terms({
        "dot_flops": 989e12 + 494.7e12, "dot_flops_by_peak": {"bf16": 989e12, "tf32": 494.7e12},
        "traffic_bytes": 3.35e12, "wire_bytes": 450e9 + 50e9,
        "wire_bytes_in_node": 450e9, "wire_bytes_across_nodes": 50e9})
    assert t["compute_s"] == pytest.approx(2.0, rel=1e-12)
    assert t["memory_s"] == pytest.approx(1.0, rel=1e-12)
    assert t["collective_s"] == pytest.approx(2.0, rel=1e-12)
    assert t["dominant"] in ("compute", "collective") and t["bound_s"] == pytest.approx(2.0)
    assert t["targets"] == "H100 SXM 80GB, 700 W, published peaks"


def test_roofline_terms_refuse_an_unknown_rate():
    with pytest.raises(ValueError, match="int32"):
        roofline.roofline_terms({"dot_flops": 1.0, "dot_flops_by_peak": {"int32": 1.0},
                                 "traffic_bytes": 0.0, "wire_bytes": 0.0})


# ------------------------------------------------------ fake count == real count

FAMILIES = {"dense": "minicpm-2b", "moe": "mixtral-8x22b", "ssm": "rwkv6-1.6b",
            "hybrid": "zamba2-7b"}
B, T = 2, 40


def _call(kind, cfg, params, tokens):
    """The call of a cell of ``kind`` (no mesh), and what it holds before it."""
    api = get_model(cfg)
    if kind == "train":
        oc = opt.opt_config_for(cfg, warmup_steps=2, total_steps=4)
        state = opt.init_opt_state(oc, params)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        step = make_train_step(cfg, oc)
        return (lambda: step(params, state, batch),
                [(params, "params"), ((state.step, state.mu, state.nu, state.master),
                                      "opt_state"), (batch, "other")])
    if kind == "prefill":
        return (lambda: api.prefill(params, tokens, T + 8),
                [(params, "params"), (tokens, "other")])
    cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in api.cache_spec(B, T + 8).items()}
    return (lambda: api.decode(params, tokens[:, :1], cache, T),
            [(params, "params"), (cache, "other")])


def _counted(kind, cfg, params, tokens):
    fn, held = _call(kind, cfg, params, tokens)
    count = roofline.Count("cpu")
    for tree, category in held:
        count.track(tree, category)
    with torch.set_grad_enabled(kind == "train"), count:
        fn()
    return count


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fake_count_equals_real_count(family, kind):
    cfg = get_arch(FAMILIES[family]).reduced()
    params = get_model(cfg).init(0, torch.float32, "cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, T)).astype(np.int32))
    real = _counted(kind, cfg, params, tokens)
    with FakeTensorMode():
        fake = _counted(kind, cfg, dryrun.fake_twin(params, "cpu"),
                        dryrun.fake_twin(tokens, "cpu"))
    assert real.totals()["dot_flops"] > 0 and real.traffic_bytes > 0
    work_of = lambda c: {k: v for k, v in c.totals().items() if k != "copy_bytes"}  # noqa: E731
    assert work_of(fake) == work_of(real)
    assert not real.kernel_calls and not fake.kernel_calls       # the CPU route: plain
    # the dry run's memory column: the peak of live bytes, by category, exactly
    assert real.memory()["peak_bytes"] > 0 and fake.memory() == real.memory()


def test_dense_prefill_dot_flops_against_jax_hlo():
    name, t = "minicpm-2b", 64
    cfg, jcfg = get_arch(name).reduced(), jax_get_arch(name).reduced()
    japi = jax_model(jcfg)
    jp = japi.init(jax.random.PRNGKey(0), jnp.float32)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, t)).astype(np.int32)
    hlo = jax.jit(lambda p, x: japi.prefill(p, x, t, "bfloat16")).lower(jp, toks).compile()
    want = jax_roofline.fold_totals(hlo.as_text())["dot_flops"]

    api, params = get_model(cfg), interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    plain = roofline.Count("cpu")
    with torch.no_grad(), plain:
        api.prefill(params, torch.from_numpy(toks), t)
    assert abs(plain.totals()["dot_flops"] - want) <= 0.01 * want

    with FakeTensorMode(), ops.kernel_path():
        kernel = roofline.Count("cpu")
        with torch.no_grad(), kernel:
            api.prefill(dryrun.fake_twin(params, "cpu"), torch.empty(B, t, dtype=torch.int32), t)
    assert dict(kernel.kernel_calls) == {"flash_attention_fwd": cfg.n_layers}
    g = cfg.n_heads // cfg.n_kv_heads
    pairs = work.visible_pairs(t, t, 0, 0)
    per_layer = 4 * cfg.hd * B * cfg.n_kv_heads * g
    assert kernel.totals()["dot_flops"] - per_layer * pairs * cfg.n_layers == \
        plain.totals()["dot_flops"] - per_layer * t * t * cfg.n_layers


# ------------------------------------------------------ the kernels' operators

def _fake_cuda(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="cuda")


def _op_cases():
    """(operator, fake CUDA arguments, the wrapper's output spec: (shape, dtype) each)."""
    b, t, kv, g, hd, h, d = 2, 100, 2, 3, 64, 4, 64
    q, k = _fake_cuda((b, t, kv, g, hd), torch.bfloat16), _fake_cuda((b, t, kv, hd), torch.bfloat16)
    lse = _fake_cuda((b, kv, g, t))
    r, st, u = _fake_cuda((b, t, h, d)), _fake_cuda((b, h, d, d)), _fake_cuda((h, d))
    sts = _fake_cuda((b, 2, h, d, d))
    x, dt, A, Bm = (_fake_cuda((b, t, h, d)), _fake_cuda((b, t, h)), _fake_cuda((h,)),
                    _fake_cuda((b, t, d)))
    xs = _fake_cuda((b, 2, h, d, d))
    o = torch.ops.repro_torch
    f32, bf = torch.float32, torch.bfloat16
    return [
        (o.flash_attention_fwd, (q, k, k, 0, 0), [(q.shape, bf), ((b, kv, g, t), f32)]),
        (o.flash_attention_bwd, (q, k, k, q, lse, q, 0, 0),
         [(q.shape, bf), (k.shape, bf), (k.shape, bf)]),
        (o.wkv6_fwd, (r, r, r, r, u, st, 64, True),
         [(r.shape, f32), (st.shape, f32), ((b, 2, h, d, d), f32)]),
        (o.wkv6_fwd, (r, r, r, r, u, st, 64, False), [(r.shape, f32), (st.shape, f32)]),
        (o.wkv6_bwd, (r, r, r, r, u, sts, r, None, 64),
         [(r.shape, f32)] * 4 + [(u.shape, f32), (st.shape, f32)]),
        (o.ssd_fwd, (x, dt, A, Bm, Bm, st, 128, True),
         [(x.shape, f32), (st.shape, f32), ((b, 2, h, d, d), f32)]),
        (o.ssd_fwd, (x, dt, A, Bm, Bm, st, 128, False), [(x.shape, f32), (st.shape, f32)]),
        (o.ssd_bwd, (x, dt, A, Bm, Bm, xs, x, st, 128),
         [(x.shape, f32), (dt.shape, f32), (A.shape, f32), (Bm.shape, f32), (Bm.shape, f32),
          (st.shape, f32)]),
        (o.checksum, (_fake_cuda((1000,), torch.int32), 4096), [((2,), torch.int64)]),
    ]


def test_kernel_operators_fake_outputs_are_the_wrappers_outputs():
    for w in WRAPPERS:
        w.launches = 0
    with FakeTensorMode():
        cases = _op_cases()
        for op, args, spec in cases:
            out = op(*args)
            outs = [out] if isinstance(out, torch.Tensor) else list(out)
            assert [(tuple(x.shape), x.dtype) for x in outs] == \
                [(tuple(s), dt) for s, dt in spec], op
            assert all(x.is_contiguous() and x.device.type == "cuda" for x in outs), op
            assert op in work.KERNEL_OPS
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


def test_ops_on_fake_cuda_tensors_take_the_operators_and_launch_nothing():
    """``ops`` routes a (fake) CUDA tensor to the kernels' operators; their fake
    implementations run, and no wrapper launches."""
    from repro_torch.kernels import ops
    for w in WRAPPERS:
        w.launches = 0
    count = roofline.Count("cuda")
    with FakeTensorMode(), count:
        q, k = _fake_cuda((B, T, 2, 2, 64), torch.bfloat16), _fake_cuda((B, T, 2, 64), torch.bfloat16)
        out = ops.flash_attention(q, k, k, window=16)
        r, st, u = _fake_cuda((B, T, 4, 64)), _fake_cuda((B, 4, 64, 64)), _fake_cuda((4, 64))
        y, s_out = ops.wkv6(r, r, r, r, u, st)
        dt, A, Bm = _fake_cuda((B, T, 4)), _fake_cuda((4,)), _fake_cuda((B, T, 64))
        y2, _ = ops.mamba2_ssd(r, dt, A, Bm, Bm, st)
        digest = ops.tensor_checksum(_fake_cuda((100,), torch.int32))
    assert out.shape == q.shape and y.shape == r.shape and y2.shape == r.shape
    assert s_out.shape == st.shape and digest.shape == (2,)
    assert dict(count.kernel_calls) == {"flash_attention_fwd": 1, "wkv6_fwd": 1, "ssd_fwd": 1,
                                        "checksum": 1}
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_kernel_route_lowering_launches_nothing(family, kind):
    """The dry run's lowering: fake CPU tensors with ``ops`` routed to the kernels'
    autograd functions (``ops.kernel_path``).  A fake CUDA tensor cannot carry an
    autograd graph where torch has no CUDA, and a model's factory calls on its
    device fail there, so the card's path is lowered on fake CPU tensors: every
    kernel is counted as its operator, once a layer forward (twice in a train
    step, with the remat recompute) and once backward, and nothing launches."""
    cfg = get_arch(FAMILIES[family]).reduced()
    for w in WRAPPERS:
        w.launches = 0
    with FakeTensorMode(), ops.kernel_path():
        params = get_model(cfg).init(0, torch.float32, "cpu")
        tokens = torch.empty(B, T, dtype=torch.int32)
        count = _counted(kind, cfg, params, tokens)
    sites = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    per = {"dense": {"flash_attention": cfg.n_layers}, "ssm": {"wkv6": cfg.n_layers},
           "hybrid": {"ssd": cfg.n_layers, "flash_attention": sites}}[family]
    want = {}
    for name, n in per.items():
        want[f"{name}_fwd"] = 2 * n if kind == "train" else n
        if kind == "train":
            want[f"{name}_bwd"] = n
    assert dict(count.kernel_calls) == want
    assert [w.launches for w in WRAPPERS] == [0] * len(WRAPPERS)


# ------------------------------------------------------ placed train step

def test_fsdp_train_step_gathers_each_layer_and_reduce_scatters_its_gradients():
    """One train step of reduced codeqwen1.5-7b (4 heads, 4 kv heads: no head
    padding, so no weight is gathered over "model") with FSDP forced, lowered
    on a fake world of 8 ranks as a (2, 4) ("data", "model") mesh and counted
    on rank 0.  From the specs, in bytes of rank 0's blocks:
      * all-gather payload = 2 x each layer's blocks split over "data",
        gathered (the forward and the recompute), + ``emb/tok`` and
        ``emb/out`` gathered once each (the lookup and the head are not
        checkpointed) + the ZeRO-1 re-gather of every param replicated over
        "data" (its own block);
      * reduce-scatter payload = the sum of the gradient blocks (each leaf's
        ZeRO-1 block: an FSDP leaf's own block, reduce-scattered by its
        gather's backward; the rest after the backward);
      * the peak of live gathered bytes is one layer's."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import spmd
    cfg = get_arch("codeqwen1.5-7b").reduced()
    api = get_model(cfg)
    oc = opt.opt_config_for(cfg)
    dryrun.join_fake_world(8)
    prev = shd.needs_fsdp
    try:
        mesh = make_host_mesh(2, 4, device_type="cpu")
        with FakeTensorMode():
            whole = api.init(0, torch.float32, "cpu")
            shd.needs_fsdp = lambda c: True
            p_specs = dict(opt.flatten_with_paths(shd.param_shardings(cfg, whole, mesh)))
            params = shd.distribute_tree(whole, shd.param_shardings(cfg, whole, mesh), mesh)
            state = opt.init_opt_state(oc, params, shd.opt_shardings(cfg, whole, mesh))
            shd.needs_fsdp = prev
            tokens = torch.zeros((8, T), dtype=torch.int32)
            batch = shd.distribute_tree({"tokens": tokens, "labels": tokens},
                                        {"tokens": ("data", None), "labels": ("data", None)},
                                        mesh)
            count = roofline.Count("cpu")
            count.track(params, "params")
            count.track((state.step, state.mu, state.nu, state.master), "opt_state")
            spmd.GATHERS.clear()
            with count:
                make_train_step(cfg, oc)(params, state, batch)
    finally:
        shd.needs_fsdp = prev
        dist.destroy_process_group()

    sizes = {"data": 2, "model": 4}

    def nbytes(shape, spec):
        n = 4                               # fp32
        for d, e in zip(shape, list(spec) + [None] * len(shape)):
            n *= d // (sizes[e] if e else 1)
        return n
    gathered = recompute = regather = blocks = 0
    per_layer = 0
    for path, x in opt.flatten_with_paths(whole):
        shape, spec = tuple(x.shape), p_specs[path]
        local = nbytes(shape, spec)
        zero1 = nbytes(shape, shd.zero1_pspec(spec, shape, mesh))
        blocks += zero1
        if "data" not in spec:
            regather += local
        elif path[0] == "layers":
            recompute += 2 * local * 2          # gathered (x dp), forward and recompute
            per_layer += local * 2 // cfg.n_layers
        else:
            gathered += local * 2
    got = count.collectives()[0]
    assert recompute and gathered and regather
    assert got["all-gather"] == recompute + gathered + regather
    assert got["reduce-scatter"] == blocks
    assert dict(spmd.GATHERS) == {"gather": 2 * cfg.n_layers + 2,
                                  "reduce_scatter": cfg.n_layers + 2}
    assert 0 < count.memory()["peak_of_category"]["gathered"] <= per_layer


# ------------------------------------------------------ placed serving

@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b", "codeqwen1.5-7b"])
def test_placed_serving_lowering_on_256_ranks(arch):
    """A reduced prefill (B=16, T=64) and decode step, placed on a fake world
    of 256 ranks as a (16, 16) ("data", "model") mesh and counted on rank 0,
    against the same calls on whole tensors.  Each arch's heads divide the
    16 "model" ranks, one a rank: the dense arch's 16 heads and KV heads
    (the cache split by its heads), rwkv6's 16 of head size 64 at d 1,024
    (wide enough that the low-rank time-mix weights every rank runs whole
    are a few percent of a layer) and zamba2's 16 Mamba2 heads and 16
    shared-block heads, at 12 layers.  Each splits its rows over "data" and
    its heads, channels and hidden dims over "model": under 1/64 of the
    whole call's flops.  The cache a rank holds, by the dry run's ``cache``
    category at decode and by the blocks prefill returns: the whole cache
    over 256 (rows and heads or channels)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.server import cache_specs, placed_decode, placed_prefill
    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, **{
        "dense": {"n_heads": 16, "n_kv_heads": 16},
        "ssm": {"n_layers": 12, "d_model": 1024, "ssm_head_dim": 64},
        "hybrid": {"n_layers": 12, "ssm_head_dim": 16, "n_heads": 16, "n_kv_heads": 16},
    }[cfg.family])
    api = get_model(cfg)
    b, t, smax = 16, 64, 72

    def counted(fn, tracked=()):
        count = roofline.Count("cpu")
        for tree, category in tracked:
            count.track(tree, category)
        with torch.no_grad(), count:
            out = fn()
        return count, out

    def nbytes(tree):
        return sum(x.nbytes for x in tree.values())

    dryrun.join_fake_world(256)
    try:
        mesh = make_host_mesh(16, 16, device_type="cpu")
        with FakeTensorMode(), ops.kernel_path():
            whole = api.init(0, torch.float32, "cpu")
            toks = torch.zeros((b, t), dtype=torch.int32)
            spec = api.cache_spec(b, smax)
            cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in spec.items()}
            c_whole = {"prefill": counted(lambda: api.prefill(whole, toks, smax)),
                       "decode": counted(lambda: api.decode(whole, toks[:, :1], cache, t))}
            params = shd.distribute_tree(whole, shd.param_shardings(cfg, whole, mesh), mesh)
            placed_cache = shd.distribute_tree(
                cache, cache_specs(cfg, {k: s for k, (s, _) in spec.items()}, mesh), mesh)
            c_placed = {
                "prefill": counted(lambda: placed_prefill(
                    cfg, params, shd.distribute(toks, ("data", None), mesh), smax,
                    "bfloat16", mesh)),
                "decode": counted(lambda: placed_decode(
                    cfg, params, shd.distribute(toks[:, :1], ("data", None), mesh),
                    placed_cache, t, mesh), [(placed_cache, "cache")])}
            prefill_cache = c_whole["prefill"][1][1]
            placed_prefill_cache = {k: x.to_local() for k, x in c_placed["prefill"][1][1].items()}
    finally:
        dist.destroy_process_group()
    ratios = {kind: c_placed[kind][0].totals()["dot_flops"] / c_whole[kind][0].totals()["dot_flops"]
              for kind in ("prefill", "decode")}
    for kind, ratio in ratios.items():
        assert 1 / 512 < ratio < 1 / 64, (kind, ratios)
    assert c_placed["decode"][0].memory()["peak_of_category"]["cache"] == nbytes(cache) // 256
    assert nbytes(placed_prefill_cache) == nbytes(prefill_cache) // 256


# ------------------------------------------------------ the CLI

def test_dryrun_cli_full_width_cell(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "minicpm-2b",
           "--shape", "train_4k", "--mesh", "single", "--out", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads((tmp_path / "minicpm-2b__train_4k__pod16x16.json").read_text())
    for key in ("ok", "lower_s", "total_s", "memory", "cost", "collective_bytes",
                "collective_count", "totals", "roofline", "model_flops_per_device",
                "flops_over_model_flops", "placement"):
        assert key in rec, key
    assert rec["ok"] and rec["world"] == 256
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["kernel_calls"] == {"flash_attention_fwd": 80, "flash_attention_bwd": 40}
    # the step gathers the attention's weights over "model" (36 heads padded to 48)
    # and all-reduces the TP layers' partial outputs; no leaf is split over "data"
    assert rec["collective_count"]["all-gather"] > 0 and rec["collective_count"]["all-reduce"] > 0
    assert rec["param_gathers"] == {"gather": 82, "reduce_scatter": 42}
    assert rec["memory"]["fits_80gb"]
    assert rec["memory"]["fits_80gb"] is (rec["memory"]["peak_bytes"] <= 80e9)
    assert rec["roofline"]["bound_s"] > 0 and rec["flops_over_model_flops"] > 1


def test_dryrun_cli_full_width_decode_cell(tmp_path):
    """qwen1.5-32b's decode_32k cell (int8 cache; 40 KV heads do not divide
    "model" 16, so the cache is split by its sequence): placed as the
    reference places it, it fits one card."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-32b",
           "--shape", "decode_32k", "--mesh", "single", "--out", str(tmp_path)]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads((tmp_path / "qwen1.5-32b__decode_32k__pod16x16.json").read_text())
    assert rec["ok"] and rec["world"] == 256 and rec["kv_dtype"] == "int8"
    assert rec["placement"] == dryrun.PLACEMENT["decode"]
    assert "sequence" in rec["placement"]["cache"] and "logits_sharding" in rec["placement"]["logits"]
    # the int8 cache, 64 x 128 x 32768 x 40 x 128 bytes for k and v with their bf16
    # scales, over 16 "data" x 16 "model" ranks
    cache = 2 * 64 * 128 * 32768 * 40 * (128 + 2)
    assert rec["memory"]["peak_of_category"]["cache"] == cache // 256
    assert rec["memory"]["fits_80gb"] and rec["memory"]["peak_bytes"] <= 80e9
    # a rank's flops: its 8 rows, and each layer's MLP and wo over "model"
    assert rec["flops_over_model_flops"] < 10
    assert rec["kernel_calls"] == {}
