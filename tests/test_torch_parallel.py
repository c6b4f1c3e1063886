"""The port's mesh paths against its mesh-free paths, on 8 gloo ranks.

As ``tests/test_sharding_multidev.py`` holds the reference's distribution
machinery to its mesh-free paths on 8 fake devices, this holds the port's
on a (2, 4) ("data", "model") mesh of 8 CPU processes joined by gloo
through a rendezvous file:

  * the MoE block's expert-parallel path (E=4 over model 4) and its
    TP-in-expert path (E=3), and arctic's dense residual folded into the
    same all-reduce, against the local dispatch: in the reference's no-drop
    case (capacity factor 4), and at the default 1.25, where tokens drop,
    against the local path routed in groups=dp groups (the mesh path's);
  * TP head padding (H=6 over model 4: 8 padded heads) and the GQA-uneven
    k/v expansion (H=6, KV=2) against the mesh-free loss;
  * two sharded train steps against two mesh-free ones, and each rank's
    local shapes of params and moments against the rules' shares: as the
    rules place the params, with FSDP forced (``sharding.needs_fsdp``
    patched), and for arctic's layout (4 experts over model 4, FSDP
    forced); one mesh step of reduced rwkv6 and zamba2, their blocks split
    over "model" (no layer gathered whole over it: ``spmd.MODEL_GATHERS``),
    and of each with heads that do not divide the axis (the block whole on
    every rank); the spans (``repro_torch.obs``) of one sharded step
    against those of a mesh-free one;
  * the vocab-parallel embedding, head and cross-entropy (tied and untied)
    against the mesh-free ones, the max term's gradient included;
  * prefill under the mesh caching the model's KV heads, not the padded
    ones; DTensor layouts; the kernel wrappers refusing a DTensor.

The ranks are spawned once for the module (``torch_gloo_ranks``), run
every case and write one result a case; each case reports as its own
test.  The spawn has a time limit of its own, and so has every collective
(the process group's timeout).  Values are fp32 on both sides and differ
only in the order of summation: 1e-5 (the train-step cases' AdamW eps:
``STEP_EPS``).  The placed serving paths have their own module and spawn
(``tests/test_torch_serve_mesh.py``).
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_gloo_ranks import ROOT, cases_of, fsdp_forced, moe_groups, rank_main, spawn_ranks

from repro_torch.parallel import sharding as shd  # noqa: E402

WORLD, MESH = 8, (2, 4)
SPAWN_TIMEOUT_S = 300        # all ranks, every case
PG_TIMEOUT_S = 60            # each collective
TOL = 1e-5
# AdamW's eps in the train-step cases.  At its default 1e-8 the first step
# moves a param by lr * g / (|g| + eps): a gradient element near eps (here
# |g| ~ 2e-8) turns the fp32 rounding of its sums into a param difference of
# about TOL.  Summing the vocabulary in another order alone (a permutation
# of it, in the mesh-free step) moves the params by 0.69-1.00 of TOL; at
# 1e-6 the same rounding stays two orders below it.
STEP_EPS = 1e-6


# ------------------------------------------------------------------ the cases (in a rank)

def _moe_inputs(arch, seed, **kw):
    """An MoE block's weights and x [4, 16, d]; the tokens share a direction,
    so that the router favours some experts and, below capacity factor
    E / k, tokens drop."""
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_arch(arch).reduced(), top_k=2, **kw)
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe_block(cfg, gen, torch.float32)
    x = torch.randn((4, 16, cfg.d_model), generator=gen)
    return cfg, p, x + torch.randn(cfg.d_model, generator=gen)


def _close(got, want, what=""):
    err = float((got - want).abs().max())
    assert err <= TOL * (1 + float(want.abs().max())), f"{what}: max |diff| {err}"
    return err


def _drops(cfg, p, x, groups):
    from repro_torch.models import moe
    n = x.shape[0] * x.shape[1]
    g = moe.n_groups(n, groups)
    capacity = int(n // g * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    keep = moe._route(cfg, p["router"], x.reshape(g, n // g, -1), capacity)[2]
    return int((~keep).sum())


def _moe_case(mesh, arch, n_experts, capacity_factor, seed, mlp=False):
    """moe_block under the mesh against the local dispatch: at capacity factor
    4 (no drops) with the default groups, else with groups = dp, the mesh
    path's own groups."""
    from repro_torch.models import layers, moe
    from repro_torch.parallel import ctx
    cfg, p, x = _moe_inputs(arch, seed, n_experts=n_experts,
                            capacity_factor=capacity_factor)
    m = (layers.init_mlp(cfg.d_model, cfg.d_ff, torch.Generator().manual_seed(seed + 7),
                         torch.float32) if mlp else None)
    dp = MESH[0]
    no_drop = capacity_factor >= n_experts / cfg.top_k
    want = moe.moe_block(cfg, p, x, mlp=m) if no_drop else moe.moe_block(cfg, p, x, groups=dp,
                                                                          mlp=m)
    with ctx.mesh_context(mesh):
        got = moe.moe_block(cfg, p, x, mlp=m)
    res = {"err": _close(got, want, "mesh vs local"), "drops_groups_dp": _drops(cfg, p, x, dp)}
    if not no_drop:
        # the local path's default 16 groups make other capacities, so other
        # tokens drop and the output moves: the mesh path matches only groups = dp
        res["drops_groups_16"] = _drops(cfg, p, x, 16)
        res["err_vs_groups_16"] = float((got - moe.moe_block(cfg, p, x, mlp=m)).abs().max())
        assert res["drops_groups_dp"] > 0 and res["err_vs_groups_16"] > 1e-2, res
    return res


def case_moe_ep_no_drop(mesh):
    return _moe_case(mesh, "arctic-480b", 4, 4.0, 0)


def case_moe_ep_drops(mesh):
    return _moe_case(mesh, "arctic-480b", 4, 1.25, 1)


def case_moe_tp_no_drop(mesh):
    return _moe_case(mesh, "arctic-480b", 3, 4.0, 2)


def case_moe_tp_drops(mesh):
    return _moe_case(mesh, "arctic-480b", 3, 1.25, 2)


def case_arctic_dense_residual(mesh):
    return _moe_case(mesh, "arctic-480b", 4, 1.25, 3, mlp=True)


def case_arctic_model_loss(mesh):
    """Arctic's whole forward (E=4 experts over model 4, its dense residual
    MLP) under the mesh against the mesh-free one at groups = dp."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model, moe
    from repro_torch.parallel import ctx
    cfg = dataclasses.replace(get_arch("arctic-480b").reduced(), n_layers=2)
    api = get_model(cfg)
    params = api.init(4, torch.float32, "cpu")
    batch = _batch(cfg, 14)
    local = moe.moe_block
    moe.moe_block = lambda *a, **kw: local(*a, groups=MESH[0], **kw)     # groups = dp
    try:
        want = api.loss(params, batch)
    finally:
        moe.moe_block = local
    with ctx.mesh_context(mesh):
        got = api.loss(params, batch)
    return {"err": _close(got, want, "loss"), "loss": float(want)}


def _batch(cfg, seed, b=2, t=16):
    toks = torch.randint(0, cfg.vocab, (b, t), generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def _attn_cfg(arch, heads, kv):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).reduced(), n_heads=heads, n_kv_heads=kv,
                               head_dim=16, n_layers=1)


def _loss_and_grads(api, params, batch):
    from repro_torch.train import optimizer as opt
    pairs = [(path, p.detach().requires_grad_()) for path, p in opt.flatten_with_paths(params)]
    loss = api.loss(opt.unflatten(pairs), batch)
    return loss, dict(zip((path for path, _ in pairs),
                          torch.autograd.grad(loss, [p for _, p in pairs])))


def _loss_case(mesh, cfg, seed):
    """The loss and every gradient under the mesh (each rank its padded
    heads, the partial gradients summed over "model") against mesh-free;
    gradients against the largest of any leaf."""
    from repro_torch.models import get_model, layers
    from repro_torch.parallel import ctx
    api = get_model(cfg)
    params = api.init(seed, torch.float32, "cpu")
    batch = _batch(cfg, seed + 1)
    want, g_want = _loss_and_grads(api, params, batch)
    with ctx.mesh_context(mesh):
        got, g_got = _loss_and_grads(api, params, batch)
        lp0 = {n: w[0] for n, w in params["layers"]["attn"].items()}
        q, k, _ = layers._qkv(cfg, lp0, torch.zeros(2, 16, cfg.d_model),
                              torch.zeros(2, 16, dtype=torch.int32), pad_tp=True)
    scale = max(float(g.abs().max()) for g in g_want.values())
    grad_err = max(float((g_got[p] - g).abs().max()) for p, g in g_want.items())
    assert grad_err <= TOL * scale, (grad_err, scale)
    return {"err": _close(got, want, "loss"), "loss": float(want), "grad_err": grad_err,
            "grad_scale": scale, "local_heads": [q.shape[2], k.shape[2]]}


def case_head_padding(mesh):
    res = _loss_case(mesh, _attn_cfg("qwen1.5-32b", 6, 6), 3)
    assert res["local_heads"] == [2, 2], res        # 8 padded heads over 4 ranks
    return res


def case_gqa_uneven_expansion(mesh):
    res = _loss_case(mesh, _attn_cfg("phi3-medium-14b", 6, 2), 5)
    assert res["local_heads"] == [2, 2], res        # k/v expanded per padded q head
    return res


def _train_steps_case(mesh, cfg, seed, n_steps=2, fsdp=False):
    """``n_steps`` of make_train_step on DTensor params and ZeRO-1 state
    against as many mesh-free steps (an MoE config's routed in groups = dp):
    loss, grad norm, every param, moment and master leaf, and each rank's
    local shapes and placements against ``param_pspec``/``zero1_pspec``.
    ``fsdp``: the params placed as FSDP places them; the step reads the
    placements from the DTensors only, and runs outside the forcing."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import get_model
    from repro_torch.parallel import spmd
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    api = get_model(cfg)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=1, eps=STEP_EPS,
                            moment_dtype=torch.float32)
    batches = [_batch(cfg, 30 + i) for i in range(n_steps)]

    params = api.init(seed, torch.float32, "cpu")
    state = opt.init_opt_state(oc, params)
    step = make_train_step(cfg, oc)
    with moe_groups(MESH[0]) if cfg.n_experts else contextlib.nullcontext():
        for b in batches:
            params, state, m_ref = step(params, state, b)

    full = api.init(seed, torch.float32, "cpu")
    with fsdp_forced(fsdp):
        p_specs = shd.param_shardings(cfg, full, mesh)
        o_specs = shd.opt_shardings(cfg, full, mesh)
    params_sh = shd.distribute_tree(full, p_specs, mesh)
    state_sh = opt.init_opt_state(oc, params_sh, o_specs)
    in_specs = shd.input_shardings(mesh, batches[-1])
    batches_sh = batches[:-1] + [{k: shd.distribute(v, in_specs[k], mesh)
                                  for k, v in batches[-1].items()}]
    spmd.MODEL_GATHERS.clear()
    for b in batches_sh:
        params_sh, state_sh, m = step(params_sh, state_sh, b)
    model_gathers = dict(spmd.MODEL_GATHERS)

    res = {"loss_err": abs(float(m["loss"]) - float(m_ref["loss"])),
           "grad_norm_err": abs(float(m["grad_norm"]) - float(m_ref["grad_norm"]))}
    assert res["loss_err"] <= TOL * (1 + abs(float(m_ref["loss"]))), res
    assert res["grad_norm_err"] <= TOL * (1 + abs(float(m_ref["grad_norm"]))), res
    sizes = shd.axis_sizes(mesh)

    def share(shape, spec):
        out = list(shape)
        for d, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                out[d] //= sizes[a]
        return out

    trees = {kind: dict(opt.flatten_with_paths(t)) for kind, t in
             (("param", params_sh), ("mu", state_sh.mu), ("nu", state_sh.nu),
              ("master", state_sh.master), ("mu_ref", state.mu), ("nu_ref", state.nu),
              ("master_ref", state.master)) if t is not None}
    errs, shapes = {}, {}
    for (path, p), (_, want) in zip(opt.flatten_with_paths(params_sh),
                                    opt.flatten_with_paths(params)):
        name = shd.path_str(path)
        assert isinstance(p, DTensor), name
        errs[name] = _close(p.full_tensor(), want, name)
        with fsdp_forced(fsdp):
            p_spec = shd.param_pspec(name, tuple(want.shape), cfg, mesh)
        o_spec = shd.zero1_pspec(p_spec, tuple(want.shape), mesh)
        tree_specs = {"param": p_spec, "moment": o_spec}
        for kind in ("param", "mu", "nu", "master"):
            if kind not in trees:
                continue
            x = trees[kind][path]
            spec = tree_specs["param" if kind == "param" else "moment"]
            got_shape = list(x.to_local().shape)
            assert got_shape == share(want.shape, spec), (name, kind, got_shape, spec)
            assert x.placements == shd.placements(spec, mesh), (name, kind, x.placements)
            if kind != "param":
                _close(x.full_tensor(), trees[kind + "_ref"][path], f"{name}.{kind}")
        shapes[name] = {"param": list(p.to_local().shape),
                        "moment": list(trees["mu"][path].to_local().shape)}
    res.update(param_err_max=max(errs.values()), local_shapes=shapes,
               model_gathers=model_gathers)
    return res


def case_sharded_train_step(mesh):
    """Two steps of make_train_step on DTensor params and ZeRO-1 state against
    two mesh-free steps; every rank's local shapes against the rules."""
    res = _train_steps_case(mesh, _attn_cfg("minicpm-2b", 6, 6), 3)
    shapes = res["local_shapes"]
    # the qkv projection is split over model, its moments over data as well
    assert shapes["layers/attn/wq"] == {"param": [1, 128, 24], "moment": [1, 64, 24]}, shapes
    return res


def case_fsdp_train_step(mesh):
    """The same two steps with the params placed as FSDP places them (split
    over "data" as well): each layer gathers its blocks over "data" and the
    attention's over "model" (6 heads padded to 8 over 4 ranks), the
    gradients come out reduce-scattered onto the blocks, and the tied
    embedding is vocab-parallel."""
    res = _train_steps_case(mesh, _attn_cfg("minicpm-2b", 6, 6), 3, fsdp=True)
    shapes = res["local_shapes"]
    # split over data and model; the moments take the param's blocks
    assert shapes["layers/attn/wq"] == {"param": [1, 64, 24], "moment": [1, 64, 24]}, shapes
    assert shapes["emb/tok"] == {"param": [128, 64], "moment": [128, 64]}, shapes
    return res


def case_fsdp_moe_train_step(mesh):
    """Arctic's layout: E=4 experts over model 4, FSDP forced, its dense
    residual MLP; each rank's experts come from its own blocks."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("arctic-480b").reduced(), n_experts=4)
    res = _train_steps_case(mesh, cfg, 4, fsdp=True)
    shapes = res["local_shapes"]
    assert shapes["layers/moe/w1"]["param"] == [2, 1, 64, 64], shapes
    assert shapes["layers/moe/router"]["param"] == [2, 64, 4], shapes
    return res


def _reduced(arch, **kw):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).reduced(), **kw)


def case_rwkv6_train_step(mesh):
    """A reduced rwkv6's mesh train step (4 heads over model 4): each rank its
    head of the time mix and its share of the channel mix, from its own
    blocks; only the small maa_w2 ([5, 32, d], split by d, used whole) is
    gathered over "model", in each layer's forward and recompute.  The
    embedding and head vocab-parallel."""
    cfg = _reduced("rwkv6-1.6b")
    res = _train_steps_case(mesh, cfg, 5, n_steps=1)
    shapes = res["local_shapes"]
    assert shapes["layers/tmix/wr"]["param"] == [2, 128, 32], shapes
    assert shapes["layers/tmix/wo"]["param"] == [2, 32, 128], shapes
    assert shapes["layers/tmix/u"]["param"] == [2, 1, 32], shapes
    assert shapes["layers/cmix/wv"]["param"] == [2, 64, 128], shapes
    maa_w2 = 5 * 32 * cfg.d_model
    assert res["model_gathers"] == {"leaves": 2 * cfg.n_layers,
                                    "elements": 2 * cfg.n_layers * maa_w2}, res
    return res


def case_zamba2_train_step(mesh):
    """A reduced zamba2's mesh train step (8 Mamba2 heads and 4 attention
    heads over model 4): each Mamba2 layer and the shared block at each of
    its sites run the rank's heads from its own blocks; nothing is gathered
    over "model"."""
    res = _train_steps_case(mesh, _reduced("zamba2-7b"), 6, n_steps=1)
    shapes = res["local_shapes"]
    assert shapes["mamba/in_x"]["param"] == [4, 128, 64], shapes
    assert shapes["mamba/conv_w"]["param"] == [4, 4, 64], shapes
    assert shapes["mamba/out_proj"]["param"] == [4, 64, 128], shapes
    assert shapes["shared/attn/wq"]["param"] == [128, 32], shapes
    assert res["model_gathers"] == {}, res
    return res


def case_rwkv6_train_step_heads_not_dividing(mesh):
    """rwkv6 at head size 64 (2 heads over model 4): the time mix gathered
    whole on every rank, the channel mix split."""
    res = _train_steps_case(mesh, _reduced("rwkv6-1.6b", ssm_head_dim=64), 7, n_steps=1)
    assert res["local_shapes"]["layers/tmix/wr"]["param"] == [2, 128, 32], res
    assert res["model_gathers"]["leaves"] > 0, res
    return res


def case_zamba2_train_step_heads_not_dividing(mesh):
    """zamba2 at Mamba2 head size 128 (2 heads over model 4): each Mamba2 layer
    gathered whole on every rank; the shared block split."""
    res = _train_steps_case(mesh, _reduced("zamba2-7b", ssm_head_dim=128), 8, n_steps=1)
    assert res["local_shapes"]["mamba/in_x"]["param"] == [4, 128, 64], res
    assert res["model_gathers"]["leaves"] > 0, res
    return res


def _head_case(mesh, arch, seed):
    """The embedding, head and cross-entropy on each rank's blocks (vocab over
    "model", ``layers.embed``/``layers.lm_loss`` under placed params) against
    the mesh-free ``cross_entropy(unembed(...))``: the loss, the gradient of
    the hidden input and of every head leaf, at a vocab of 500 padded to 512
    (the padded entries on the last model rank).  Rows whose argmax lies on
    another model rank than their label hold the max term's gradient there:
    the gradients differ from the max-free cross-entropy's."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers
    from repro_torch.parallel import ctx
    cfg = dataclasses.replace(get_arch(arch).reduced(), vocab=500)
    gen = torch.Generator().manual_seed(seed)
    emb = layers.init_embeddings(cfg, gen, torch.float32)
    emb["ln_f"] = 1 + 0.1 * torch.randn(cfg.d_model, generator=gen)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    labels = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    h = torch.randn((2, 16, cfg.d_model), generator=gen)

    def run(p, biased=True):
        x = h.clone().requires_grad_()
        hh = layers.embed(p, toks) + x
        if not biased:
            logits = layers.unembed(p, hh).float()
            logits = logits.masked_fill(torch.arange(logits.shape[-1]) >= cfg.vocab, -1e30)
            loss = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                                     labels.reshape(-1))
        else:
            loss = layers.lm_loss(p, hh, labels, cfg.vocab)
        return loss, dict(zip(["h", *p], torch.autograd.grad(loss, [x, *p.values()])))

    whole = {k: v.clone().requires_grad_() for k, v in emb.items()}
    want, g_want = run(whole)
    _, g_free = run(whole, biased=False)
    placed = shd.distribute_tree(emb, shd.param_shardings(cfg, {"emb": emb}, mesh)["emb"], mesh)
    blocks = {k: v.to_local().detach().requires_grad_() for k, v in placed.items()}
    pls = {"emb": {k: v.placements for k, v in placed.items()}}
    with ctx.mesh_context(mesh), ctx.placed_params(pls):
        got, g_got = run(blocks)
    head = "tok" if cfg.tie_embeddings else "out"
    assert shd.placements(shd.param_pspec(f"emb/{head}", tuple(emb[head].shape), cfg, mesh),
                          mesh)[1].is_shard(), "the head is not split over model"

    def block(name, g):
        return g if name == "h" else shd.local_block(g, placed[name].placements, mesh)
    scale = max(float(g.abs().max()) for g in g_want.values())
    errs = {n: float((g_got[n] - block(n, g)).abs().max()) for n, g in g_want.items()}
    assert max(errs.values()) <= TOL * scale, (errs, scale)
    # the max term: without it the head's gradient moves by far more than TOL
    max_term = float((g_got[head] - block(head, g_free[head])).abs().max())
    assert max_term > 100 * TOL * scale, (max_term, scale)
    logits = layers.unembed(emb, layers.embed(emb, toks) + h)[..., :cfg.vocab]
    n = layers.padded_vocab(cfg) // shd.axis_sizes(mesh)["model"]
    elsewhere = int((logits.argmax(-1) // n != labels // n).sum())
    assert elsewhere > 0, "every row's argmax on its label's rank"
    return {"err": _close(got, want, "loss"), "grad_errs": errs, "grad_scale": scale,
            "max_term_grad": max_term, "rows_argmax_on_another_rank": elsewhere}


def case_vocab_parallel_loss_tied(mesh):
    return _head_case(mesh, "minicpm-2b", 7)


def case_vocab_parallel_loss_untied(mesh):
    return _head_case(mesh, "codeqwen1.5-7b", 8)


def case_prefill_caches_kv_heads(mesh):
    """Prefill under the mesh pads nothing: the cache holds the KV heads."""
    from repro_torch.models import get_model
    from repro_torch.parallel import ctx
    cfg = _attn_cfg("qwen1.5-32b", 6, 6)
    api = get_model(cfg)
    params = api.init(3, torch.float32, "cpu")
    toks = _batch(cfg, 40)["tokens"]
    want, cache_want = api.prefill(params, toks, 24)
    with ctx.mesh_context(mesh):
        got, cache = api.prefill(params, toks, 24)
    assert cache["k"].shape == (1, 2, 24, 6, 16), cache["k"].shape
    return {"err": max(_close(got, want, "logits"), _close(cache["k"], cache_want["k"], "k"),
                       _close(cache["v"], cache_want["v"], "v"))}


def case_dtensor_layouts(mesh):
    """A spec's DTensor holds, on each rank, the block the reference's layout
    gives it (a dim split over ("data", "model") is data-major), and gathers
    back to the whole."""
    coord = mesh.get_coordinate()
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    cases = {(("data", "model"), None): full[coord[0] * 4 + coord[1]][None],
             ("data", "model"): full.reshape(2, 4, 4, 3)[coord[0], :, coord[1]],
             (None, "model"): full[:, coord[1] * 3:(coord[1] + 1) * 3],
             (): full}
    for spec, want in cases.items():
        dt = shd.distribute(full, spec, mesh)
        assert torch.equal(dt.to_local(), want), spec
        assert torch.equal(dt.full_tensor(), full), spec
    return {}


def case_kernel_wrappers_refuse_dtensors(mesh):
    from repro_torch.kernels.checksum import checksum
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba2_ssd import ssd_fwd
    from repro_torch.kernels.rwkv6_scan import wkv6_fwd
    q = shd.distribute(torch.zeros(2, 8, 4, 1, 64), (None, None, "model"), mesh)
    kv = shd.distribute(torch.zeros(2, 8, 4, 64), (None, None, "model"), mesh)
    words = shd.distribute(torch.zeros(64, dtype=torch.int32), ("model",), mesh)
    x = shd.distribute(torch.zeros(2, 8, 4, 64), (None, None, "model"), mesh)
    q1 = shd.distribute(torch.zeros(2, 1, 4, 64, dtype=torch.bfloat16), (None, None, "model"),
                        mesh)
    cache = shd.distribute(torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16),
                           (None, None, "model"), mesh)
    calls = {"flash_attention_fwd": lambda: flash_attention_fwd(q, kv, kv),
             "checksum": lambda: checksum(words),
             "wkv6_fwd": lambda: wkv6_fwd(x, x, x, x, torch.zeros(4, 64),
                                          torch.zeros(2, 4, 64, 64)),
             "ssd_fwd": lambda: ssd_fwd(x, torch.zeros(2, 8, 4), torch.zeros(4),
                                        torch.zeros(2, 8, 64), torch.zeros(2, 8, 64),
                                        torch.zeros(2, 4, 64, 64)),
             "decode_attention": lambda: decode_attention(q1, cache, cache, 8)}
    for name, call in calls.items():
        with pytest.raises(TypeError, match="DTensor"):
            call()
    return {}


def case_host_mesh_falls_back_to_the_world(mesh):
    from repro_torch.launch.mesh import make_host_mesh
    m = make_host_mesh(4, 4, device_type="cpu")      # 16 ranks asked of 8: (8, 1)
    assert (tuple(m.shape), m.mesh_dim_names) == ((8, 1), ("data", "model"))
    return {}


def case_train_step_spans_do_not_depend_on_placement(mesh):
    """One step on DTensor params records the mesh-free step's spans
    (``repro_torch.obs``): forward, backward and optimizer, in that order,
    under the caller's span."""
    from repro_torch import obs
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cfg = _attn_cfg("minicpm-2b", 6, 6)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=1, eps=STEP_EPS)
    step = make_train_step(cfg, oc)
    full = get_model(cfg).init(3, torch.float32, "cpu")
    params_sh = shd.distribute_tree(full, shd.param_shardings(cfg, full, mesh), mesh)
    state_sh = opt.init_opt_state(oc, params_sh, shd.opt_shardings(cfg, full, mesh))
    got = []
    for params, state in ((full, opt.init_opt_state(oc, full)), (params_sh, state_sh)):
        obs.reset()
        with obs.span("step"):
            step(params, state, _batch(cfg, 30))
        got.append([(s.name, s.parent and s.parent.name) for s in obs.spans()])
    assert got[0] == got[1] == [("train.forward", "step"), ("train.backward", "step"),
                                ("train.optimizer", "step"), ("step", None)], got
    return {}


CASES = cases_of(globals())


# ------------------------------------------------------------------ the tests

@pytest.fixture(scope="module")
def rank_results():
    return spawn_ranks(__file__, WORLD, SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_case_on_8_gloo_ranks(rank_results, case):
    for rank, res in enumerate(rank_results):
        assert res[case]["ok"], f"rank {rank}:\n{res[case]['error']}"


def test_production_mesh_under_the_fake_process_group():
    """make_production_mesh over worlds of 256 and 512 fake ranks: the
    reference's shapes and axis names (src/repro/launch/mesh.py:14-19)."""
    script = (
        "import json, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "for multi_pod, world in ((False, 256), (True, 512)):\n"
        "    dist.init_process_group('fake', store=FakeStore(), rank=3, world_size=world)\n"
        "    m = make_production_mesh(multi_pod=multi_pod, device_type='cpu')\n"
        "    print(json.dumps([list(m.shape), list(m.mesh_dim_names)]))\n"
        "    dist.destroy_process_group()\n")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-3000:]
    got = [json.loads(line) for line in res.stdout.splitlines()]
    assert got == [[[16, 16], ["data", "model"]], [[2, 16, 16], ["pod", "data", "model"]]]


if __name__ == "__main__":
    rank_main(CASES, MESH, PG_TIMEOUT_S)
