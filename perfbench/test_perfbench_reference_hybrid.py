"""The hybrid cell (``zamba2-7b-instruct.decode``) on the CPU: its plain reference
against the port and against ``transformers``' Zamba2, its parameter tree and
weights, what decides its ``correct``, its readers and its counts.

The sizes keep the published block: two shared blocks with at least two sites
each, B and C in two groups, the sites' adapters on."""

import dataclasses
import json
import math
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import check, flops_hybrid, manifest, trace, weights, weights_hybrid, work_decode
from perfbench._testing import tiny_ctx
from perfbench.drivers import serve_hybrid
from perfbench.reference import hybrid, hybrid_layout
from perfbench.run import measure

HERE = Path(__file__).resolve().parent
BENCH = manifest.load()
CELL = "zamba2-7b-instruct.decode"
# on top of _testing.TINY: 6 layers with sites at 1, 2, 3 and 5 (two of each block)
SMALL = dict(n_layers=6, hybrid_layer_ids=[1, 2, 3, 5], ssm_head_dim=16, ssm_state=16,
             adapter_rank=8)
# the served model's width (its logits' scale, which the gaps are measured in) at four
# layers, a site of each block, the rest narrow
FAULTS = dict(d_model=3584, n_heads=2, n_kv_heads=2, head_dim=224, d_ff=256, vocab=2048,
              ssm_expand=1, ssm_head_dim=64, ssm_state=16, adapter_rank=8, n_layers=4,
              hybrid_layer_ids=[1, 3])
# the control's fp8 error grows with depth: twelve layers, and answers of 16-32 tokens
# to compare it at, take it past the limit
CONTROL = dict(FAULTS, n_layers=12, hybrid_layer_ids=[1, 4, 7, 10])


def _arch(**kw):
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch("zamba2-7b-instruct").reduced(), n_layers=6,
                              hybrid_layer_ids=(1, 2, 3, 5), **kw)
    return cfg, dataclasses.asdict(cfg)


def test_the_cells_configuration_is_the_ports_published_entry():
    from repro_torch.configs import get_arch
    conf = json.loads((HERE / "configs" / "zamba2-7b-instruct.json").read_text())
    port = dataclasses.asdict(get_arch("zamba2-7b-instruct"))
    assert {k: v for k, v in port.items() if k in conf["arch"]} == \
        {k: (tuple(v) if isinstance(v, list) else v) for k, v in conf["arch"].items()}
    assert conf["reduced"] == [] and conf["hybrid_layer_ids"] == list(port["hybrid_layer_ids"])
    assert (conf["attention_head_dim"], conf["mamba_ngroups"], conf["num_mem_blocks"],
            conf["adapter_rank"]) == (port["head_dim"], port["ssm_groups"],
                                      port["shared_blocks"], port["adapter_rank"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_layout_is_the_programs_tree(dtype):
    from repro_torch.models import get_model
    cfg, arch = _arch()
    lay = hybrid_layout.layout(arch)
    tree = get_model(cfg).init(0, dtype, "cpu")
    weights.fill(tree, lay, 5, dtype)
    again = weights.make(lay, 5, dtype, "cpu")
    for path, t in weights.flatten(tree):
        assert torch.equal(t, again[path]), path


def test_mamba2s_own_initial_values():
    _, arch = _arch()
    w = weights_hybrid.make(hybrid_layout.layout(arch), 7, torch.bfloat16, "cpu")
    nh = hybrid_layout.widths(arch)[2]
    a_log, d, dt_bias = (w[("mamba", k)] for k in ("A_log", "D", "dt_bias"))
    assert a_log.dtype == dt_bias.dtype == torch.float32
    want = torch.log(torch.arange(1, nh + 1, dtype=torch.float32))
    assert torch.equal(a_log, want.expand_as(a_log))
    assert torch.equal(d, torch.ones_like(d))
    dt = torch.nn.functional.softplus(dt_bias)
    assert 1e-4 * 0.99 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.01
    again = weights_hybrid.make(hybrid_layout.layout(arch), 7, torch.bfloat16, "cpu")
    assert torch.equal(again[("mamba", "dt_bias")], dt_bias)
    assert not torch.equal(weights_hybrid.make(hybrid_layout.layout(arch), 8, torch.bfloat16,
                                               "cpu")[("mamba", "dt_bias")], dt_bias)


def test_serving_logits_through_prefill_and_decode_match_the_references_forward():
    from repro_torch.models import get_model
    cfg, arch = _arch()
    api = get_model(cfg)
    w = weights_hybrid.make(hybrid_layout.layout(arch), 2**31 + 3, torch.float32, "cpu")
    params = weights.nest(w)
    toks = torch.randint(0, cfg.vocab, (3, 21), generator=torch.Generator().manual_seed(1))
    toks[0, :6] = 0                                 # a left-padded row, as a wave pads it
    with torch.no_grad():
        logits, cache = api.prefill(params, toks[:, :16], 24)
        got = [logits[:, -1, :cfg.vocab]]
        for i in range(16, 20):
            logits, cache = api.decode(params, toks[:, i:i + 1], cache, i)
            got.append(logits[:, -1, :cfg.vocab])
    want = hybrid.forward_logits(arch, w, toks[:, :20])[:, 15:20]
    assert float((torch.stack(got, 1) - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_reference_is_transformers_zamba2(monkeypatch):
    """The reference against ``transformers``' ``Zamba2ForCausalLM`` (eager, its plain
    PyTorch path) built from a small ``Zamba2Config`` with the reference's weights
    copied in.  Its ``time_step_min`` is set near 0: that path clamps dt at it, which
    the published model (``time_step_limit`` null) does not.  Its ``chunk_size`` holds
    the whole sequence: that path (transformers 4.57) carries the state from chunk to
    chunk summing its segment-sum matrix over the wrong index (Mamba2's own transposes
    it first), so past one chunk it is not the model's scan."""
    monkeypatch.setenv("USE_TF", "0")      # the library's torch models alone
    tr = pytest.importorskip("transformers")
    # the library's head dim is 2 d / heads and its softmax scale (head dim / 2)^-1/2
    cfg, arch = _arch(head_dim=64, attn_scale=32 ** -0.5)
    w = weights_hybrid.make(hybrid_layout.layout(arch), 11, torch.float32, "cpu")
    d, L = cfg.d_model, cfg.n_layers
    types = ["hybrid" if i in cfg.hybrid_layer_ids else "mamba" for i in range(L)]
    zc = tr.Zamba2Config(
        vocab_size=cfg.vocab, hidden_size=d, intermediate_size=cfg.d_ff, num_hidden_layers=L,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        mamba_d_state=cfg.ssm_state, mamba_d_conv=4, mamba_expand=cfg.ssm_expand,
        mamba_ngroups=cfg.ssm_groups, n_mamba_heads=2 * d // cfg.ssm_head_dim,
        num_mem_blocks=cfg.shared_blocks, adapter_rank=cfg.adapter_rank,
        use_shared_attention_adapter=False, use_mem_rope=True, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_eps, hidden_act="gelu", chunk_size=64, layers_block_type=types,
        time_step_min=1e-9, tie_word_embeddings=True, attn_implementation="eager",
        use_cache=False, pad_token_id=0)
    model = tr.Zamba2ForCausalLM(zc).eval()
    assert zc.attention_head_dim == cfg.hd
    t = lambda path, *i: w[path][i].t() if i else w[path].t()  # noqa: E731
    hq = cfg.n_heads * cfg.hd
    with torch.no_grad():
        model.model.embed_tokens.weight.copy_(w[("emb", "tok")][:cfg.vocab])
        model.model.final_layernorm.weight.copy_(w[("emb", "ln_f")])
        j = 0
        for i, layer in enumerate(model.model.layers):
            mamba_layer = layer.mamba_decoder if types[i] == "hybrid" else layer
            mx = mamba_layer.mamba
            mamba_layer.input_layernorm.weight.copy_(w[("mamba", "ln")][i])
            mx.in_proj.weight.copy_(t(("mamba", "in_proj"), i))
            mx.conv1d.weight.copy_(w[("mamba", "conv_w")][i].t()[:, None, :])
            mx.conv1d.bias.copy_(w[("mamba", "conv_b")][i])
            for k in ("A_log", "D", "dt_bias"):
                getattr(mx, k).copy_(w[("mamba", k)][i])
            mx.norm.weight.copy_(w[("mamba", "norm")][i])
            mx.out_proj.weight.copy_(t(("mamba", "out_proj"), i))
            if types[i] != "hybrid":
                continue
            blk, sb = layer.shared_transformer, j % cfg.shared_blocks
            qkv = w[("shared", "wqkv")][sb]
            blk.input_layernorm.weight.copy_(w[("shared", "ln1")][sb])
            for proj, cols in (("q_proj", slice(0, hq)), ("k_proj", slice(hq, 2 * hq)),
                               ("v_proj", slice(2 * hq, 3 * hq))):
                getattr(blk.self_attn, proj).weight.copy_(qkv[:, cols].t())
            blk.self_attn.o_proj.weight.copy_(t(("shared", "wo"), sb))
            blk.pre_ff_layernorm.weight.copy_(w[("shared", "ln2")][sb])
            blk.feed_forward.gate_up_proj.weight.copy_(t(("shared", "w_gu"), sb))
            blk.feed_forward.down_proj.weight.copy_(t(("shared", "w_down"), sb))
            adapter = blk.feed_forward.gate_up_proj_adapter_list[j]
            adapter[0].weight.copy_(t(("sites", "ad_a"), j))
            adapter[1].weight.copy_(t(("sites", "ad_b"), j))
            layer.linear.weight.copy_(t(("sites", "lin"), j))
            j += 1
        toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(2))
        want = model(input_ids=toks, use_cache=False).logits
    got = hybrid.forward_logits(arch, w, toks)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ------------------------------------------------------------------ what decides correct

def _run(ctx):
    result = measure(ctx, BENCH)
    assert set(result["checks"]) == set(ctx.cell["limits"])
    return result


def test_a_sound_program_is_correct():
    result = _run(tiny_ctx(CELL, **SMALL))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert {"setup_s", "tpot_p95_ms", "decode_tokens_per_s"} <= set(result["metrics"])


def test_a_served_token_altered_is_not_correct():
    from perfbench.test_perfbench_correct import _altered_token
    ctx = tiny_ctx(CELL, **FAULTS)
    ctx.hooks["server"] = _altered_token
    assert not _run(ctx)["correct"]


def test_a_decode_step_that_leaves_its_cache_unchanged_is_not_correct():
    from perfbench.test_perfbench_correct import _cache_unchanged
    ctx = tiny_ctx(CELL, **FAULTS)
    ctx.hooks["server"] = _cache_unchanged
    assert not _run(ctx)["correct"]


def test_the_control_is_not_correct():
    ctx = tiny_ctx(CELL, **CONTROL)
    ctx.traffic.update(new_tokens=[16, 32])
    ctx.extra_readings["control"] = serve_hybrid.control_readings
    record = serve_hybrid.run(ctx)
    assert check.judge(record["numbers"], ctx.cell["limits"])["correct"]
    assert not check.judge(record["readings"]["control"], ctx.cell["limits"])["correct"], \
        record["readings"]["control"]


# ------------------------------------------------------------------ readers and counts

class CpuTracer(trace.Tracer):
    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._wall = time.perf_counter() - self._t0
        self.prof.stop()
        self._done, self.prof = self.prof, None


def test_the_hybrid_readers_read_a_traced_run(monkeypatch):
    from repro_torch import obs
    monkeypatch.setattr(trace, "Tracer", CpuTracer)
    ctx = tiny_ctx(CELL, seconds=1.0, **SMALL)
    ctx.traced = True
    obs.reset()
    result = measure(ctx, BENCH)
    assert result["correct"], result["checks"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert 0 < m["shared_share.zamba2_decode"] < 100
    assert 0 < m["mfu.zamba2_decode"] < 100 and 0 < m["prefill_share.decode"] < 100
    assert math.isfinite(m["decode_host_ms.zamba2_decode"])
    assert "decode_attn_roofline.decode" not in m           # no kernel on the CPU
    # every decode step holds a span a site and one a run of Mamba2 layers
    steps = [s for s in obs.spans() if s.name == "serve.decode"]
    inner = [s for s in obs.spans() if s.name.startswith("zamba2.") and s.parent in set(steps)]
    assert steps and len(inner) == len(steps) * (2 * len(SMALL["hybrid_layer_ids"]) + 1)


def test_a_program_without_spans_leaves_the_span_metrics_out(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_obs(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch" and "obs" in (fromlist or ()):
            raise ImportError("cannot import name 'obs' from 'repro_torch'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_obs)
    ctx = tiny_ctx(CELL)
    names = ["decode_host_ms.zamba2_decode", "shared_share.zamba2_decode"]
    assert [manifest.reader(n)({"setup_s": 0.0}, ctx) for n in names] == [None, None]


@pytest.mark.parametrize("cell,kv,hd,sites", [("minicpm-2b.decode", 36, 64, 40),
                                              (CELL, 32, 224, 13)])
def test_decode_attention_roofline_takes_each_traced_step_at_its_valid_slots(cell, kv, hd,
                                                                             sites):
    ctx = tiny_ctx(cell)
    ctx.config = manifest.cell(BENCH, cell)["config"]
    ctx.traffic = manifest.cell(BENCH, cell)["traffic"]
    steps = ctx.cell["trace_decode_steps"]
    one = work_decode.decode_attention_work(32, 2048 + 2, kv, 1, hd, 2)[1] / 3.35e12
    ctx.trace = {"ops": {"repro_torch::decode_attention": steps * sites},
                 "kernels": {"decode_attn_tiles<x>": [steps * sites * one, steps * sites]}}
    record = {"waves": [{"max_p": 2048}]}
    got = manifest.reader("decode_attn_roofline.decode")(record, ctx)
    # the steps' valid slots grow from 2048 + 2 to 2048 + 17: the bound's mean over them
    assert got == pytest.approx(100 * (2048 + 2 + (steps - 1) / 2) / (2048 + 2), rel=2e-3)
    ctx.trace["ops"]["repro_torch::decode_attention"] += 1       # not a whole number a step
    assert manifest.reader("decode_attn_roofline.decode")(record, ctx) is None


@pytest.mark.parametrize("shape", [(32, 2100, 36, 1, 64, 2), (32, 2300, 32, 1, 224, 2),
                                   (2, 333, 8, 8, 128, 4)])
def test_frozen_decode_work_equals_the_programs(shape):
    from repro_torch.kernels import work as theirs
    assert work_decode.decode_attention_work(*shape) == theirs.decode_attention_work(*shape)


def test_model_flops_count_each_site_once():
    a = json.loads((HERE / "configs" / "zamba2-7b-instruct.json").read_text())["arch"]
    assert flops_hybrid.mamba_layer(a) * a["n_layers"] == pytest.approx(6.35e9, rel=2e-3)
    assert flops_hybrid.site(a) * 13 == pytest.approx(4.56e9, rel=2e-3)
    assert flops_hybrid.head(a) == 3584 * 32000
    assert flops_hybrid.decode(a, 10) == pytest.approx(2 * 10 * 11.03e9, rel=2e-3)
    from repro_torch.configs import get_arch
    cfg = get_arch("zamba2-7b-instruct")
    shared_once = cfg.param_count() - cfg.vocab * cfg.d_model
    assert flops_hybrid.body(a) > shared_once        # the blocks count at every site
