"""The port's sharding rules against the JAX package's, on abstract meshes.

``repro_torch.parallel.sharding`` is a pure function of shapes and mesh
sizes, as ``repro.parallel.sharding`` is, so the two are compared spec for
spec with no devices and no process group: JAX's side on a
``jax.sharding.AbstractMesh`` and ``jax.eval_shape``'d parameters, the
port's on a plain {axis: size} mesh and parameters made under
``FakeTensorMode`` (which allocates nothing).  Every parameter, ZeRO-1
moment, cache leaf, input and logits spec of all 10 architectures at their
full published configurations, on the production meshes and on (2, 4).
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_arch as jax_get_arch
from repro.models import get_model as jax_model
from repro.parallel import sharding as jshd
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.models import get_model
from repro_torch.parallel import sharding as shd
from repro_torch.train import optimizer as opt

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4))}


def _meshes(name):
    axes, sizes = MESHES[name]
    return AbstractMesh(sizes, axes), dict(zip(axes, sizes))


@functools.cache
def _jax_params(arch):
    api = jax_model(jax_get_arch(arch))
    return jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))


@functools.cache
def _torch_params(arch):
    with FakeTensorMode():
        p = get_model(get_arch(arch)).init(0, torch.bfloat16, "cpu")
    return {shd.path_str(path): tuple(x.shape) for path, x in opt.flatten_with_paths(p)}


def _jax_leaves(tree):
    return {jshd._path_str(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_moment_specs_match_jax(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    want = {}
    for path, x in _jax_leaves(_jax_params(arch)).items():
        ps = jshd.param_pspec(path, x.shape, jcfg, jmesh)
        want[path] = (tuple(x.shape), tuple(ps),
                      tuple(jshd.zero1_pspec(ps, x.shape, jmesh)))
    got = {}
    for path, shape in _torch_params(arch).items():
        ps = shd.param_pspec(path, shape, cfg, mesh)
        got[path] = (shape, ps, shd.zero1_pspec(ps, shape, mesh))
    assert got == want
    # the tree functions agree with the leaf functions
    with FakeTensorMode():
        params = get_model(cfg).init(0, torch.bfloat16, "cpu")
    for specs, i in ((shd.param_shardings(cfg, params, mesh), 1),
                     (shd.opt_shardings(cfg, params, mesh), 2)):
        assert {shd.path_str(p): s for p, s in opt.flatten_with_paths(specs)} == \
            {p: v[i] for p, v in want.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_input_and_logits_specs_match_jax(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    japi, api = jax_model(jcfg), get_model(cfg)
    dsize = 32 if "pod" in MESHES[mesh_name][0] else MESHES[mesh_name][1][0]
    for batch in (1, 2 * dsize):
        jcache = japi.cache_spec(batch, 4096)
        want = {k: tuple(jshd.cache_pspec(k, v.shape, jmesh, jcfg)) for k, v in jcache.items()}
        cache = {k: _Shape(s) for k, (s, _) in api.cache_spec(batch, 4096).items()}
        assert {k: tuple(s.shape) for k, s in cache.items()} == \
            {k: tuple(v.shape) for k, v in jcache.items()}
        assert shd.cache_shardings(cfg, cache, mesh) == want
        assert {k: shd.cache_pspec(k, s.shape, mesh, cfg) for k, s in cache.items()} == want

        ins = {"tokens": _Shape((batch, 2048)), "labels": _Shape((batch, 2048))}
        jins = {k: jax.ShapeDtypeStruct(v.shape, jnp.int32) for k, v in ins.items()}
        jin = jax.tree.map(lambda s: tuple(s.spec), jshd.input_shardings(jmesh, jins))
        assert shd.input_shardings(mesh, ins) == jin
        assert shd.logits_sharding(mesh, batch) == \
            tuple(jshd.logits_sharding(jmesh, batch).spec)
        assert shd.batch_pspec(mesh) == tuple(jshd.batch_pspec(jmesh))


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


@pytest.mark.parametrize("spec,mesh_name,want", [
    ((None, "model"), "16x16", (Replicate(), Shard(1))),
    (("data", None, "model"), "16x16", (Shard(0), Shard(2))),
    ((("pod", "data"), "model"), "2x16x16", (Shard(0), Shard(0), Shard(1))),
    ((None, ("pod", "data"), None), "2x16x16", (Shard(1), Shard(1), Replicate())),
    ((), "2x4", (Replicate(), Replicate())),
    (("model", None, ("pod", "data")), "2x16x16", (Shard(2), Shard(2), Shard(0))),
])
def test_placements_one_per_mesh_dim(spec, mesh_name, want):
    assert shd.placements(spec, _meshes(mesh_name)[1]) == want
