"""Ambient mesh context for model code.

Mirrors ``repro.parallel.ctx``.  Models are mesh-agnostic by default; a few
blocks (attention's head padding, the MoE dispatch) take a per-rank path
when a mesh is set here.  Unit tests and single-card runs leave it unset
and take the local paths.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named ``("data", "model")`` or ``("pod", "data", "model")``.  Model code
under a mesh runs SPMD on each rank's own tensors; ``batch_sharded`` says
whether a rank's activations are its share of the batch's rows (as a train
step places them) or the whole batch, the same on every rank (the default).
``param_placements`` says whether the parameters the model is given are
whole (None, the default) or each rank's blocks of DTensors, and then
holds each leaf's placements, a tree like the parameters: the model
gathers a layer's blocks inside its block (``spmd.gather``), as a train
step on placed parameters hands them over.  ``kv_split`` says how the K/V
cache a placed serving call hands the model is split over "model": by its
heads, by its sequence (each rank a contiguous range of slots of every KV
head), or not at all; the caller derives it from ``sharding.cache_pspec``,
which ``force_sequence_split`` turns to the sequence split where the heads
would divide the axis.
"""

from __future__ import annotations

from contextlib import contextmanager

_MESH = None
_BATCH_SHARDED = False
_PLACEMENTS = None
_KV_SPLIT = None
_SEQUENCE_SPLIT_FORCED = False


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextmanager
def mesh_context(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def batch_sharded() -> bool:
    return _BATCH_SHARDED


@contextmanager
def sharded_batch():
    """For the block, activations hold this rank's rows of the batch, split
    over the mesh's data axes."""
    global _BATCH_SHARDED
    prev = _BATCH_SHARDED
    _BATCH_SHARDED = True
    try:
        yield
    finally:
        _BATCH_SHARDED = prev


def param_placements():
    """The tree of the parameters' DTensor placements when the model is given
    each rank's blocks, else None."""
    return _PLACEMENTS


@contextmanager
def placed_params(placements):
    """For the block, the model's parameters are this rank's blocks of
    DTensors placed as ``placements`` (a tree like theirs) says."""
    global _PLACEMENTS
    prev = _PLACEMENTS
    _PLACEMENTS = placements
    try:
        yield
    finally:
        _PLACEMENTS = prev


def kv_split():
    """How the K/V cache the model is given is split over "model": "heads",
    "sequence", or None (every model rank holds all of it, the default)."""
    return _KV_SPLIT


@contextmanager
def placed_cache(split):
    """For the block, the K/V cache the model reads and writes is this rank's
    block of one split over "model" as ``split`` says (see ``kv_split``)."""
    global _KV_SPLIT
    prev = _KV_SPLIT
    _KV_SPLIT = split
    try:
        yield
    finally:
        _KV_SPLIT = prev


def sequence_split_forced() -> bool:
    """Whether ``force_sequence_split`` is in force."""
    return _SEQUENCE_SPLIT_FORCED


@contextmanager
def force_sequence_split():
    """For the block, ``sharding.cache_pspec`` splits a K/V cache by its
    sequence over "model" even where its KV heads divide the axis: the
    sequence branch on a mesh whose heads divide (the tests; a 1 x 1 mesh on
    one card)."""
    global _SEQUENCE_SPLIT_FORCED
    prev = _SEQUENCE_SPLIT_FORCED
    _SEQUENCE_SPLIT_FORCED = True
    try:
        yield
    finally:
        _SEQUENCE_SPLIT_FORCED = prev
