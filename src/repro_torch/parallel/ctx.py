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
step on placed parameters hands them over.
"""

from __future__ import annotations

from contextlib import contextmanager

_MESH = None
_BATCH_SHARDED = False
_PLACEMENTS = None


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
