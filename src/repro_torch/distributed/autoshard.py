"""Activation sharding constraints, context-scoped.

Counterpart of ``repro/distributed/autoshard.py``. The launcher installs the
activation layout with ``activation_sharding(...)`` on a ``DeviceMesh``;
inside it each ``constrain_*`` redistributes a DTensor to the placements it
pins (the JAX package's ``with_sharding_constraint``). Outside the context,
and on a tensor that is not a DTensor, every ``constrain_*`` returns its
input as it is, so single-device runs are untouched. As in the JAX package
the context is active only when it has batch axes: on a mesh whose data axes
are all of size 1 it is a no-op.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.config import MeshSpec
from repro_torch.distributed.sharding import Sharder, Spec, placements

_SPECS = {"batch_axes": None, "model_axis": None, "model_size": 0, "mesh": None}


@contextlib.contextmanager
def activation_sharding(batch_axes, model_axis: Optional[str] = "model",
                        model_size: int = 0, mesh=None):
    """batch_axes: axis name (or tuple) for the leading batch dim, or None.
    model_size enables divisibility-checked constraints on model dims;
    ``mesh`` is the ``DeviceMesh`` the DTensors live on."""
    prev = dict(_SPECS)
    _SPECS.update(batch_axes=batch_axes, model_axis=model_axis, model_size=model_size,
                  mesh=mesh)
    try:
        yield
    finally:
        _SPECS.update(prev)


def active() -> bool:
    return _SPECS["batch_axes"] is not None


def _pin(x, spec: Spec):
    if not active() or not isinstance(x, DTensor):
        return x
    mesh = _SPECS["mesh"] or x.device_mesh
    want = placements(spec, mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def constrain_act(h):
    """Pin a (B, S, D) / (B, S, H, ...) activation to batch-sharded."""
    if not active():
        return h
    return _pin(h, Spec(_SPECS["batch_axes"], *([None] * (h.dim() - 1))))


def dims_spec(shape: Sequence[int], dims, alt=None) -> Spec:
    """The spec ``constrain_dims`` pins: entries 'batch', 'model' or None;
    'model' entries are dropped unless the dim divides the model-axis size,
    and then ``alt`` (all of whose 'model' dims divide) is taken instead."""
    def build(dd):
        spec, ok = [], True
        for i, d in enumerate(dd):
            if d == "batch":
                spec.append(_SPECS["batch_axes"])
            elif d == "model":
                ms = _SPECS["model_size"]
                if ms and shape[i] % ms == 0:
                    spec.append(_SPECS["model_axis"])
                else:
                    ok = False
                    spec.append(None)
            else:
                spec.append(None)
        return spec, ok

    spec, ok = build(dims)
    if not ok and alt is not None:
        spec2, ok2 = build(alt)
        if ok2:
            spec = spec2
    return Spec(*spec)


def constrain_dims(x, dims, alt=None):
    """Pin arbitrary dims (``dims_spec``). E.g. MoE expert buffers
    (B, E, C, D) -> ('batch', 'model', None, None)."""
    if not active():
        return x
    return _pin(x, dims_spec(tuple(x.shape), dims, alt))


def constrain_logits(logits):
    """(B, S, V): batch over data, vocab over model (when divisible)."""
    if not active():
        return logits
    ms = _SPECS["model_size"]
    v = _SPECS["model_axis"] if ms and logits.shape[-1] % ms == 0 else None
    return _pin(logits, Spec(_SPECS["batch_axes"], None, v))


# ---------------------------------------------------------------------------
# Placements at a ``local_map`` site (the kernel seam, the embedding lookup,
# the MoE buffers, the vocabulary-parallel loss)
# ---------------------------------------------------------------------------
def data_placements(mesh, batch: int) -> list:
    """Per mesh dim: Shard(0) on the data axes that take a batch of
    ``batch`` (``Sharder.dp``), Replicate elsewhere."""
    names = tuple(mesh.mesh_dim_names)
    dp = Sharder(MeshSpec(tuple(mesh.shape), names)).dp(batch)
    return list(placements(Spec(dp), mesh))


def with_model(mesh, base: Sequence, placement) -> tuple:
    """``base`` with ``placement`` on the model axis, where the mesh has one."""
    out = list(base)
    if "model" in mesh.mesh_dim_names:
        out[mesh.mesh_dim_names.index("model")] = placement
    return tuple(out)


def mesh_model_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index("model")] if "model" in names else 1


def model_partial(mesh, pl: Sequence) -> tuple:
    """``pl`` with Partial on the model axis: the gradient of an input that
    is replicated there but that each model rank uses in part."""
    return with_model(mesh, pl, Partial())


def grad_placements(mesh, base: Sequence, model_pl, partial_on_model: bool) -> tuple:
    """The gradient placements of a weight replicated over the data axes:
    Partial on each data axis the batch is sharded over (``base``), the
    weight's own placement on the model axis, or Partial there where each
    model rank uses the weight in part."""
    out = [Partial() if isinstance(p, Shard) else Replicate() for p in base]
    return with_model(mesh, out, Partial() if partial_on_model else model_pl)


def chunk_rows(x: torch.Tensor, n: int) -> list:
    """``n`` equal slices of ``x`` along its leading (batch) dim. A DTensor
    is sliced on each rank's local rows, so each chunk keeps the batch's
    placements (a slice of the global rows would gather the batch first):
    a chunk then holds each rank's share of the rows, as JAX's reshape to
    (n, B / n, ...) of a data-sharded batch does."""
    if isinstance(x, DTensor):
        local = x.to_local()
        return [DTensor.from_local(c, x.device_mesh, x.placements, run_check=False)
                for c in chunk_rows(local, n)]
    lead = x.shape[0]
    if lead % n:
        raise ValueError(f"a batch of {lead} does not split into {n} chunks")
    size = lead // n
    return [x[i:i + size] for i in range(0, lead, size)]


def cat_rows(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The inverse of ``chunk_rows``: DTensors are joined on each rank's
    local rows."""
    if isinstance(xs[0], DTensor):
        return DTensor.from_local(torch.cat([x.to_local() for x in xs]), xs[0].device_mesh,
                                  xs[0].placements, run_check=False)
    return torch.cat(xs)


DATA_AXES = ("pod", "data")


def gather_fsdp(t: torch.Tensor) -> torch.Tensor:
    """A DTensor weight gathered over the data axes (FSDP's all-gather before
    use; its backward reduce-scatters the gradient), its model-axis
    placement kept; anything else as it is."""
    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in DATA_AXES else p
                 for i, p in enumerate(t.placements))
    return t if want == tuple(t.placements) else t.redistribute(t.device_mesh, want)


def gather_block(block) -> None:
    """Each parameter of a block that ``elastic.distribute_module`` set up
    for FSDP (``block._fsdp_params``) gathered over the data axes, until
    ``release_block`` puts the Parameters back. The block's forward hooks
    call both; a block so hooked is rematerialised without early stop, so
    that its recomputation reaches the release (``transformer._run_blocks``)."""
    for mod, name, p in getattr(block, "_fsdp_params", ()):
        mod._parameters[name] = gather_fsdp(p)


def release_block(block) -> None:
    for mod, name, p in getattr(block, "_fsdp_params", ()):
        mod._parameters[name] = p


@contextlib.contextmanager
def block_weights(block):
    """``gather_block`` for a call that is not the block's forward (its
    prefill or decode step); nothing for a block without FSDP."""
    gather_block(block)
    try:
        yield
    finally:
        release_block(block)
