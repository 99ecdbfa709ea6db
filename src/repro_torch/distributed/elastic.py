"""Elastic re-meshing: survive device loss / fleet growth mid-run.

Counterpart of ``repro/distributed/elastic.py``. The checkpointed state is
layout-free (``restore_checkpoint`` fills host tensors), so elasticity is a
resharding problem: pick the best mesh the surviving cards support, rebuild
the specs for it, and distribute the state across.

``plan_elastic_mesh`` chooses the largest (data, model) grid that (a) the
device count supports, (b) keeps the model axis no larger than the
reference (the TP degree can only shrink safely: growing it would need
divisibility re-checks against every weight), and (c) keeps per-device
parameter bytes under the memory budget (the port's ``HW.hbm_capacity``,
80 GB, by default).

``reshard_state`` moves a ``TrainState`` onto a ``DeviceMesh`` under the
rules of ``distributed.sharding``; with the checkpoints this is the whole
recovery path:

    state, extra, step = restore_checkpoint(dir, like)        # host tensors
    mesh_spec = plan_elastic_mesh(n_cards, ref_spec, param_bytes)
    state, mesh = reshard_state(state, mesh_spec)              # new fleet
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.config import HW, MeshSpec
from repro_torch.distributed.autoshard import DATA_AXES, gather_block, release_block
from repro_torch.distributed.sharding import opt_state_pspecs, param_pspecs, placements
from repro_torch.launch.mesh import make_mesh


def _divisors_desc(n: int):
    return [d for d in range(n, 0, -1) if n % d == 0]


def plan_elastic_mesh(
    n_devices: int,
    reference: MeshSpec,
    param_bytes: float = 0.0,
    hbm_budget: float = HW.hbm_capacity,
) -> MeshSpec:
    """Largest (data, model) mesh for ``n_devices`` surviving devices."""
    ref_model = reference.axis_size("model") if "model" in reference.axes else 1
    best: Optional[Tuple[int, int]] = None
    for model in _divisors_desc(ref_model):
        if n_devices % model:
            continue
        data = n_devices // model
        if param_bytes and param_bytes / (model * max(data, 1)) > hbm_budget:
            continue  # FSDP footprint would not fit
        cand = (data, model)
        if best is None or cand[0] * cand[1] > best[0] * best[1] or (
            cand[0] * cand[1] == best[0] * best[1] and cand[1] > best[1]
        ):
            best = cand
    if best is None:
        # Degenerate fallback: pure DP over whatever is left.
        best = (n_devices, 1)
    return MeshSpec(best, ("data", "model"))


def _host(t: torch.Tensor) -> torch.Tensor:
    """A tensor's whole value, whatever its layout (a DTensor is gathered)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _on(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` whole on the mesh's device type; meta tensors stay meta."""
    t = _host(t)
    return t if t.is_meta else t.to(mesh.device_type)


BLOCK_LISTS = ("blocks", "enc_blocks", "dec_blocks")


def distribute_module(module: nn.Module, specs: dict, mesh) -> nn.Module:
    """Replace each parameter of ``module`` (in place) by a DTensor
    parameter on ``mesh`` placed by ``specs[name]``, keeping requires_grad.
    Where the mesh has data ranks, each block gathers its weights over the
    data axes when it runs (FSDP): DTensor would otherwise move the
    activations instead, or keep the contraction sharded and make
    batch-sized partial sums."""
    for name, p in list(module.named_parameters()):
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        dt = distribute_tensor(_on(p.detach(), mesh), mesh, placements(specs[name], mesh))
        setattr(owner, attr, nn.Parameter(dt, requires_grad=p.requires_grad))
    data = [mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names) if n in DATA_AXES]
    if any(n > 1 for n in data):
        for list_name in BLOCK_LISTS:
            for block in getattr(module, list_name, ()):
                if not hasattr(block, "_fsdp_params"):
                    block.register_forward_pre_hook(lambda b, args: gather_block(b))
                    block.register_forward_hook(lambda b, args, out: release_block(b))
                block._fsdp_params = [(mod, name, p) for mod in block.modules()
                                      for name, p in mod._parameters.items()
                                      if isinstance(p, DTensor)]
    return module


def distribute_tensors(tensors: dict, specs: dict, mesh) -> dict:
    return {k: distribute_tensor(_on(t, mesh), mesh, placements(specs[k], mesh))
            for k, t in tensors.items()}


def reshard_state(state, mesh_spec: MeshSpec, *, fsdp: bool = True,
                  mesh=None, make: Callable = None):
    """Re-place a ``TrainState`` on ``mesh`` (by default a new mesh of
    ``mesh_spec`` over the world, on the cards): from any source layout,
    host tensors restored from a checkpoint included. The frozen and
    trainable modules take ``param_pspecs`` (their parameters are replaced in
    place), the moments m and v ``opt_state_pspecs``, and the step counter is
    replicated. Returns (state, mesh)."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.steps import TrainState

    if mesh is None:
        mesh = (make or make_mesh)(mesh_spec)
    frozen = distribute_module(state.frozen, param_pspecs(state.frozen, mesh_spec, fsdp),
                               mesh)
    trainable = distribute_module(state.trainable,
                                  param_pspecs(state.trainable, mesh_spec, fsdp), mesh)
    opt = OptState(m=distribute_tensors(state.opt.m, opt_state_pspecs(state.opt.m, mesh_spec),
                                        mesh),
                   v=distribute_tensors(state.opt.v, opt_state_pspecs(state.opt.v, mesh_spec),
                                        mesh),
                   step=distribute_tensor(_on(state.opt.step, mesh), mesh,
                                          [Replicate()] * mesh.ndim))
    return TrainState(frozen, trainable, opt), mesh
