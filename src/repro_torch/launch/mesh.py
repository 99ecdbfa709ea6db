"""Production meshes as ``torch.distributed`` ``DeviceMesh``es.

Counterpart of ``repro/launch/mesh.py``: the same axis names and shapes,
(16, 16) ``("data", "model")`` on one pod and (2, 16, 16) ``("pod", "data",
"model")`` on two. A ``DeviceMesh`` needs an initialised default process
group whose world holds its ranks: NCCL on the cards, gloo or the fake
group (``launch/dryrun.py``) on the host. ``device_type`` is ``"cuda"`` on
the cards and ``"cpu"`` on the host. All constructors are functions, so
importing this module touches no process group.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.config import MULTI_POD, SINGLE_POD, MeshSpec

TIER_SHAPE = (16, 16)   # each tier of the two-mesh mode is one pod


def mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_mesh(spec: MeshSpec, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of the whole world, whose size must be ``spec.n_devices``."""
    return init_device_mesh(device_type, spec.shape, mesh_dim_names=spec.axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    return make_mesh(mesh_spec(multi_pod=multi_pod), device_type)


def make_tier_meshes(device_type: str = "cuda") -> Tuple[DeviceMesh, DeviceMesh]:
    """Two-mesh tier mode (the paper's client and server as separate
    programs): the world's first half of ranks is the storage (COS) mesh,
    the second half the compute mesh, each 16 x 16 ``("data", "model")``.
    The world must hold 512 ranks. Every rank builds both meshes; a rank has
    a coordinate only in its own (``get_coordinate()`` is None in the
    other), and runs only its own tier's program."""
    world = torch.distributed.get_world_size()
    n = TIER_SHAPE[0] * TIER_SHAPE[1]
    if world != 2 * n:
        raise ValueError(f"the tier meshes need a world of {2 * n} ranks, got {world}")
    ranks = torch.arange(world)
    return tuple(DeviceMesh(device_type, ranks[i * n:(i + 1) * n].reshape(TIER_SHAPE),
                            mesh_dim_names=("data", "model")) for i in range(2))


def small_mesh_spec(n_data: int = 2, n_model: int = 2, pod: int = 0) -> MeshSpec:
    if pod:
        return MeshSpec((pod, n_data, n_model), ("pod", "data", "model"))
    return MeshSpec((n_data, n_model), ("data", "model"))


def make_small_mesh(n_data: int = 2, n_model: int = 2, pod: int = 0,
                    device_type: str = "cpu") -> DeviceMesh:
    """Reduced mesh for tests (gloo ranks, or one NCCL rank at (1, 1))."""
    return make_mesh(small_mesh_spec(n_data, n_model, pod), device_type)
