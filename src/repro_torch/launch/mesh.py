"""Meshes of the port and the process group under them.

Port of ``repro.launch.mesh`` on ``torch.distributed``: functions, not
module-level constants, so importing this module starts no process
group.

``process_group(device)`` joins the default group once: NCCL for
``cuda``, gloo for ``cpu``.  Under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` set) it joins the launcher's group, each
process on card ``LOCAL_RANK``; otherwise it forms a one-rank group in
process.  The meshes then take the world as it is:
``make_production_mesh`` the reference's (16, 16) ("data", "model") or
(2, 16, 16) ("pod", "data", "model") and nothing else, and
``make_host_mesh`` (world, 1) ("data", "model"), (1, 1) on one card.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.models.common import DeviceLike, resolve_device

#: how long a collective may wait for its peers before the group fails
TIMEOUT = datetime.timedelta(minutes=10)


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh: 16 x 16 = 256 ranks a
    pod; 2 pods = 512 multi-pod."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def process_group(device: DeviceLike = None) -> torch.device:
    """Join (or form) the default process group for ``device`` (``cuda``
    unless the caller names another) and return the device this rank
    runs on.  Raises without a card when ``cuda`` is asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=TIMEOUT)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=TIMEOUT)
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh over the default group, which
    must hold exactly its 256 (or 512 with ``multi_pod``) ranks."""
    shape, names = production_shape(multi_pod)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} needs {need} "
            f"ranks; the world has {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_host_mesh() -> DeviceMesh:
    """Every rank of the default group on the data axis: (world, 1)."""
    return init_device_mesh(_device_type(), (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def data_size(mesh) -> int:
    """Ranks along the data axes: the data-parallel degree."""
    names = list(mesh.mesh_dim_names)
    return math.prod(mesh.size(names.index(a)) for a in data_axes(mesh))
