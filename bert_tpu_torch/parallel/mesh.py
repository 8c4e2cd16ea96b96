"""Device-mesh construction.

Counterpart of ``bert_tpu/parallel/mesh.py``: a 2-D logical mesh with a
``data`` axis (data parallelism, batch rows) and a ``model`` axis (tensor
parallelism, Megatron weight shards). In PyTorch's idiom the mesh is a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
over one process per rank: every rank runs the same program, as every
process of a bert_tpu multi-host run does, and the mesh's two subgroups
carry the collectives. Rank r sits at (r // tp, r % tp), so the ranks of
one model group are adjacent, as bert_tpu keeps its model axis on
neighbouring chips.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_devices: Optional[int] = None,
    tp: int = 1,
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
    device_type: Optional[str] = None,
):
    """Build a (data, model) mesh over ``n_devices`` ranks (default: every
    rank of the process group, formed here from torchrun's environment
    when it is not formed yet).

    ``tp`` is the model-axis size; the data axis takes the rest.
    ``device_type`` is ``"cuda"`` (the default) or ``"cpu"``; each rank
    computes on :func:`rank_device`.
    """
    from torch.distributed.device_mesh import init_device_mesh

    from .multihost import init_distributed

    device_type = device_type or "cuda"
    if not dist.is_initialized():
        init_distributed(device_type=device_type)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices but only "
                         f"{world} are available")
    if n_devices != world:
        raise ValueError(f"a mesh spans every rank of the process group: "
                         f"requested {n_devices} of {world}")
    if n_devices % tp != 0:
        raise ValueError(f"n_devices {n_devices} not divisible by tp {tp}")
    return init_device_mesh(device_type, (n_devices // tp, tp),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 for a mesh without it, or no
    mesh), as bert_tpu reads ``mesh.shape.get(axis, 1)``."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without it)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def local_rows(mesh, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` rows: the ``data`` axis
    cuts it into dp equal shards, in rank order (all of it off a mesh)."""
    dp = axis_size(mesh, DATA_AXIS)
    if batch % dp:
        raise ValueError(
            f"batch {batch} not divisible by data-parallel degree {dp}"
        )
    per = batch // dp
    d = axis_index(mesh, DATA_AXIS)
    return slice(d * per, (d + 1) * per)


def axis_group(mesh, axis: str):
    """The process group of ``axis``, or None where it has one rank (no
    collective to run)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def rank_device(mesh) -> torch.device:
    """The device this rank computes on: the CPU for a CPU mesh, else
    ``cuda:{local_rank % device_count}`` (several ranks share a card when
    there are more ranks than cards on the host)."""
    from .multihost import local_rank_and_size

    if mesh.device_type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    return torch.device("cuda", local_rank_and_size()[0] % n)
