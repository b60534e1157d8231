"""Production mesh factory, ported from ``repro.launch.mesh``.

A function, not a module-level constant: importing this module builds no
process group.  The mesh covers the whole world of the default process
group, which the caller starts (torchrun across the nodes, or
``torch.distributed.init_process_group`` with an address, a world size and
a rank); the dry run starts a fake group of 256 or 512 ranks.
"""

from __future__ import annotations

import os

import torch.distributed as dist


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """16x16 = 256 devices per pod; 2x16x16 = 512 across two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group's world.

    Raises ``ValueError`` naming the world size it needs when the world is
    not 256 (512 with ``multi_pod``) ranks, as the reference's
    ``jax.make_mesh`` fails without 256 devices.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_shape(multi_pod)
    need = 1
    for n in shape:
        need *= n
    # a group already started, else the one torchrun describes (init_device_mesh starts it)
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise ValueError(
            f"the {'multi-pod' if multi_pod else 'single-pod'} production mesh {shape} needs a world of "
            f"{need} ranks, one per device (launch with torchrun across the nodes); this world has {world}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=names)
