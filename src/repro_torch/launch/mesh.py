"""Production mesh definitions — counterpart of ``repro/launch/mesh.py``,
on torch ``DeviceMesh``.

Functions, not module-level constants: importing this module touches no
process group. Both build on the process group that is already up
(``torch.distributed.init_process_group``, given its address, world size
and rank by the caller) and pick neither the CPU nor gloo on their own:
``device_type`` is "cuda" unless the caller asks for another (the tests
pass "cpu").

Axes:
  pod   — cross-pod data parallelism: gradients all-reduce here.
  data  — in-pod FSDP axis: batch, parameter/optimizer sharding.
  model — TP/EP/SP axis: heads, FFN hidden, experts, vocab, sequence.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``; raises unless the process group
    has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the process group "
                         f"has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda"
                   ) -> DeviceMesh:
    """A (world // model, model) mesh over ("data", "model") on the ranks
    there are (tests, examples; one rank on one card)."""
    world = dist.get_world_size()
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))
