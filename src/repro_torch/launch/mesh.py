"""Mesh construction (``repro.launch.mesh``) as ``torch.distributed``
``DeviceMesh``es.

Defined as FUNCTIONS (never module-level state), so importing this module
starts no process group: a caller picks the backend when it asks for a
mesh.

- ``make_host_mesh(device)``: the (1, 1) ("data", "model") mesh of one
  process, over a world-1 process group (NCCL on ``cuda``, gloo on
  ``cpu``), started on an in-process store when none exists.
- ``make_production_mesh(multi_pod)``: the JAX package's (16, 16)
  ("data", "model") or (2, 16, 16) ("pod", "data", "model") shapes over
  PyTorch's ``"fake"`` backend, whose collectives move nothing: it is
  for the dry-run only, with parameters and activations on the ``meta``
  device. The shapes are the reference's, so the specs compare one for
  one. On H100s the layout has a property the TPU torus does not: an
  NVLink domain holds 8 GPUs, so a 16-way ``model`` axis spans two of
  them and its collectives cross the slower inter-node network.
- ``make_mesh(shape, axes, device)``: any shape over the default group
  already started (the CPU parity tests' 4 gloo ranks).
- ``MeshShape``: a device-free mesh (the axis names and sizes alone), as
  ``jax.sharding.AbstractMesh``: the specs accept it.

The constants are an H100 SXM's (per GPU), from NVIDIA's H100 Tensor
Core GPU data sheet: dense bf16 tensor-core peak, HBM3 bandwidth, and
NVLink 4's 900 GB/s of total bandwidth, 450 GB/s in each direction.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

# H100 SXM hardware constants for the roofline (per GPU; data sheet)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense
HBM_BW = 3.35e12                # B/s
NVLINK_BW = 450e9               # B/s per direction

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


class MeshShape(NamedTuple):
    """A mesh without devices: ``shape`` and ``mesh_dim_names``, read by
    the specs as a ``DeviceMesh`` is."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def _backend(device) -> str:
    import torch
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default process group (which must hold exactly that many)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks; the "
                         f"process group has {dist.get_world_size()}")
    dtype = torch.device(device).type
    if dtype == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(dtype, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(device="cuda"):
    """The (1, 1) ("data", "model") mesh of this process. With no process
    group it starts one of world 1 (NCCL on ``cuda``, gloo on ``cpu``)
    on an in-process store; ``destroy_host_group`` ends it."""
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group(_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), device)


def destroy_host_group() -> None:
    """End the default process group, if one was started."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the ``"fake"`` backend: (16, 16) = 256
    ranks ("data", "model"); multi-pod (2, 16, 16) = 512 ranks ("pod",
    "data", "model"). A process has one default group, so an earlier
    one is destroyed first. Tensors on it live on the ``meta`` device."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    # the fake backend registers itself when its store is imported
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)
