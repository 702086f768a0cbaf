"""Mesh construction on ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

Functions only, so importing this module touches no process group.
Target hardware: NVIDIA H100 80GB HBM3 nodes of 8 cards joined by
NVLink; tensor parallelism stays inside a node.  Axis semantics:

  pod   — data parallelism across pod-sized groups of nodes
  data  — data parallelism across nodes
  model — tensor parallelism (NVLink, inside a node)

``make_host_mesh`` needs the world already initialised
(``torch.distributed.init_process_group``): the backend follows the
device — NCCL for ``"cuda"``, gloo for ``"cpu"`` — and neither gives way
to the other.
"""
from __future__ import annotations

CARDS_PER_NODE = 8
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _init_mesh(device_type: str, shape, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("init_process_group first (the mesh spans the "
                           "world that is already initialised)")
    want = BACKENDS[device_type]
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"a {device_type!r} mesh needs the {want} "
                           f"backend, the world runs {have}")
    if device_type == "cuda":
        import torch
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """``(32, 8)`` ``("data", "model")`` = 256 cards, or ``(2, 32, 8)``
    ``("pod", "data", "model")`` = 512: the card counts of JAX's two
    meshes, with the model axis one NVLink node."""
    shape = (2, 32, CARDS_PER_NODE) if multi_pod else (32, CARDS_PER_NODE)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh(device_type, shape, axes)


def make_host_mesh(model_axis: int = 1, *, device_type: str = "cuda"):
    """``(world / model_axis, model_axis)`` ``("data", "model")`` over
    the initialised world (tests, one card, CPU ranks)."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 0
    if not n or n % model_axis:
        raise ValueError(f"world of {n} ranks does not split into a model "
                         f"axis of {model_axis}")
    return _init_mesh(device_type, (n // model_axis, model_axis),
                      ("data", "model"))


def dp_axes(mesh):
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


# Roofline constants: NVIDIA H100 80GB HBM3 (SXM5, 700 W), datasheet
PEAK_FLOPS_BF16 = 989e12      # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12              # bytes/s per card
NVLINK_BW = 450e9             # bytes/s per direction per card (NVLink 4,
#                               900 GB/s bidirectional)
HBM_BYTES = 80 * 1024 ** 3    # 80 GiB per card
