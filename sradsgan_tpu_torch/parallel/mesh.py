"""The data-parallel mesh: one process a device under ``torch.distributed``.

Counterpart of ``sradsgan_tpu/parallel/mesh.py``, whose 1-D ``data`` mesh
splits every batch over the devices of one jitted program, XLA inserting the
gradient sum.  Here each device runs its own process (``torchrun
--nproc_per_node=N``), and the trainers make the program's collectives
explicit, so that W ranks at global batch B take the step one process takes
at batch B, which is also the JAX package's sharded step:

- rank r owns rows ``r, r + W, r + 2W, ...`` of each global batch
  (:func:`shard_batch`; the loader's ``shard_index``/``shard_count`` give
  the same rows of the same shuffled order);
- draws made for the batch (the penalty's interpolation weights, the
  diffusion ``t`` and noise) are made for the global batch from the same
  seeded generator on every rank, and each rank takes its rows;
- every loss is a mean over the local rows, so the mean over ranks of the
  local gradients (:func:`all_reduce_grads_`) is the global batch's;
- BatchNorm in train mode normalizes by the global batch's statistics
  (``nn/norm.py``), through :func:`all_reduce_sum`, which is differentiable
  to any order: the WGAN-GP differentiates the discriminator's gradient.

The gradient all-reduce is explicit rather than the
``DistributedDataParallel`` wrapper, which does not support the
``torch.autograd.grad`` the trainers and the penalty take gradients with.
NCCL serves CUDA devices and gloo the CPU.  The JAX package's
``shard_stacked_batches`` (the ``lax.scan`` feed, not ported) and
``pad_batch_to_devices`` (no caller here: the validation sweep of each rank
takes its rows as they come and sums them) have no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

# The largest flat buffer a collective over many tensors moves at once.
BUCKET_BYTES = 25 * 2 ** 20

# The most recently created mesh: read by the BatchNorm layers, which have
# no mesh argument (the JAX package's modules read its active mesh too).
_ACTIVE_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data mesh: its ``rank`` of ``world``, its
    ``device``, and the process group (None for one process without
    ``torch.distributed``, where every collective is the identity)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes files and prints results."""
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank (nothing to wait for without a group)."""
        if self.group is None:
            return
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(self.group, device_ids=[self.device.index])
        else:
            dist.barrier(self.group)


def create_mesh(num_devices: int = -1, device: torch.device | str = "cuda",
                *, rank: Optional[int] = None, world: Optional[int] = None,
                init_method: Optional[str] = None,
                backend: Optional[str] = None) -> Mesh:
    """The mesh of this process, made the active one.

    - Under a launcher (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
      ``LOCAL_RANK`` and the store's address) it joins the launcher's group;
    - with ``rank``, ``world`` and ``init_method`` (a ``file://`` or
      ``tcp://`` store) it joins that group;
    - where a group already exists in this process it joins that one;
    - otherwise it is a world of one with no group.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU unless
    ``backend`` names one.  In a group, a CUDA device without an index
    becomes ``cuda:LOCAL_RANK`` (the rank where no launcher set it) and is
    made current; without a group ``device`` stays as it is given.
    ``num_devices`` > 0 must equal the world size; -1 takes whatever was
    launched."""
    global _ACTIVE_MESH
    device = torch.device(device)
    launched = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    elif init_method is None and launched:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    elif init_method is None:
        rank, world = 0, 1
    elif rank is None or world is None:
        raise ValueError("create_mesh: init_method needs rank and world")
    if num_devices and num_devices > 0 and num_devices != world:
        raise ValueError(
            f"num_devices={num_devices} but {world} process(es) were "
            "launched; start one process a device (torchrun "
            f"--nproc_per_node={num_devices}) or set num_devices to -1")
    in_group = dist.is_initialized() or init_method is not None or launched
    if device.type == "cuda" and in_group:
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    group = None
    if dist.is_initialized():
        group = dist.group.WORLD
    elif in_group:
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
        group = dist.group.WORLD
    mesh = Mesh(rank, world, device, group)
    _ACTIVE_MESH = mesh
    return mesh


def active_mesh() -> Optional[Mesh]:
    """The last mesh :func:`create_mesh` built (None before the first)."""
    return _ACTIVE_MESH


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows ``rank::world`` of a global batch: a dict of arrays,
    tensors and lists (``path``), or one array or tensor.  A batch that the
    world size does not divide raises: the ranks' steps would differ in
    size, and so would their share of each mean."""
    if mesh.world == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    n = len(batch)
    if n % mesh.world:
        raise ValueError(
            f"a global batch of {n} does not split over {mesh.world} ranks; "
            "choose a batch size that the number of processes divides")
    return batch[mesh.rank::mesh.world]


def all_reduce_sum(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks, differentiable to any order:
    the library's ``all_reduce`` is its own backward."""
    if mesh.group is None:
        return tensor
    # its FutureWarning names the private ``_functional_collectives`` as the
    # successor; this public call is the one documented as differentiable
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return dist_nn.all_reduce(tensor, group=mesh.group)


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The tensors in runs of one dtype and device, each at most
    BUCKET_BYTES (or one larger tensor)."""
    runs: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        last = runs[-1] if runs else None
        if (last is None or t.dtype != last[0].dtype
                or t.device != last[0].device
                or size + t.numel() * t.element_size() > BUCKET_BYTES):
            runs.append([])
            size = 0
        runs[-1].append(t)
        size += t.numel() * t.element_size()
    return runs


def _flat_collective(tensors: Iterable[torch.Tensor], collective) -> None:
    """Apply the in-place ``collective`` to the tensors through a few flat
    buffers, and copy the results back."""
    for bucket in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def all_reduce_grads_(params: Iterable[torch.nn.Parameter],
                      mesh: Mesh) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks."""
    if mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]

    def mean(flat):
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
    with torch.no_grad():
        _flat_collective(grads, mean)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Make every rank's parameters and buffers rank 0's."""
    if mesh.group is not None:
        with torch.no_grad():
            _flat_collective(
                list(module.parameters()) + list(module.buffers()),
                lambda flat: dist.broadcast(flat, 0, group=mesh.group))
    return module


def all_reduce_sums(values: Iterable[Any], mesh: Mesh) -> torch.Tensor:
    """The sums over the ranks of a few numbers (floats or 0-dim tensors)
    as one float64 vector on the mesh's device: one collective for all,
    without waiting for the device.  A mean over the ranks divides by
    ``mesh.world``."""
    flat = torch.stack([torch.as_tensor(v, device=mesh.device).detach()
                        .reshape(()).to(torch.float64) for v in values])
    if mesh.group is not None:
        dist.all_reduce(flat, group=mesh.group)
    return flat
