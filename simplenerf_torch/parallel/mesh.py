"""Ray-sharded data parallelism on torch.distributed.

Port of simplenerf_tpu/parallel/mesh.py. A 1-D "mesh" over the processes of
one job: every process holds the whole model, its Adam state, the scene's
ray cache and common data (replicated), and renders its contiguous block
of each step's global ray batch (sharded on the ray axis). Every process
draws the same global batch from the same seeds and keeps its rows
(`process_local_rows`), so the job computes the one-process step: the loss
stack divides each rank's sums by the whole batch's counts
(`losses.common.global_count`), and one `all_reduce_sum` of the flat
gradient adds the ranks' shares, as XLA's psum does in the JAX package.

One process per card (NCCL), launched by `torchrun`:

    device = initialize_distributed()
    mesh = make_mesh()
    runner.start_training(cfg, db, out, device=device, mesh=mesh)

`batch_sharding` and `replicated_sharding`, the JAX package's XLA sharding
objects, have no counterpart here: a rank's tensors are plain local
tensors, sliced by `shard_ray_batch` and kept equal by `replicate`.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

from simplenerf_torch.device import DeviceLike, resolve_device

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# Collectives fail after this, so a dead rank fails its peers instead of
# hanging them.
TIMEOUT = timedelta(minutes=5)
# The device initialize_distributed bound this rank to: make_mesh's default.
_RANK_DEVICE: Optional[torch.device] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The job's 1-D ray axis: its process group (None without
    torch.distributed), this process's rank, the world size and the device
    this rank's tensors live on."""

    group: Any
    rank: int
    world_size: int
    device: torch.device


def initialize_distributed(device: DeviceLike = None,
                           backend: Optional[str] = None) -> Optional[torch.device]:
    """Join the job that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); returns this rank's
    device, or None, doing nothing, without that environment.

    On the card each rank takes cuda:LOCAL_RANK (unless `device` names an
    index) and NCCL; `device="cpu"` takes gloo. `backend` overrides the
    choice (gloo also reduces CUDA tensors, so two gloo ranks can share one
    card). Collectives time out after TIMEOUT. Safe to call twice.
    """
    global _RANK_DEVICE
    env = os.environ
    if not all(k in env for k in _ENV):
        return None
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method="env://",
            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
            timeout=TIMEOUT,
        )
    _RANK_DEVICE = dev
    return dev


def make_mesh(group=None, device: DeviceLike = None) -> Mesh:
    """The 1-D mesh over `group` (default: every process of the job; a
    world of one without torch.distributed). `device` defaults to the
    device `initialize_distributed` bound this rank to, whatever the
    backend; in a job joined otherwise, to the current card (the CPU only
    when asked for)."""
    if not dist.is_initialized():
        return Mesh(None, 0, 1, resolve_device(device))
    group = group or dist.group.WORLD
    if device is None:
        device = _RANK_DEVICE or (
            torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), resolve_device(device))


def process_local_rows(n_global: int, mesh: Optional[Mesh]) -> slice:
    """The contiguous block [r n / W, (r + 1) n / W) of a globally drawn
    batch of `n_global` rays that rank r renders. An indivisible batch
    raises, as the JAX package's sharding refuses it."""
    world = 1 if mesh is None else mesh.world_size
    if n_global % world:
        raise ValueError(f"a batch of {n_global} rays does not split over {world} ranks")
    per = n_global // world
    start = per * (0 if mesh is None else mesh.rank)
    return slice(start, start + per)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_ray_batch(mesh: Optional[Mesh], tree):
    """This rank's rows of every array in `tree` (tensors or numpy arrays,
    in dicts, lists or tuples; None kept): the `process_local_rows` slice
    of each leading axis."""
    return _tree_map(lambda x: x[process_local_rows(x.shape[0], mesh)], tree)


@torch.no_grad()
def replicate(mesh: Optional[Mesh], tree):
    """Rank 0's values in every rank: each tensor of `tree` is overwritten
    in place by a broadcast from rank 0, each Python int is broadcast and
    returned. Returns the tree; a no-op without a mesh or in a world of
    one."""
    if mesh is None or mesh.world_size == 1:
        return tree
    src = dist.get_global_rank(mesh.group, 0)

    def bcast(x):
        if isinstance(x, int):
            t = torch.tensor(x, dtype=torch.int64, device=mesh.device)
            dist.broadcast(t, src=src, group=mesh.group)
            return int(t)
        dist.broadcast(x.detach(), src=src, group=mesh.group)
        return x

    return _tree_map(bcast, tree)


@torch.no_grad()
def all_reduce_sum(mesh: Optional[Mesh], tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` summed over the mesh's ranks, in place; untouched without a
    mesh or in a world of one."""
    if mesh is not None and mesh.world_size > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group)
    return tensor
