"""The ranks of a torch.distributed group as a (data, rays) grid; port of
nefes_tpu/parallel/mesh.py.

The JAX package lays its devices out as a jax.sharding Mesh with two
axes, "data" (the batch's images) and "rays" (the rays of an image), and
places arrays with NamedShardings. Here each device is one process of a
torch.distributed group, rank d · rays + r at (d, r) of the grid (the
JAX mesh's device order), and the shardings are plain functions on
tensors:

  replicated / replicate   every rank takes rank 0's tensors (broadcast)
  batch_sharding           this rank's slice of the leading axis over
                           "data" (shard_batch: each leaf of a batch)
  batch_ray_sharding       its slice of (images, rays) over (data, rays)
  frame_sharding           its slice of the leading axis over every rank
                           (P(("data", "rays"))); gather_frames undoes it

A card is one rank on cuda:<local rank> with NCCL; on the CPU the ranks
run gloo. Without an initialised group the mesh is the one process, and
every collective is the identity.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, rays) grid and its device."""

    data: int
    rays: int
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.data * self.rays

    @property
    def data_index(self) -> int:
        return self.rank // self.rays

    @property
    def rays_index(self) -> int:
        return self.rank % self.rays


def _device(device, rank: int) -> torch.device:
    """cuda (without an index) -> cuda:<rank on this host's cards>."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


_rank_device: torch.device | None = None


def init_distributed(rank: int, world_size: int, address: str,
                     device="cuda", backend: str | None = None,
                     timeout_s: float = 60.0) -> torch.device:
    """Join the group at address (tcp://host:port) as rank of world_size:
    NCCL for a card and gloo for the CPU unless backend says otherwise
    (gloo also runs several ranks on one card). A rank that does not
    answer fails the collectives after timeout_s. Returns the rank's
    device, which make_mesh takes."""
    global _rank_device
    dev = _device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=address, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device = dev
    return dev


def _group_on() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(data: int | None = None, rays: int | None = None) -> Mesh:
    """The (data, rays) grid of the group's ranks, on the device that
    init_distributed gave this rank (the one process on cuda:0 without
    a group). Defaults: every rank on "data"."""
    n = dist.get_world_size() if _group_on() else 1
    rank = dist.get_rank() if _group_on() else 0
    if data is None and rays is None:
        data, rays = n, 1
    elif data is None:
        data = n // rays
    elif rays is None:
        rays = n // data
    if data * rays != n:
        raise ValueError(f"a {data} x {rays} mesh of {n} ranks")
    dev = _rank_device if _group_on() else _device("cuda", 0)
    return Mesh(data, rays, rank, dev)


# --- placement ---

@torch.no_grad()
def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x on mesh.device holding rank 0's values, on every rank."""
    x = x.to(mesh.device)
    if _group_on():
        dist.broadcast(x, src=0)
    return x


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """rank 0's values on every rank: each tensor of a dict, list or tuple
    (returned on mesh.device), or every parameter and buffer of a module
    (in place)."""
    if isinstance(tree, torch.nn.Module):
        for t in [*tree.parameters(), *tree.buffers()]:
            if _group_on():
                dist.broadcast(t.data, src=0)
        return tree
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return replicated(mesh, tree) if isinstance(tree, torch.Tensor) else tree


def _part(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k)


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's images of x (B, ...): slice data_index of B over
    "data", the same on every rank of a "rays" row."""
    return _part(x, 0, mesh.data_index, mesh.data)


def batch_ray_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of x (B, N_rays, ...): images over "data", rays
    over "rays"."""
    return _part(batch_sharding(mesh, x), 1, mesh.rays_index, mesh.rays)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """A train batch's image-indexed tensors (on mesh.device), split over
    "data"."""
    return {k: (batch_sharding(mesh, v.to(mesh.device))
                if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


def frame_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of x's leading axis over every rank (frames or
    flattened rays); the count must divide the ranks."""
    return _part(x, 0, mesh.rank, mesh.size)


def gather_frames(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The frame_sharding slices of every rank, in rank order."""
    if not _group_on():
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def all_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the ranks (x itself without a group)."""
    if not _group_on():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x / mesh.size
