"""Device meshes and their collectives (port of vslam_tpu/parallel/mesh.py).

JAX runs ``shard_map`` in one program: the mesh is a set of devices and
``psum`` / ``psum_scatter`` / ``all_gather`` are collectives inside it.
The port keeps that single-controller model: a :class:`Mesh` is an ordered
list of this process's shard devices, plus an optional process group
whose processes each hold their own shards. The sharded BA
(vslam_torch/ops/schur.py) loops over the shards in the Python control
flow that drives the LM; launches on distinct cards are asynchronous, so
the shards' work overlaps. The collectives are explicit reductions here:
the partial tensors of this process's shards are summed in shard order,
then, with a process group, ``dist.all_reduce`` / ``all_gather`` join the
processes (gloo on the CPU, NCCL across cards).

Shards may share a device ("virtual" shards, e.g. ``["cpu"] * 8`` as the
JAX tests' 8 virtual CPU devices, or ``["cuda:0"] * 4`` on one card): the
math is the same, only nothing runs in parallel.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


class Mesh:
    """The shards of a sharded solve: this process's `devices` (one shard
    each, in order) and, for a multi-process mesh, the process `group`;
    shard g of the whole mesh is local shard g - rank x len(devices)."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1

    @property
    def size(self) -> int:
        """Shards in the whole mesh (every process)."""
        return len(self.devices) * self.world

    @property
    def local(self) -> list:
        """(global shard index, device) of each shard of this process."""
        n = len(self.devices)
        return [(self.rank * n + j, d) for j, d in enumerate(self.devices)]

    def psum(self, parts: list) -> torch.Tensor:
        """Sum one partial per local shard (then over the processes) onto
        the first device: JAX's psum, replicated there."""
        d0 = self.devices[0]
        total = parts[0].to(d0)
        for x in parts[1:]:
            total = total + x.to(d0)
        if self.group is not None:
            total = total.clone()  # all_reduce writes in place
            dist.all_reduce(total, group=self.group)
        return total

    def psum_scatter(self, parts: list, dim: int) -> list:
        """One full-width partial per local shard -> per local shard, its
        chunk g of `dim` (of size / mesh size) summed over every shard, on
        its device: JAX's psum_scatter(tiled=True)."""
        n = parts[0].shape[dim] // self.size
        if self.group is not None:
            total = self.psum(parts)
            return [total.narrow(dim, g * n, n).to(dev) for g, dev in self.local]
        out = []
        for g, dev in self.local:
            acc = parts[0].narrow(dim, g * n, n).to(dev)
            for x in parts[1:]:
                acc = acc + x.narrow(dim, g * n, n).to(dev)
            out.append(acc)
        return out

    def all_gather(self, parts: list) -> torch.Tensor:
        """Concatenate one block per shard, in shard order, along dim 0 on
        the first device: JAX's all_gather(tiled=True)."""
        d0 = self.devices[0]
        local = torch.cat([x.to(d0) for x in parts])
        if self.group is None:
            return local
        bufs = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(bufs, local, group=self.group)
        return torch.cat(bufs)


def make_mesh(n_devices: int | None = None, *, devices=None, device="cuda", group=None) -> Mesh:
    """A mesh of `n_devices` shards. `devices` lists them explicitly (e.g.
    ``["cuda:0"] * 4``: four virtual shards on one card). Otherwise, on
    ``device="cpu"`` the shards are virtual shards on the CPU (default 1);
    on CUDA they take distinct cards (default: every visible card), raising
    if there are fewer. With a process `group` the shards are this
    process's own (default 1; on CUDA its card is rank modulo the cards)."""
    if devices is not None:
        devs = list(devices)[:n_devices] if n_devices else list(devices)
        return Mesh(devs, group=group)
    dev = torch.device(device)
    if dev.type == "cpu" or group is not None:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", dist.get_rank(group) % torch.cuda.device_count())
        return Mesh([dev] * (n_devices or 1), group=group)
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"a mesh of {n} CUDA devices needs {n} cards; {count} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], group=group)


def initialize_distributed(
    coordinator: str | None = None, num_processes: int | None = None,
    process_id: int | None = None, backend: str | None = None, timeout_s: float | None = None,
):
    """Multi-process runtime init (call once per process before make_mesh):
    ``torch.distributed`` over TCP at `coordinator` ("host:port"), gloo
    unless `backend` says otherwise (NCCL for CUDA meshes, one card per
    process). Under NCCL the process's card (rank modulo the cards) is made
    current and named to the group before the group is made, so each rank
    opens its communicator on its own card. `timeout_s` bounds every
    collective (a rank that never joins fails the others instead of
    hanging them). Returns the process group, or None when single-process."""
    if not num_processes or num_processes <= 1:
        return None
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    dist.init_process_group(
        backend or "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, **kw,
    )
    return dist.group.WORLD
