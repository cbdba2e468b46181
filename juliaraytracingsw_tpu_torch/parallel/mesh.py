"""Process meshes over ``torch.distributed`` (port of ``parallel/mesh.py``).

The reference runs one process over many devices and places arrays with
``NamedSharding``. The port runs one process per device: each rank holds
only its own shard and every cross-device exchange is a
``torch.distributed`` collective of the mesh's process group (NCCL for a
mesh on the card, gloo for one on the CPU; the backend follows the mesh's
device and nothing stands in for another).

Layouts, with ``P = mesh.size`` ranks along the one axis ``'packets'``:

- a packet batch: the rank's contiguous ``N/P`` block of every leaf, the
  split of ``PartitionSpec('packets')`` (``shard_packets``; the inverse,
  ``gather_packets``, is what ``np.asarray`` of a sharded array gives);
- a physical field ``(C, ny, nx)``: the rank's ``(C, ny/P, nx)`` y-slab;
- a spectral state ``(C, nl, nkr_pad)``: the rank's ``(C, nl, nkr_pad/P)``
  column block (``parallel/fft``).

Complex tensors cross the wire as their ``torch.view_as_real`` float32
views. ``mesh.counts`` counts each collective and its bytes sent by this
rank.
"""
from __future__ import annotations

import collections
import os
import tempfile
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..rays.packets import Packets

__all__ = ["Mesh", "Sharding", "make_mesh", "shard_packets", "gather_packets",
           "replicate", "packet_sharding", "init_distributed", "all_to_all", "all_gather",
           "all_gather_start", "all_reduce_finite"]

PACKET_AXIS = "packets"


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device, rank: int) -> torch.device:
    """``cuda:<rank % device_count>`` for a mesh on the card, else the CPU;
    no card means failure, never a run on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh on the card needs a CUDA device "
                           "(torch.cuda.is_available() is false); ask for device='cpu'")
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass(frozen=True)
class Mesh:
    """One 1-D axis of ``size`` ranks: this process's ``rank``, the
    process ``group`` and the ``device`` its shards live on."""

    rank: int
    size: int
    group: object
    device: torch.device
    axis: str = PACKET_AXIS
    counts: collections.Counter = field(default_factory=collections.Counter, compare=False)

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis: self.size}


@dataclass(frozen=True)
class Sharding:
    """A layout on a mesh: ``dim`` is split in ``mesh.size`` contiguous
    blocks, the rank holding block ``mesh.rank``; ``dim=None`` replicates."""

    mesh: Mesh
    dim: int | None

    def local(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global tensor (``ValueError`` if the
        dimension does not split evenly)."""
        if self.dim is None:
            return a
        n, p = a.shape[self.dim], self.mesh.size
        if n % p:
            raise ValueError(f"dimension {self.dim} of size {n} not divisible by mesh "
                             f"size {p}")
        return a.narrow(self.dim, self.mesh.rank * (n // p), n // p)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: torch.device | str = "cuda") -> int:
    """Bring up the default process group of a job of ``num_processes``
    processes (one per device) -> this process's rank.

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://``); None
    reads ``MASTER_ADDR``/``MASTER_PORT`` (``env://``). The backend is NCCL
    for ``device='cuda'`` (each rank then uses ``cuda:<rank %
    device_count>`` as its current device) and gloo for the CPU. A
    single-process run, or one whose group is up already, is a no-op."""
    if num_processes is not None and num_processes <= 1:
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    dev = torch.device(device)
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(_backend(dev), init_method=init, world_size=num_processes,
                            rank=process_id)
    rank = dist.get_rank()
    if dev.type == "cuda":
        torch.cuda.set_device(_rank_device(dev, rank))
    return rank


def make_mesh(n_devices: int | None = None, axis: str = PACKET_AXIS, *,
              device: torch.device | str = "cuda") -> Mesh | None:
    """The mesh of the default process group, on ``device`` ('cuda': the
    rank's card; 'cpu').

    Without a default group, one of world size 1 is brought up here (a
    ``FileStore`` in a temporary directory), so the collectives always run
    through ``torch.distributed``. ``n_devices`` smaller than the world
    makes a mesh of the first ``n_devices`` ranks, as the reference's
    ``make_mesh(n)`` takes the first n devices: every rank of the world
    must call it (``dist.new_group``), and the ranks outside get None."""
    dev = torch.device(device)
    if not dist.is_initialized():
        _rank_device(dev, 0)   # no card: fail before any group exists
        store_dir = tempfile.mkdtemp(prefix="jrsw_mesh_")
        dist.init_process_group(_backend(dev),
                                store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                                rank=0, world_size=1)
    backend = dist.get_backend()
    if backend != _backend(dev):
        raise ValueError(f"the default process group runs {backend}, but a mesh on "
                         f"{dev.type} needs {_backend(dev)}")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices}: the job has {world} processes")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(rank=rank, size=n, group=group, device=_rank_device(dev, rank), axis=axis)


def packet_sharding(mesh: Mesh) -> Sharding:
    """A packet leaf split along its only axis."""
    return Sharding(mesh, 0)


def shard_packets(packets: Packets, mesh: Mesh) -> Packets:
    """The rank's contiguous ``N/P`` block of every leaf of a global
    ensemble, on the mesh's device (``ValueError`` unless ``N % P == 0``)."""
    if packets.n % mesh.size:
        raise ValueError(f"{packets.n} packets not divisible by mesh size {mesh.size}")
    sh = packet_sharding(mesh)
    return Packets(*(sh.local(a).to(mesh.device).contiguous() for a in packets))


def _wire(a: torch.Tensor) -> torch.Tensor:
    """The float view of a tensor that crosses the wire."""
    return torch.view_as_real(a) if a.is_complex() else a


def _unwire(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(a) if like.is_complex() else a


def all_gather_start(a: torch.Tensor, dim: int, mesh: Mesh):
    """Start gathering every rank's ``a`` (the list form of
    ``all_gather``, which NCCL and gloo both take) -> a function that
    waits for it and returns the parts concatenated along ``dim`` in rank
    order. On the card the wait orders the current stream after the
    collective, so work enqueued in between overlaps it."""
    src = _wire(a.contiguous())
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    mesh.counts["all_gather"] += 1
    mesh.counts["all_gather_bytes"] += src.numel() * src.element_size() * (mesh.size - 1)
    work = dist.all_gather(parts, src, group=mesh.group, async_op=True)

    def finish() -> torch.Tensor:
        work.wait()
        return torch.cat([_unwire(p, a) for p in parts], dim=dim % a.ndim)

    return finish


def all_gather(a: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``a`` concatenated along ``dim`` in rank order."""
    return all_gather_start(a, dim, mesh)()


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, mesh: Mesh) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``: split
    ``x`` along ``split_dim`` in ``P`` chunks, send chunk j to rank j, and
    concatenate what arrives along ``concat_dim`` in source-rank order. The
    split axis goes to the front in one contiguous copy, so
    ``all_to_all_single`` exchanges whole chunks."""
    p = mesh.size
    s, c = split_dim % x.ndim, concat_dim % x.ndim
    if x.shape[s] % p:
        raise ValueError(f"dimension {s} of size {x.shape[s]} not divisible by {p}")
    xr = _wire(x)
    chunks = xr.unflatten(s, (p, x.shape[s] // p)).movedim(s, 0).contiguous()
    out = torch.empty_like(chunks)
    mesh.counts["all_to_all"] += 1
    mesh.counts["all_to_all_bytes"] += (chunks.numel() * chunks.element_size() // p) * (p - 1)
    dist.all_to_all_single(out, chunks, group=mesh.group)
    # out[i] is rank i's chunk: place the source axis just before the
    # concat axis and merge the two
    return _unwire(out.movedim(0, c).flatten(c, c + 1), x)


def gather_packets(packets: Packets, mesh: Mesh) -> Packets:
    """The global ensemble on every rank, the ranks' blocks in order: the
    inverse of ``shard_packets``."""
    rows = all_gather(torch.stack(list(packets)), 1, mesh)
    return Packets(*rows.unbind(0))


def replicate(tree, mesh: Mesh):
    """Rank 0's value of every tensor leaf of a tree (NamedTuples, tuples,
    lists, dicts), on the mesh's device on every rank."""
    if isinstance(tree, torch.Tensor):
        out = _wire(tree.detach().to(mesh.device).contiguous().clone())
        mesh.counts["broadcast"] += 1
        # a mesh is the job's first ``size`` ranks: its rank 0 is global rank 0
        dist.broadcast(out, src=0, group=mesh.group)
        return _unwire(out, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(a, mesh) for a in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(a, mesh) for a in tree)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return tree


def all_reduce_finite(mesh: Mesh, *tensors: torch.Tensor) -> bool:
    """True iff every tensor is finite on every rank. The flag is reduced
    over the mesh before anyone acts on it, so all ranks raise together
    and none is left waiting in a collective."""
    ok = torch.ones((), dtype=torch.int32, device=mesh.device)
    for t in tensors:
        ok = ok * torch.isfinite(_wire(t)).all().to(torch.int32)
    mesh.counts["all_reduce"] += 1
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(ok)
