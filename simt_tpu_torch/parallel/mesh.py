"""Ranks over ``torch.distributed`` (counterpart of ``simt_tpu/parallel/mesh.py``).

The JAX package shards one global program over a (data, spatial) device mesh. Here
one rank is one process on one device, in a process group that
``initialize_multihost`` joins, and the mesh is the ranks laid out row-major on
(data, spatial), as ``jax.sharding.Mesh`` lays out its devices:

  - ``data``: the global batch is split across the data axis. What the JAX program
    computes globally stays global: BatchNorm's batch statistics
    (``global_batch_stats``, read by ``models/layers.py::BatchNorm2d``), the masked
    means' counts and the SimT anchor (``ops/fused_losses.py``) and the gradients
    (``sync_grads``). Each rank's loss is its local sum over the global count, so the
    global loss is the sum over the ranks and so are the gradients.
  - ``spatial``: the evaluation's eval head splits its output rows across the spatial
    axis (``ops/kernels/eval_fused.py::multiscale_argmax_hist_spatial``); each rank of
    a spatial group runs the whole forward. Training over it (halo exchanges inside
    the convolutions) is ROADMAP A-4b and refused.

Only ``all_reduce`` and ``broadcast`` are used: ``gloo`` runs both on CUDA tensors too,
so two ranks can share one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def world_size() -> int:
    """The process group's size, 1 when none is initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def initialize_multihost(coordinator: str, num_processes: int, process_id: int,
                         device: Union[str, torch.device], *,
                         backend: Optional[str] = None) -> torch.device:
    """Join the process group of ``num_processes`` ranks as rank ``process_id``, at
    ``tcp://<coordinator>`` (host:port; rank 0 listens there). The backend is
    ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU, unless ``backend`` names
    one (``gloo`` lets ranks share one card). Returns this rank's device: the CPU, or
    ``cuda:<rank mod the host's cards>``, which becomes the current CUDA device."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (expected 'cuda' or 'cpu')")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (data, spatial) mesh. ``data_group`` holds the ranks of
    this rank's spatial index (one a data shard), ``spatial_group`` those of its data
    index; each is None when its axis has size 1 (no collective is needed)."""

    data: int
    spatial: int
    rank: int
    data_index: int
    spatial_index: int
    data_group: Optional[dist.ProcessGroup]
    spatial_group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def world(self) -> int:
        return self.data * self.spatial


def make_mesh(data: int, spatial: int = 1, *,
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """The (data, spatial) mesh over the process group's ranks. ``data * spatial``
    must equal the world size (one process a rank: a single process runs 1 x 1).
    Every rank calls it, in the same order as its other group creations. ``device``
    gives the device type; a CUDA rank's device is the current one
    (``initialize_multihost`` sets it)."""
    world = world_size()
    if data * spatial != world:
        raise ValueError(
            f"mesh data={data} spatial={spatial} needs {data * spatial} ranks, one "
            f"process each, but the process group has {world}: launch "
            f"{data * spatial} processes (--coordinator, --num-processes, --process-id), "
            "or set --mesh-data / --mesh-spatial to the process count")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank() if world > 1 else 0
    d_idx, s_idx = divmod(rank, spatial)
    # An axis of size 1 needs no group. new_group is collective over the whole world:
    # every rank creates every group of an axis, in the same order.
    spatial_group = data_group = None
    if spatial > 1:
        groups = ([dist.group.WORLD] if spatial == world else
                  [dist.new_group([d * spatial + s for s in range(spatial)])
                   for d in range(data)])
        spatial_group = groups[d_idx]
    if data > 1:
        groups = ([dist.group.WORLD] if data == world else
                  [dist.new_group([d * spatial + s for d in range(data)])
                   for s in range(spatial)])
        data_group = groups[s_idx]
    return Mesh(data, spatial, rank, d_idx, s_idx, data_group, spatial_group, dev)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's block of a global batch: data index ``r`` of ``n`` takes items
    ``[r*b, (r+1)*b)`` of every array (b = the global batch over ``n``), as the JAX
    package's batch sharding places them; other values pass through."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) > 0:
            if len(v) % mesh.data:
                raise ValueError(f"{k}: batch {len(v)} not divisible by data={mesh.data}")
            b = len(v) // mesh.data
            v = v[mesh.data_index * b:(mesh.data_index + 1) * b]
        out[k] = v
    return out


def _state_tensors(state) -> List[torch.Tensor]:
    """Every tensor of a train state in one fixed order: parameters and buffers of its
    modules, its NTM parameters and every optimizer's state."""
    out: List[torch.Tensor] = []

    def walk(obj):
        if isinstance(obj, nn.Module):
            out.extend(p.data for p in obj.parameters())
            out.extend(obj.buffers())
        elif isinstance(obj, torch.optim.Optimizer):
            for group in obj.param_groups:
                for p in group["params"]:
                    st = obj.state.get(p, {})
                    out.extend(st[k] for k in sorted(st) if torch.is_tensor(st[k]))
        elif isinstance(obj, torch.Tensor):
            out.append(obj.data)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))

    walk(state)
    return out


def replicate_state(state, mesh: Mesh) -> None:
    """Broadcast every parameter, buffer, NTM parameter and optimizer moment of
    ``state`` from rank 0, in place, so that the ranks start equal as the JAX
    package's replicated arrays do. One broadcast a dtype."""
    if mesh.world == 1:
        return
    tensors = _state_tensors(state)
    n = torch.tensor([len(tensors), -len(tensors)], device=mesh.device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    if int(n[0]) != -int(n[1]):
        raise RuntimeError(f"ranks hold train states of {int(n[0])} and {-int(n[1])} "
                           "tensors: they cannot be replicated")
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for dtype in sorted(by_dtype, key=str):
            ts = by_dtype[dtype]
            flat = torch.cat([t.reshape(-1).to(mesh.device) for t in ts])
            dist.broadcast(flat, src=0)
            _unflatten_into(flat, ts)


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()


def sync_grads(params: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]) -> None:
    """Sum the ``.grad`` of ``params`` over the ranks of ``group`` in place, in one
    ``all_reduce`` of their concatenation (a parameter without a gradient is skipped;
    the ranks run one graph, so they skip the same ones)."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    with torch.no_grad():
        _unflatten_into(flat, grads)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks, forward and backward: the gradient of a loss summed
    over the ranks with respect to one rank's operand is the sum of the ranks'
    cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (``t`` itself when None),
    differentiable: the backward sums the cotangents over the ranks."""
    return t if group is None else _AllReduceSum.apply(t, group)


def all_reduce_(t: torch.Tensor, group: Optional[dist.ProcessGroup],
                op: str = "sum") -> torch.Tensor:
    """In-place ``all_reduce`` (``op`` sum, max or min) of a tensor outside autograd;
    a no-op when ``group`` is None. Returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op], group=group)
    return t


def barrier(mesh: Mesh) -> None:
    """Every rank waits here for the others (NCCL on this rank's card)."""
    if mesh.world == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


_BATCH_STATS_GROUP: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def global_batch_stats(group: Optional[dist.ProcessGroup]) -> Iterator[None]:
    """Inside the block, every train-mode ``models/layers.py::BatchNorm2d`` takes its
    batch statistics over the ranks of ``group``, as the JAX program's BatchNorm does
    over its global batch; None (one data shard) leaves them per rank."""
    global _BATCH_STATS_GROUP
    prev, _BATCH_STATS_GROUP = _BATCH_STATS_GROUP, group
    try:
        yield
    finally:
        _BATCH_STATS_GROUP = prev


def batch_stats_group() -> Optional[dist.ProcessGroup]:
    """The group of ``global_batch_stats``' block, None outside one."""
    return _BATCH_STATS_GROUP
