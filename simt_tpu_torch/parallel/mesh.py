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
  - ``spatial``: every image is split by height. At each layer an activation of global
    height H is cut into blocks of ceil(H / S) rows over the S ranks of a spatial group
    (``row_block``; the last blocks may be shorter or empty, GSPMD's layout of an uneven
    dimension). Inside ``spatial_rows`` the trunk's convolutions and pools fetch the
    rows of their window that other ranks own (``fetch_rows``) and the model gathers its
    stride-8 logits (``gather_rows``; DeepLabv3 instead upsamples its own band of
    input-size rows); each rank computes the loss on its band of label rows, and BatchNorm, the losses' counts and the gradients reduce over every rank of
    the mesh (``Mesh.group``). The evaluation instead splits only its eval head's output
    rows (``ops/kernels/eval_fused.py::multiscale_argmax_hist_spatial``): each rank of a
    spatial group runs the whole forward there.

Only ``all_reduce`` and ``broadcast`` are used: ``gloo`` runs both on CUDA tensors too,
so two ranks can share one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

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

    def rows(self, height: int) -> "RowSharding":
        """This rank's ``RowSharding`` for images of global ``height`` (spatial > 1)."""
        return RowSharding(self.spatial_group, self.spatial_index, self.spatial, height)

    @property
    def group(self) -> Optional[dist.ProcessGroup]:
        """Every rank of the mesh (None for one): what the global batch's statistics,
        counts and gradients reduce over."""
        return dist.group.WORLD if self.world > 1 else None


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


def row_block(height: int, index: int, size: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of an axis of ``height`` rows that spatial index ``index`` of
    ``size`` owns: blocks of ceil(height / size) rows, the last ones shorter or empty."""
    c = -(-height // size)
    lo = min(index * c, height)
    return lo, min(lo + c, height)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's block of a global batch, as the JAX package's ``P(data, spatial)``
    places it: data index ``r`` of ``n`` takes items ``[r*b, (r+1)*b)`` of every array
    (b = the global batch over ``n``), and ``shard_rows`` its rows; other values pass
    through."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) > 0:
            if len(v) % mesh.data:
                raise ValueError(f"{k}: batch {len(v)} not divisible by data={mesh.data}")
            b = len(v) // mesh.data
            v = v[mesh.data_index * b:(mesh.data_index + 1) * b]
        out[k] = v
    return shard_rows(out, mesh)


def shard_rows(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a data block: every array of rank 2 or more is cut on its
    height (axis 1) into ``row_block``'s block of the spatial index (``image``,
    ``label``, ``teacher_prob8``); other values pass through. The identity at
    spatial 1."""
    if mesh.spatial == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 2:
            lo, hi = row_block(v.shape[1], mesh.spatial_index, mesh.spatial)
            v = v[:, lo:hi]
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


# ---------------------------------------------------------------------------------
# The spatial axis: rows exchanged between the ranks of a spatial group
# ---------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """This rank's place in its spatial group inside ``spatial_rows``: the group, its
    index and size, and the global height of the images the block's forwards take."""

    group: dist.ProcessGroup
    index: int
    size: int
    height: int

    def block(self, height: int) -> Tuple[int, int]:
        """This rank's rows of an activation of global ``height``."""
        return row_block(height, self.index, self.size)


_ROWS: Optional[RowSharding] = None


@contextlib.contextmanager
def spatial_rows(mesh: Optional[Mesh], height: int) -> Iterator[None]:
    """Inside the block, the models' forwards (``models/``) take this rank's rows of
    images of global ``height`` (``row_block`` of the spatial index) and return the
    gathered stride-8 logits (DeepLabv3: this rank's rows of its input-size logits);
    each layer's global height follows from ``height``, so no collective asks for it. A
    mesh without a spatial axis (or None) leaves the forwards as they are."""
    global _ROWS
    rows = mesh.rows(height) if mesh is not None and mesh.spatial > 1 else None
    prev, _ROWS = _ROWS, rows
    try:
        yield
    finally:
        _ROWS = prev


def row_sharding() -> Optional[RowSharding]:
    """The ``RowSharding`` of ``spatial_rows``' block, None outside one."""
    return _ROWS


def _bit_sum_(t: torch.Tensor, group: dist.ProcessGroup) -> None:
    """All-reduce a flat contiguous buffer in which every element is written by at most
    one rank (zero elsewhere), as integers of its width: the sum is that rank's bits
    whatever the dtype, and gloo and NCCL run one code path for every dtype. A 2-byte
    buffer has an even length."""
    view = {8: torch.int64, 4: torch.int32, 2: torch.int32}[t.element_size()]
    _timed_all_reduce(t.view(view), group)


def _timed_all_reduce(t: torch.Tensor, group: dist.ProcessGroup) -> None:
    """``all_reduce`` (sum) of an exchange, its host seconds and bytes added to
    ``fetch_rows.seconds`` / ``.bytes`` (the wait for the card's queued work and for
    the peers included: gloo copies through host memory)."""
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    fetch_rows.seconds += time.perf_counter() - t0
    fetch_rows.bytes += t.numel() * t.element_size()


def _foreign_segments(height: int, size: int, windows: Sequence[Tuple[int, int]]):
    """For each rank, the rows of its window inside ``[0, height)`` that it does not own,
    as (a, b) segments in row order (at most one above and one below its block)."""
    out = []
    for r, (lo, hi) in enumerate(windows):
        own_lo, own_hi = row_block(height, r, size)
        a, b = max(lo, 0), min(hi, height)
        segs = []
        if a < b:
            if a < own_lo:
                segs.append((a, min(b, own_lo)))
            if b > own_hi:
                segs.append((max(a, own_hi), b))
        out.append(segs)
    return out


def _slots(segments):
    """The exchange buffer's layout: ``(rank, a, b, offset)`` of every foreign segment in
    rank order, and the total rows."""
    slots, off = [], 0
    for r, segs in enumerate(segments):
        for a, b in segs:
            slots.append((r, a, b, off))
            off += b - a
    return slots, off


def _flat_buffer(shape, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A zero buffer of ``shape`` in ``like``'s dtype and device and the flat tensor
    under it (padded to an even length for a 2-byte dtype)."""
    n = math.prod(shape)
    flat = torch.zeros(n + (n % 2 if like.element_size() == 2 else 0), dtype=like.dtype,
                       device=like.device)
    return flat[:n].view(shape), flat


class _FetchRows(torch.autograd.Function):
    """``fetch_rows``: forward gathers this rank's window, backward returns the window's
    cotangent to the rows' owners (each adds what it receives to its own rows)."""

    @staticmethod
    def forward(ctx, x, rows, height, windows, fill):
        b, c, n, w = x.shape
        own_lo, own_hi = rows.block(height)
        if n != own_hi - own_lo:
            raise ValueError(f"rank {rows.index} of {rows.size} holds {n} rows of an "
                             f"activation of height {height}; its block is "
                             f"[{own_lo}, {own_hi})")
        slots, total = _slots(_foreign_segments(height, rows.size, windows))
        xv = x.permute(0, 2, 3, 1)  # NHWC: rows are contiguous in channels_last memory
        buf = None
        if total:
            buf, flat = _flat_buffer((b, total, w, c), x)
            for r, a, bb, off in slots:
                i0, i1 = max(a, own_lo), min(bb, own_hi)
                if r != rows.index and i0 < i1:
                    buf[:, off + i0 - a:off + i1 - a] = xv[:, i0 - own_lo:i1 - own_lo]
            _bit_sum_(flat, rows.group)
        lo, hi = windows[rows.index]
        pieces = []
        if hi > lo:
            if lo < 0:
                pieces.append(x.new_full((b, min(hi, 0) - lo, w, c), fill))
            mine = {a: (bb, off) for r, a, bb, off in slots if r == rows.index}
            r0 = max(lo, 0)
            while r0 < min(hi, height):
                if r0 in mine:
                    bb, off = mine[r0]
                    pieces.append(buf[:, off:off + bb - r0])
                    r0 = bb
                else:  # this rank's own rows
                    r1 = min(hi, own_hi)
                    pieces.append(xv[:, r0 - own_lo:r1 - own_lo])
                    r0 = r1
            if hi > height:
                pieces.append(x.new_full((b, hi - max(lo, height), w, c), fill))
        out = (torch.cat(pieces, dim=1) if pieces else x.new_empty((b, 0, w, c)))
        ctx.rows, ctx.height, ctx.windows, ctx.n = rows, height, windows, n
        return out.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        rows, height, windows = ctx.rows, ctx.height, ctx.windows
        own_lo, own_hi = rows.block(height)
        lo, hi = windows[rows.index]
        gv = g.permute(0, 2, 3, 1)
        b, _, w, c = gv.shape
        slots, total = _slots(_foreign_segments(height, rows.size, windows))
        dx = torch.zeros((b, ctx.n, w, c), device=g.device,
                         dtype=torch.promote_types(g.dtype, torch.float32))
        i0, i1 = max(lo, own_lo), min(hi, own_hi)
        if i0 < i1:
            dx[:, i0 - own_lo:i1 - own_lo] += gv[:, i0 - lo:i1 - lo]
        if total:
            buf, flat = _flat_buffer((b, total, w, c), g)
            for r, a, bb, off in slots:
                if r == rows.index:
                    buf[:, off:off + bb - a] = gv[:, a - lo:bb - lo]
            _bit_sum_(flat, rows.group)
            for r, a, bb, off in slots:  # the other ranks' cotangents of my rows
                i0, i1 = max(a, own_lo), min(bb, own_hi)
                if r != rows.index and i0 < i1:
                    dx[:, i0 - own_lo:i1 - own_lo] += buf[:, off + i0 - a:off + i1 - a]
        return dx.to(g.dtype).permute(0, 3, 1, 2), None, None, None, None


def fetch_rows(x: torch.Tensor, rows: RowSharding, height: int,
               windows: Sequence[Tuple[int, int]], fill: float = 0.0) -> torch.Tensor:
    """This rank's window of a row-sharded activation, differentiable.

    ``x`` (B, C, n, W) holds this rank's ``rows.block(height)`` of an activation of
    global ``height``; ``windows[r]`` is rank r's window ``[lo, hi)`` of global rows
    (every rank passes the same list; an empty one for a rank with no output rows).
    Returns (B, C, hi - lo, W) in ``channels_last`` memory: rows outside ``[0,
    height)`` are ``fill`` (0 for a convolution, -inf for a max pool), the others this
    rank's own or, for the rows other ranks own (from any of them, not only the
    neighbours), those ranks'. Only those foreign rows cross: one all-reduce of a buffer
    with a slot for each rank's foreign rows, written by their owners (about S times the
    foreign rows, never a whole activation), none when no window reaches past its
    block. The backward sends the foreign rows' cotangents back the same way and the
    owners add them to their rows' (in float32 at least, then rounded once)."""
    return _FetchRows.apply(x, rows, int(height), tuple(map(tuple, windows)), float(fill))


# Host seconds and bytes of every exchange all-reduce (``fetch_rows`` and
# ``gather_rows``, forward and backward) since they were last zeroed.
fetch_rows.seconds = 0.0
fetch_rows.bytes = 0


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, height):
        b, c, n, w = x.shape
        lo, hi = rows.block(height)
        full, flat = _flat_buffer((b, height, w, c), x)
        full[:, lo:hi] = x.permute(0, 2, 3, 1)
        _bit_sum_(flat, rows.group)
        ctx.rows, ctx.lo, ctx.hi = rows, lo, hi
        return full.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        gv = g.permute(0, 2, 3, 1).contiguous()
        _timed_all_reduce(gv, ctx.rows.group)
        return gv[:, ctx.lo:ctx.hi].permute(0, 3, 1, 2), None, None


def gather_rows(x: torch.Tensor, rows: RowSharding, height: int) -> torch.Tensor:
    """The whole (B, C, height, W) tensor on every rank of the spatial group from each
    rank's ``rows.block(height)`` (B, C, n, W), differentiable: the backward sums the
    ranks' cotangents and keeps this rank's rows. For the small stride-8 tensors (logits,
    the teacher posterior) the losses read whole."""
    return _GatherRows.apply(x, rows, int(height))
