"""Device meshes and sharding over ``torch.distributed`` (counterpart of
``this_and_that_vdm_tpu/parallel/mesh.py``).

Training runs one process per card (a rank), in one process group: NCCL on
the cards, gloo on the CPU.  :func:`make_mesh` lays the ranks out as
``(dp, fsdp)``, or ``(dcn, dp, fsdp)`` with an outer ``dcn`` axis: fsdp
innermost, so an fsdp group is a run of consecutive ranks (on one host), and
dcn outermost, so only the outer gradient reduction crosses hosts.  Every
axis carries data: each rank trains on its own rows of the global batch.

* ``dp`` / ``dcn``: the gradients of the ranks are averaged.
* ``fsdp``: the trainable state is split over the fsdp group (ZeRO-3, as
  the JAX mesh keeps it): parameters, gradients and optimizer state.  The
  trainable model is cut into units (its blocks, :func:`_blocks`, and the
  root's other leaves); a unit's leaves are numbered in 256-element blocks
  as the 8-bit optimizer's arena numbers them (``ops/adam8bit.leaf_blocks``,
  the JAX rule of ``ops/adam8bit_pallas.py``) and cut into ``fsdp`` equal
  runs of whole blocks (:func:`shard_params`, :class:`BlockRows`), so K4's
  per-block absmax never straddles two ranks.  A rank keeps its run of
  every unit at rest; a unit is all-gathered for its forward and its
  backward and freed after, and its gradients are reduce-scattered into the
  rank's rows as soon as they are complete (:func:`shard_module`,
  :class:`ShardedParams`).

Without a process group (no launcher environment) everything is one rank:
the mesh is ``1 x 1`` and the training step takes its one-device path.

Serving runs in one process: :func:`make_serving_mesh` lays ``torch.device``
objects out as ``(clip, cfg)``; a device may repeat (a CPU, or one card).
The pipelines keep one replica of each model per distinct device
(:func:`replicate_to_mesh`), split the clip batch over ``clip``
(:func:`shard_leading`) and the CFG branches over ``cfg``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.graph import register_multi_grad_hook
from torch.utils._pytree import tree_leaves

from ..ops.adam8bit import leaf_blocks, leaf_rows
from ..ops.quant8 import BLOCK


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _distributed() else 0


def _world() -> int:
    return dist.get_world_size() if _distributed() else 1


class Mesh:
    """Named grid of ranks (training) or of ``torch.device`` s (serving).

    ``devices``: the grid, an object array; ``axis_names``: one name an
    axis; ``shape``: axis name -> extent.  A training mesh made while a
    process group is up also holds the process groups of its axes
    (:meth:`group`), made collectively in :func:`make_mesh`."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self._device_mesh = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape})"

    def index(self, rank: Optional[int] = None) -> int:
        """Position of ``rank`` (this process's by default) in the grid's
        row-major order: its part of the global batch."""
        rank = _rank() if rank is None else rank
        hits = np.flatnonzero(self.devices.ravel() == rank)
        if not hits.size:
            raise ValueError(f"rank {rank} is not in the mesh {self.shape}")
        return int(hits[0])

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        idx = np.unravel_index(self.index(rank), self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def _make_group(self, axes: Tuple[str, ...]):
        """Collective: every rank makes every group of ``axes`` (the ranks
        that differ only along ``axes``), in one order."""
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        moved = np.moveaxis(self.devices, keep, list(range(len(keep))))
        lists = [sorted(int(r) for r in g.ravel())
                 for g in moved.reshape(-1, int(np.prod([self.shape[a] for a in axes] or [1])))]
        mine, _ = dist.new_subgroups_by_enumeration(lists)
        self._groups[axes] = mine

    def group(self, *axes: str):
        """The process group of this rank along ``axes``: the ranks whose
        other coordinates equal this rank's.  None without a process group."""
        if not _distributed():
            return None
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            raise KeyError(f"no process group made for axes {key}; make_mesh makes "
                           f"{sorted(self._groups)}")
        return self._groups[key]

    def device_mesh(self, device_type: str):
        """The ``torch.distributed`` ``DeviceMesh`` over the same grid, for
        FSDP2 (:func:`shard_frozen`).  Collective the first time."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh(device_type, torch.as_tensor(
                self.devices.astype(np.int64)), mesh_dim_names=self.axis_names)
        return self._device_mesh


def make_mesh(devices: Optional[Sequence[int]] = None, dp: Optional[int] = None,
              fsdp: int = 1, dcn: int = 1) -> Mesh:
    """(dp, fsdp) mesh of ranks, or (dcn, dp, fsdp) with ``dcn > 1``.

    ``devices``: the ranks, in order (default: every rank of the process
    group, or ``[0]`` without one).  Consecutive ranks fill fsdp first, then
    dp, then dcn, so each dcn granule (a host) holds a contiguous run of
    ranks.  Under a process group the axes' process groups are made here
    (collective: every rank calls this at the same point)."""
    devices = list(devices if devices is not None else range(_world()))
    n = len(devices)
    if dp is None:
        dp = n // (fsdp * dcn)
    assert dp * fsdp * dcn == n, f"mesh {dcn}x{dp}x{fsdp} != {n} devices"
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if dcn > 1:
        mesh = Mesh(arr.reshape(dcn, dp, fsdp), ("dcn", "dp", "fsdp"))
    else:
        mesh = Mesh(arr.reshape(dp, fsdp), ("dp", "fsdp"))
    if _distributed():
        if n != _world():
            raise ValueError(f"a training mesh spans every rank: {n} of {_world()}")
        mesh._make_group(("fsdp",))
        mesh._make_group(tuple(a for a in mesh.axis_names if a != "fsdp"))
    return mesh


def distributed_init(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device_type: str = "cuda") -> bool:
    """Join the process group of a multi-process run; call before building
    models.  No-op (False) when neither the arguments nor the launcher's
    environment ask for it, so one-process runs need no flags.  The
    environment is the standard launcher's (``torchrun``): ``MASTER_ADDR`` /
    ``MASTER_PORT`` (``coordinator`` as ``host:port``), ``WORLD_SIZE``
    (``num_processes``), ``RANK`` (``process_id``) and ``LOCAL_RANK``;
    ``TTV_MULTIHOST=1`` forces the join, as in the JAX package.

    ``device_type`` ``cuda``: NCCL, and the rank's card is ``cuda:LOCAL_RANK``
    (made the current device); ``cpu``: gloo.  Returns True when joined."""
    env = os.environ
    if (coordinator is None and num_processes is None and env.get("WORLD_SIZE") is None
            and env.get("TTV_MULTIHOST") != "1"):
        return False
    if _distributed():
        return True
    if coordinator:
        host, port = coordinator.rsplit(":", 1)
        env["MASTER_ADDR"], env["MASTER_PORT"] = host, port
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    env.setdefault("MASTER_ADDR", "127.0.0.1")
    if "MASTER_PORT" not in env:
        raise RuntimeError("distributed_init: MASTER_PORT (or coordinator host:port) is not set")
    kwargs = {}
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init: no CUDA device for an NCCL rank; "
                               "use device_type='cpu' for gloo")
        local = int(env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            world_size=world, rank=rank, **kwargs)
    # make the group's first collective now, while every rank stands at the
    # same line (the JAX package's sync_global_devices, for the same reason:
    # the first collective otherwise waits out uneven start-up on a short
    # deadline)
    dist.barrier()
    return True


def is_main_process() -> bool:
    """Rank 0 does the I/O (logger, prints, checkpoint writes, renders)."""
    return _rank() == 0


# ------------------------------------------------------------------ batches

def _data_axes(mesh: Mesh) -> Tuple[Tuple[str, ...], int]:
    axes = tuple(a for a in ("dcn", "dp", "fsdp") if a in mesh.axis_names)
    return axes, int(np.prod([mesh.shape[a] for a in axes] or [1]))


def _leading(x) -> Optional[int]:
    return x.shape[0] if getattr(x, "ndim", np.ndim(x)) > 0 else None


def shard_batch(batch: Dict[str, Any], mesh: Mesh, rank: Optional[int] = None) -> Dict[str, Any]:
    """This rank's rows of a GLOBAL batch (every data axis splits the batch
    jointly, in rank order).  Scalars are kept; a leaf whose leading dim the
    data extent does not divide RAISES, never replicates."""
    axes, n = _data_axes(mesh)
    idx = mesh.index(rank)

    def take(x):
        lead = _leading(x)
        if lead is None:
            return x
        if lead % n:
            raise ValueError(
                f"batch leaf with leading dim {lead} is not divisible by the mesh data "
                f"extent {n} (axes {axes}, mesh {mesh.shape}); refusing to silently "
                f"replicate a batch-like leaf")
        per = lead // n
        return x[idx * per:(idx + 1) * per]

    return {k: take(v) for k, v in batch.items()}


def global_batch(batch: Dict[str, Any], mesh: Mesh, device=None) -> Dict[str, torch.Tensor]:
    """A process-LOCAL batch as this rank's part of the global one (leading
    dim ``local * processes``; one rank a process, so the local batch is
    the rank's rows), as tensors on ``device``.  Every non-scalar leaf must
    share one leading dim: a shared constant vector would be taken for
    batch rows."""
    lead = {_leading(v) for v in batch.values()} - {None}
    if len(lead) > 1 and _world() > 1:
        raise ValueError(
            "global_batch expects a batch-collated tree (every non-scalar leaf shares one "
            f"leading batch dim); got leading dims {sorted(lead)}. Replicated non-scalar "
            "leaves must be passed outside the batch.")
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# ----------------------------------------------------------- block rows

@dataclasses.dataclass
class BlockRows:
    """One rank's rows of the trainable state under fsdp.

    The leaves (``names``, flattened, in order) are numbered in 256-element
    blocks as K4's arena numbers them; the ``total`` blocks are cut into
    ``parts`` runs of ``rows`` blocks (the last run padded), and this rank
    holds run ``part``: blocks ``[lo, hi)``.  ``pieces[name] = (first, end)``
    is the part of a leaf's flat elements in those rows, empty for a leaf
    outside them; a piece starts on a block boundary of its leaf."""

    names: List[str]
    shapes: List[Tuple[int, ...]]
    numels: List[int]
    first: List[int]
    total: int
    parts: int
    part: int
    rows: int
    pieces: Dict[str, Tuple[int, int]]
    group: Any = None  # the fsdp process group the parts are split over

    @property
    def lo(self) -> int:
        return self.part * self.rows

    @property
    def hi(self) -> int:
        return min(self.total, self.lo + self.rows)

    def blocks(self, name: str) -> Tuple[int, int]:
        """The piece of leaf ``name`` as blocks of the leaf: [b0, b1)."""
        e0, e1 = self.pieces[name]
        return e0 // BLOCK, -(-e1 // BLOCK)

    def __post_init__(self):
        self._pos = {n: i for i, n in enumerate(self.names)}

    def offset(self, name: str) -> int:
        """Element offset of a piece in the rank's rows buffer."""
        return (self.first[self._pos[name]] + self.pieces[name][0] // BLOCK - self.lo) * BLOCK

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The pieces as views of a rows buffer (``rows * 256`` elements)."""
        return {k: buf[self.offset(k):self.offset(k) + e1 - e0]
                for k, (e0, e1) in self.pieces.items()}

    def pack(self, tree: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
        """Whole leaves -> one flat buffer of every part's rows
        (``parts * rows * 256`` elements, zeros in the padding)."""
        dev = next(iter(tree.values())).device
        buf = torch.zeros(self.parts * self.rows * BLOCK, dtype=dtype, device=dev)
        for i, k in enumerate(self.names):
            buf[self.first[i] * BLOCK:self.first[i] * BLOCK + self.numels[i]] = \
                tree[k].detach().reshape(-1)
        return buf


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 rank: Optional[int] = None) -> BlockRows:
    """This rank's block rows of ``params`` under the mesh's fsdp axis (the
    JAX ``shard_params`` shards each leaf on an axis; here the rows of the
    optimizer's arena are split, so K4's per-block absmax stays one rank's)."""
    names = list(params)
    numels = [params[k].numel() for k in names]
    first, total = leaf_blocks(numels)
    parts = mesh.shape["fsdp"]
    part = mesh.coords(rank)["fsdp"]
    rows = -(-total // parts)
    lo, hi = part * rows, min(total, (part + 1) * rows)
    pieces = {k: (0, 0) for k in names}
    for i, e0, e1 in leaf_rows(numels, lo, hi):
        pieces[names[i]] = (e0, e1)
    return BlockRows(names, [tuple(params[k].shape) for k in names], numels, first, total,
                     parts, part, rows, pieces, mesh.group("fsdp"))


def _is_blockq(v) -> bool:
    return getattr(v, "_fields", None) == ("q", "scale")


def _map_leaf_dicts(tree, names, fn):
    """``fn(d)`` on every dict of ``tree`` keyed by leaf names (a dict of
    the optimizer state: moments, accumulators); the rest is rebuilt as is."""
    if isinstance(tree, dict):
        if tree and set(tree) <= names:
            return fn(tree)
        return {k: _map_leaf_dicts(v, names, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and not _is_blockq(tree):
        vals = [_map_leaf_dicts(v, names, fn) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def shard_state(tree, rows: "ShardedParams"):
    """This rank's rows of a one-rank optimizer state (as a checkpoint holds
    it): element tensors cut to the pieces, block-quantised leaves
    (``(q, scale)``) to the pieces' blocks."""
    def cut(d):
        out = {}
        for k, v in d.items():
            b0, b1 = rows.blocks(k)
            if _is_blockq(v):
                out[k] = type(v)(v.q.reshape(-1)[b0 * BLOCK:b1 * BLOCK].clone(),
                                 v.scale[b0:b1].clone())
            else:
                e0, e1 = rows.pieces[k]
                out[k] = v.reshape(-1)[e0:e1].clone()
        return out

    return _map_leaf_dicts(tree, set(rows.names), cut)


def host_replicated(tree, rows: Optional["ShardedParams"] = None):
    """The one-rank form of an optimizer state that holds this rank's rows
    (``rows``), on the CPU: a COLLECTIVE over the fsdp group (every rank
    calls it at the same point, every rank gets the whole tree), a unit at
    a time.  Identity without ``rows`` or a process group."""
    if rows is None or not _distributed():
        return tree

    def whole(d):
        out = {}
        for r in (u.rows for u in rows.units):
            sub = {k: d[k] for k in r.names if k in d}
            if sub:
                out.update(_whole_rows(sub, r))
        return {k: out[k] for k in d}

    return _map_leaf_dicts(tree, set(rows.names), whole)


def _whole_rows(d, rows: BlockRows):
    """Whole leaves (on the CPU) from every part's pieces of ``d``, gathered
    over ``rows.group``."""
    def gather(buf):
        full = buf.new_empty(rows.parts * buf.numel())
        dist.all_gather_into_tensor(full, buf, group=rows.group)
        return full

    k0 = next(iter(d))
    v0 = d[k0]
    dev = (v0.q if _is_blockq(v0) else v0).device
    if _is_blockq(v0):
        codes = torch.zeros(rows.rows * BLOCK, dtype=torch.uint8, device=dev)
        scales = torch.zeros(rows.rows, dtype=torch.float32, device=dev)
        for k, v in d.items():
            b0, b1 = rows.blocks(k)
            o = rows.offset(k) // BLOCK
            codes[o * BLOCK:(o + b1 - b0) * BLOCK] = v.q.reshape(-1)
            scales[o:o + b1 - b0] = v.scale
        codes, scales = gather(codes).cpu(), gather(scales).cpu()
        out = {}
        for k, v in d.items():
            i = rows._pos[k]
            nb = -(-rows.numels[i] // BLOCK)
            f = rows.first[i]
            out[k] = type(v0)(codes[f * BLOCK:(f + nb) * BLOCK].clone(),
                              scales[f:f + nb].clone())
        return out
    buf = torch.zeros(rows.rows * BLOCK, dtype=v0.dtype, device=dev)
    for k, v in d.items():
        o = rows.offset(k)
        buf[o:o + v.numel()] = v
    full = gather(buf).cpu()
    out = {}
    for k in d:
        i = rows._pos[k]
        s = rows.first[i] * BLOCK
        out[k] = full[s:s + rows.numels[i]].view(rows.shapes[i]).clone()
    return out


# ------------------------------------------------------------------ ZeRO-3

def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


@dataclasses.dataclass
class _Unit:
    module: torch.nn.Module
    names: List[str]
    rows: BlockRows
    base: int  # first block of the unit's run in the rank's rows
    full: torch.Tensor = None  # every part's rows; the leaves are views of it
    gathered: bool = False
    ready: int = 0  # leaves whose gradient is complete in this backward
    reduced: bool = False  # the unit's gradients are in this step's rows


class ShardedParams:
    """The trainable parameters of a module under fsdp, ZeRO-3: each rank
    holds its rows of every unit between steps.

    * ``arena``: the rank's rows of all units, one fp32 buffer (unit ``u``
      at blocks ``[u.base, u.base + u.rows.rows)``); the optimizer updates
      its pieces in place (:meth:`views`).
    * Each parameter is a view of its unit's ``full`` buffer (every part's
      rows), whose storage is empty at rest.  A forward pre-hook of the unit
      all-gathers it, a post-hook frees it; a hook on the unit's outputs
      gathers it again for the backward (and for the recompute of
      ``remat``), and once every leaf of the unit has its gradient, the
      gradients are packed, reduce-scattered into the rank's gradient rows
      and freed, and so is the unit.  The parameters keep their identity and
      shapes throughout.
    * :meth:`whole` holds every unit gathered (collective), for whatever
      reads the whole model between steps: validation renders, exports.

    Every rank runs the same graph, so every rank issues the same gathers
    and reduce-scatters in the same order.  With one part (``fsdp`` 1) the
    rows are the whole units: the parameters are views of ``arena`` and
    nothing is gathered or freed."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh):
        named = dict(module.named_parameters())
        self.names = list(named)
        self.params = named
        self.parts = mesh.shape["fsdp"]
        self.group = mesh.group("fsdp")
        self.grads: Optional[torch.Tensor] = None
        self._pinned = 0
        pos = {n: i for i, n in enumerate(self.names)}
        by_id = {id(p): n for n, p in named.items()}
        owned: set = set()
        self.units: List[_Unit] = []
        base = 0
        for m in _blocks(module) + [module]:
            names = sorted({by_id[id(p)] for p in m.parameters() if id(p) in by_id} - owned,
                           key=pos.get)
            if not names:
                continue
            owned.update(names)
            rows = shard_params({n: named[n].detach() for n in names}, mesh)
            self.units.append(_Unit(m, names, rows, base))
            base += rows.rows
        self.size = base
        p0 = next(iter(named.values()))
        if any(p.dtype != torch.float32 for p in named.values()):
            raise ValueError("shard_module: the trainable parameters must be fp32")
        self.arena = torch.zeros(self.size * BLOCK, dtype=torch.float32, device=p0.device)
        self.pieces, self._offset = {}, {}
        for u in self.units:
            for k, e in u.rows.pieces.items():
                self.pieces[k] = e
                self._offset[k] = u.base * BLOCK + u.rows.offset(k)
        self.pieces = {k: self.pieces[k] for k in self.names}
        with torch.no_grad():
            for k, v in self.views(self.arena).items():
                e0, e1 = self.pieces[k]
                v.copy_(named[k].detach().reshape(-1)[e0:e1])
            for u in self.units:
                self._point(u, self._shard(u) if self.parts == 1 else None)
                u.gathered = True
                self._free(u)
                u.module.register_forward_pre_hook(self._pre_forward(u))
                u.module.register_forward_hook(self._post_forward(u))
                for k in u.names:
                    named[k].register_post_accumulate_grad_hook(self._grad_ready(u))

    # -- pieces of the rank's rows
    def _shard(self, u: _Unit) -> torch.Tensor:
        return self.arena[u.base * BLOCK:(u.base + u.rows.rows) * BLOCK]

    def views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each leaf's piece as a view of a buffer laid out as ``arena``
        (empty for a leaf outside the rank's rows)."""
        return {k: buf[self._offset[k]:self._offset[k] + e1 - e0]
                for k, (e0, e1) in self.pieces.items()}

    def blocks(self, name: str) -> Tuple[int, int]:
        """The piece of leaf ``name`` as blocks of the leaf: [b0, b1)."""
        e0, e1 = self.pieces[name]
        return e0 // BLOCK, -(-e1 // BLOCK)

    # -- gather and free
    def _point(self, u: _Unit, full: Optional[torch.Tensor] = None) -> None:
        """Make the unit's parameters views of ``full`` (a new buffer of
        every part's rows when None)."""
        r = u.rows
        u.full = full if full is not None else torch.empty(
            self.parts * r.rows * BLOCK, dtype=torch.float32, device=self.arena.device)
        for i, k in enumerate(u.names):
            s = r.first[i] * BLOCK
            self.params[k].data = u.full[s:s + r.numels[i]].view(r.shapes[i])

    def _gather(self, u: _Unit) -> None:
        if u.gathered:
            return
        u.full.untyped_storage().resize_(u.full.numel() * u.full.element_size())
        dist.all_gather_into_tensor(u.full, self._shard(u), group=self.group)
        u.gathered = True

    def _free(self, u: _Unit) -> None:
        if self.parts > 1 and u.gathered and not self._pinned:
            if not u.full.untyped_storage().resizable():
                # a reader pinned the storage (``Tensor.numpy`` does): give
                # the parameters a buffer of their own
                self._point(u)
            u.full.untyped_storage().resize_(0)
            u.gathered = False

    def _pre_forward(self, u: _Unit):
        def hook(module, args):
            self._gather(u)
        return hook

    def _post_forward(self, u: _Unit):
        def hook(module, args, out):
            if _in_backward():  # the recompute of remat: the backward frees
                return
            if torch.is_grad_enabled():
                ts = [t for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor) and t.requires_grad]
                if ts:
                    register_multi_grad_hook(ts, lambda _: self._gather(u), mode="any")
            self._free(u)
        return hook

    def _grad_ready(self, u: _Unit):
        def hook(p):
            u.ready += 1
            if u.ready == len(u.names):
                self._reduce(u)
        return hook

    def _reduce(self, u: _Unit) -> None:
        """The unit's whole gradients -> the rank's gradient rows (summed
        over the fsdp group); the gradients and the unit are freed."""
        if self.grads is None:
            self.grads = torch.zeros_like(self.arena)
        mine = self.grads[u.base * BLOCK:(u.base + u.rows.rows) * BLOCK]
        grads = {}
        for k in u.names:
            p = self.params[k]
            grads[k] = p.grad if p.grad is not None else torch.zeros(p.shape, device=p.device)
        with torch.no_grad():
            if self.parts == 1:
                for k, v in u.rows.views(mine).items():
                    v.copy_(grads[k].reshape(-1))
            else:
                dist.reduce_scatter_tensor(mine, u.rows.pack(grads), group=self.group)
        for k in u.names:
            self.params[k].grad = None
        u.ready, u.reduced = 0, True
        self._free(u)

    def take_grads(self) -> torch.Tensor:
        """After the backward: the rank's gradient rows of every unit (laid
        out as ``arena``), summed over the fsdp group.  A unit with a leaf
        the backward did not reach is reduced here, that leaf's gradient
        zero (every rank reduces it: the graph is the same)."""
        for u in self.units:
            if not u.reduced:
                self._reduce(u)
            u.reduced = False
        grads, self.grads = self.grads, None
        return grads

    @contextlib.contextmanager
    def whole(self):
        """Every parameter whole while the context is open (COLLECTIVE over
        the fsdp group: every rank enters it at the same point).  For
        reading; writes do not reach the rows."""
        self._pinned += 1
        try:
            for u in self.units:
                self._gather(u)
            yield self.params
        finally:
            self._pinned -= 1
            for u in self.units:
                self._free(u)

    def host_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole, on the CPU (COLLECTIVE), a unit at a time."""
        out = {}
        for u in self.units:
            self._gather(u)
            for k in u.names:
                out[k] = self.params[k].detach().to("cpu", copy=True)
            self._free(u)
        return {k: out[k] for k in self.names}

    @torch.no_grad()
    def load_(self, tree: Dict[str, torch.Tensor]) -> None:
        """Whole leaves (a one-rank checkpoint's) -> the rank's rows."""
        for k, v in self.views(self.arena).items():
            e0, e1 = self.pieces[k]
            v.copy_(tree[k].reshape(-1)[e0:e1])

    def resident_bytes(self) -> int:
        """Bytes of parameter storage this rank holds now: the rows and any
        gathered unit (each storage once)."""
        seen = {self.arena.untyped_storage().data_ptr(): self.arena.untyped_storage().nbytes()}
        for p in self.params.values():
            st = p.untyped_storage()
            if st.nbytes():
                seen[st.data_ptr()] = st.nbytes()
        return sum(seen.values())


def shard_module(module: torch.nn.Module, mesh: Mesh) -> ShardedParams:
    """Split the trainable ``module`` over the mesh's fsdp axis, ZeRO-3
    (:class:`ShardedParams`); collective with more than one fsdp part."""
    return ShardedParams(module, mesh)


# ------------------------------------------------------------- replication

def replicate(tree: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Make every rank hold the first rank's values of ``tree`` (a broadcast
    in place); identity without a process group."""
    if _distributed():
        src = int(mesh.devices.ravel()[0])
        with torch.no_grad():
            for t in tree.values():
                dist.broadcast(t.data, src=src)
    return tree


def _distinct(devices) -> List[torch.device]:
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d not in out:
            out.append(d)
    return out


def replicate_to_mesh(module: torch.nn.Module, mesh: Mesh) -> Dict[torch.device, torch.nn.Module]:
    """One replica of ``module`` per distinct device of a serving mesh: the
    module itself on its own device, a copy on each other one."""
    own = next(module.parameters()).device
    return {d: module if d == own else copy.deepcopy(module).to(d)
            for d in _distinct(mesh.devices.ravel())}


def shard_leading(x: torch.Tensor, mesh: Mesh, axes: Optional[Sequence[str]] = None
                  ) -> List[torch.Tensor]:
    """``x`` split on its leading axis over ``axes`` (default: every axis):
    chunk ``k`` goes to the ``k``-th position of those axes (at index 0 of
    the others).  Chunks differ by at most one row and may be empty when the
    axes outnumber the rows (a server's partial batch)."""
    axes = tuple(axes) if axes is not None else mesh.axis_names
    devs = mesh_devices(mesh, axes)
    return [c.to(d) for c, d in zip(torch.tensor_split(x, len(devs)), devs)]


def mesh_devices(mesh: Mesh, axes: Sequence[str]) -> List[torch.device]:
    """The devices along ``axes``, the other axes at index 0, row-major."""
    idx = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
    return [torch.device(d) for d in np.asarray(mesh.devices[idx]).ravel()]


def make_serving_mesh(devices: Optional[Sequence] = None, cfg: int = 1) -> Mesh:
    """(clip, cfg) mesh of devices for serving in one process.

    * ``clip``: clips data-parallel (throughput).
    * ``cfg``: the CFG branches of the denoise loop (latency): the uncond /
      cond (ip2p: three) halves run on their own devices and meet once a
      step for the guided combine.  ``cfg`` is 2 (standard) or 3 (ip2p).

    ``devices``: ``torch.device`` s (or names); may repeat.  Default: every
    card, or the CPU."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")])
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    assert n % cfg == 0, f"{n} devices not divisible by cfg={cfg}"
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // cfg, cfg), ("clip", "cfg"))


# ------------------------------------------------------------ frozen towers

def _blocks(module: torch.nn.Module) -> List[torch.nn.Module]:
    """The outermost items of ``module``'s module lists that run through
    their own ``forward`` (a plain container's lists are searched instead)."""
    out = []
    for child in module.children():
        if isinstance(child, torch.nn.ModuleList):
            for item in child:
                if type(item).forward is not torch.nn.Module.forward:
                    out.append(item)
                else:
                    out.extend(_blocks(item))
        else:
            out.extend(_blocks(child))
    return out


def shard_frozen(module: torch.nn.Module, mesh: Mesh, methods: Sequence[str] = ()):
    """``frozen_sharding: fsdp``: the frozen ``module`` split over the fsdp
    axis with FSDP2 (``fully_shard``): each block (:func:`_blocks`) is its
    own unit, the root holds the rest.  A block's parameters are
    all-gathered for its forward (and, in the gradient path, its backward)
    and freed after; the gathers are exact, so the numbers do not change.
    ``methods``: entry points besides ``forward`` (the VAE's
    ``encode_mode`` / ``decode``).  Collective; a no-op without a process
    group."""
    if not _distributed():
        return module
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    dev = next(module.parameters()).device
    sub = mesh.device_mesh(dev.type)["fsdp"]
    for block in _blocks(module):
        fully_shard(block, mesh=sub)
    fully_shard(module, mesh=sub)
    for meth in methods:
        register_fsdp_forward_method(module, meth)
    return module
