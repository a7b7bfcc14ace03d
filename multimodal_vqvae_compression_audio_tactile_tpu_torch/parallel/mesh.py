"""Data-parallel mesh on ``torch.distributed``: one process per device.

The port of the JAX package's ``parallel/mesh.py``. There, one controller
holds a mesh of devices and GSPMD partitions each jitted program; here each
device has its own process (the PyTorch idiom: ``torchrun``, or the spawned
ranks of ``parallel/dryrun.py``), and a ``Mesh`` is this process's place in
the same (dcn, data, model) grid, with the process groups its collectives
run over. The axis names and the ``shape`` mapping are JAX's: ``data`` is
the batch axis, ``model`` is reserved (ranks that differ only on it compute
the same rows), and ``dcn``, the outer axis of ``create_hybrid_mesh``,
stands for the slow links between hosts, so the gradient reduction runs
within each row (``data``) first and across the rows (``dcn``) second.

Ranks are laid out row-major over (dcn, data, model), as JAX reshapes its
device list, and a rank's batch shard is ``dcn_index * data + data_index``
of ``dcn * data`` equal shards.

The entry points keep JAX's single-controller contract: every rank is given
the same global host batch and returns the same global result. Serving
runs its rows of the batch and all-gathers the outputs; training reduces the
gradients before the optimizer, so the parameters stay replicated. Where a
step's value depends on the whole batch, the step runs inside
``batch_scope(mesh)`` and the reduction goes through ``batch_sum`` or
``batch_mean``, which all-reduce differentiably there and are the identity
elsewhere: a ratio of two sums over the batch (``plc/train.py``'s masked
terms, the quantizer-dropout losses of ``models/dac.py``, the GAN's feature
matching) is the ratio of the global sums, not a mean of per-shard ratios.
Random draws over the batch come from ``core/rng.py::BatchShard``: every
rank draws the global tensor from the same generator and keeps its rows.

The backend is NCCL on the card and gloo on the CPU; a mesh never changes
its backend or drops to a single process. NCCL takes one rank per card, so
one card runs the mesh at world size 1, where every collective is a real
NCCL call that returns its input.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"
# batch (data-parallel) axes, outermost first
BATCH_AXES = (DCN_AXIS, DATA_AXIS)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")     # torchrun's, with MASTER_ADDR/PORT


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def distributed_init(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None) -> int:
    """Initialise the default process group once per process; -> the world
    size.

    With ``init_method`` (``"tcp://localhost:<port>"``, ``"file://<path>"``),
    ``world_size`` and ``rank`` from the caller, or from a launcher's
    environment (``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, through ``env://``). NCCL where ``device`` is a card
    (``None`` means the card, ``cuda:LOCAL_RANK`` under ``torchrun``), gloo
    where it is the CPU. Returns 1 and initialises nothing in a plain single
    process (no arguments, no launcher), and the world size when the group
    exists already."""
    if dist.is_initialized():
        return dist.get_world_size()
    launched = all(os.environ.get(k) for k in _LAUNCHER_ENV)
    if init_method is None and world_size in (None, 1) and not launched:
        return 1
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the mesh on gloo")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if init_method is None else dict(world_size=world_size, rank=rank)
    dist.init_process_group(_backend_for(device), init_method=init_method or "env://", **kw)
    return dist.get_world_size()


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dcn, data, model) or (data, model) grid.

    ``shape`` maps the axis names to their sizes, outermost first (JAX's
    ``Mesh.shape``); ``coords`` this rank's index on each axis. The groups:
    ``batch_group`` the ranks that hold the batch's shards at this rank's
    ``model`` index (dcn x data of them; ``None`` is the whole world), and
    on a hybrid mesh ``row_group`` (this rank's dcn row, over data) and
    ``col_group`` (over dcn at this rank's data index)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    batch_group: Any = None
    row_group: Any = None
    col_group: Any = None

    @property
    def batch_shards(self) -> int:
        """The number of batch shards: dcn x data."""
        return int(np.prod([self.shape[a] for a in BATCH_AXES if a in self.shape]))

    @property
    def batch_index(self) -> int:
        """This rank's batch shard, ``dcn_index * data + data_index``."""
        return self.coords.get(DCN_AXIS, 0) * self.shape[DATA_AXIS] + self.coords[DATA_AXIS]

    @property
    def hybrid(self) -> bool:
        return DCN_AXIS in self.shape

    def shard_size(self, n: int) -> int:
        """The rows of a global batch of ``n`` that each rank holds; raises
        where ``n`` does not divide into the batch shards."""
        if n % self.batch_shards:
            raise ValueError(f"batch {n} not divisible by the {self.batch_shards} batch shards "
                             f"of mesh {self.shape}")
        return n // self.batch_shards

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        b = self.shard_size(n)
        return slice(self.batch_index * b, (self.batch_index + 1) * b)


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call distributed_init first")
    return dist.get_world_size()


def _device_of(backend: str) -> torch.device:
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _groups(grid: np.ndarray, axes: Sequence[int], rank: int) -> Any:
    """Create (on every rank, in the same order) the groups of ranks that
    vary along ``axes`` of ``grid`` and agree on the others; -> this rank's,
    or None where it is the whole world."""
    if grid.size == int(np.prod([grid.shape[a] for a in axes])):
        return None
    moved = np.moveaxis(grid, list(axes), list(range(grid.ndim - len(axes), grid.ndim)))
    mine = None
    for ranks in moved.reshape(-1, int(np.prod([grid.shape[a] for a in axes]))):
        g = dist.new_group(sorted(int(r) for r in ranks))
        if rank in ranks:
            mine = g
    return mine


def _build(names: tuple, sizes: tuple) -> Mesh:
    rank = dist.get_rank()
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, sizes))))
    batch_axes = [names.index(a) for a in BATCH_AXES if a in names]
    batch = _groups(grid, batch_axes, rank)
    row = col = None
    if DCN_AXIS in names:
        row = _groups(grid, [names.index(DATA_AXIS)], rank)
        col = _groups(grid, [names.index(DCN_AXIS)], rank)
    backend = dist.get_backend()
    return Mesh(dict(zip(names, sizes)), coords, rank, _device_of(backend), backend,
                batch, row, col)


def create_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """A (data, model) mesh over the world; ``data`` defaults to world //
    model. Raises where the sizes do not make the world."""
    n = _world()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return _build((DATA_AXIS, MODEL_AXIS), (data, model))


def create_hybrid_mesh(dcn: int, model: int = 1) -> Mesh:
    """A (dcn, data, model) mesh over the world: ``dcn`` rows (hosts or
    slices) of world // (dcn * model) data ranks. Raises where the world
    does not divide."""
    n = _world()
    if n % (dcn * model):
        raise ValueError(f"{n} devices not divisible by dcn={dcn}*model={model}")
    return _build((DCN_AXIS, DATA_AXIS, MODEL_AXIS), (dcn, n // (dcn * model), model))


def mesh_for_batch(batch: int) -> Optional[Mesh]:
    """The trainers' default: a flat mesh over the world when
    ``torch.distributed`` is initialised with more than one rank and
    ``batch`` divides it, else None (the JAX trainers' rule)."""
    if dist.is_initialized() and dist.get_world_size() > 1 and \
            batch % dist.get_world_size() == 0:
        return create_mesh()
    return None


# ------------------------------------------------------------------ trees

def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree: Any) -> List[Any]:
    out: list = []
    tree_map(out.append, tree)
    return out


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's rows of every leaf of a global host batch (numpy arrays
    or tensors, nested in tuples, lists or dicts), on the mesh's device.
    Ranks that differ only on ``model`` get the same rows."""
    def take(x):
        t = torch.as_tensor(x)
        return t[mesh.rows(t.shape[0])].to(mesh.device)
    return tree_map(take, batch)


def shard_replicated(mesh: Mesh, tree: Any) -> Any:
    """Rank 0's values on every rank: each tensor, and each parameter and
    buffer of each module, moved to the mesh's device and broadcast from
    rank 0 (in place for modules)."""
    def bcast(x):
        if isinstance(x, nn.Module):
            x.to(mesh.device)
            with torch.no_grad():
                for t in list(x.parameters()) + list(x.buffers()):
                    dist.broadcast(t.data, src=0)
            return x
        t = torch.as_tensor(x).to(mesh.device).contiguous()
        dist.broadcast(t, src=0)
        return t
    return tree_map(bcast, tree)


def pad_batch_to_multiple(batch: Any, multiple: int) -> tuple:
    """Pad every leaf's leading axis, repeating its last row, to a multiple
    of ``multiple``; -> (batch, n_real)."""
    leaves = _leaves(batch)
    if not leaves:
        return batch, 0
    n = np.asarray(leaves[0]).shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad = lambda x: np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)  # noqa: E731
    return tree_map(lambda x: pad(np.asarray(x)), batch), n


# ------------------------------------------------------------------ collectives

def _reduce_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``t`` over the batch group: on a hybrid mesh within
    the row, then across the rows."""
    if mesh.hybrid:
        dist.all_reduce(t, group=mesh.row_group)
        dist.all_reduce(t, group=mesh.col_group)
    else:
        dist.all_reduce(t, group=mesh.batch_group)
    return t


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the batch shards (no gradient)."""
    return _reduce_(mesh, t.detach().clone().contiguous())


def all_reduce_mean(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the batch shards (no gradient)."""
    return all_reduce_sum(mesh, t) / mesh.batch_shards


def all_gather_batch(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every shard's ``t`` concatenated along axis 0, in batch order (no
    gradient): this rank's rows back into the global batch."""
    t = t.detach().contiguous()
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t
    parts = [torch.empty_like(wire) for _ in range(mesh.batch_shards)]
    dist.all_gather(parts, wire, group=mesh.batch_group)
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def reduce_grads(mesh: Optional[Mesh], params: Sequence[torch.nn.Parameter]) -> None:
    """Replace each parameter's ``.grad`` with its mean over the batch shards
    (one all-reduce of every gradient at once; a missing gradient counts as
    zero on every rank). No-op without a mesh."""
    if mesh is None:
        return
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    _reduce_(mesh, flat)
    flat = flat / mesh.batch_shards
    i = 0
    for p, g in zip(params, grads):
        p.grad = flat[i:i + g.numel()].view_as(g).clone()
        i += g.numel()


class _BatchSum(torch.autograd.Function):
    """Sum over the batch shards whose backward is the same sum: every rank
    holds the global value, and the mean of the ranks' gradients is the
    gradient of the global value."""

    @staticmethod
    def forward(ctx, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
        ctx.mesh = mesh
        return _reduce_(mesh, x.clone().contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return None, _reduce_(ctx.mesh, g.clone().contiguous())


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("batch_mesh", default=None)


@contextlib.contextmanager
def batch_scope(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside, ``batch_sum`` and ``batch_mean`` reduce over ``mesh``'s batch
    shards; a None mesh leaves them the identity."""
    token = _ACTIVE.set(mesh)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's rows, as the sum over the global batch
    (differentiably) inside ``batch_scope``; ``x`` itself elsewhere."""
    mesh = _ACTIVE.get()
    return x if mesh is None else _BatchSum.apply(mesh, x)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over this rank's rows, as the mean over the global batch
    (equal shards) inside ``batch_scope``; ``x`` itself elsewhere."""
    mesh = _ACTIVE.get()
    return x if mesh is None else _BatchSum.apply(mesh, x) / mesh.batch_shards
