"""Data parallelism over ``torch.distributed``: one process (rank) per
device, each on its share of the global batch's rows (counterpart of the
``data`` axis of ``lasr_tpu/parallel/mesh.py``).

``lasr_tpu`` runs data parallelism as one program on the global batch, so
an N-way data axis does not change a step's numbers.  The port keeps
that invariant: an N-rank step equals the one-process step on the global
batch, up to the order of float additions.  The global view shows up in
four places:

  - rows: ``shard_rows`` (and the dataset's ``batches``) give rank r of N
    rows ``r·B/N`` to ``(r+1)·B/N`` of the global batch, B padded to a
    multiple of N with zero-length rows (``pad_rows``), every rank padded
    to the global batch's sample and token lengths, with ``row0`` and the
    global batch's ``global_wav_len`` so that the frontend draws
    SpecAugment for the global rows;
  - BatchNorm sums (Σx, Σx², count) over the ranks with
    ``all_reduce_sum``, whose backward sums the incoming gradient: the
    cross-rank terms;
  - every loss denominator is a global count (``global_sum``), so each
    rank's loss is its share of the global loss and the global gradient
    is the sum of the ranks' gradients (``all_reduce_flat``, once per
    optimizer step);
  - rank 0 alone writes (``is_main``), and ``broadcast_module`` gives
    every rank rank 0's initial weights.

At world size 1 nothing is communicated: every function here returns its
input, and the one-device paths keep their numbers.

The grid (``init(..., model_parallel=M, seq_parallel=S,
pipeline_parallel=P)``, counterpart of the ``(data, pipe, seq, model)``
axes of ``lasr_tpu/parallel/mesh.py``, in ``make_mesh``'s order): rank r
is model index r % M, seq index (r // M) % S, pipe index (r // (M·S)) % P
and data index r // (M·S·P).  The P·S·M ranks of a data index hold the
same rows and share a dropout generator: the model ranks split each
tensor-parallel layer (``parallel.tensor``), the seq ranks the encoder's
time (``seq_split``: the Conformer and Transformer encoders), the pipe
ranks its blocks (``modules.pipeline``).  The ranks of one (pipe, seq,
model) index (a data group) split the batch, and the four data-parallel
places above run over the data group only, BatchNorm's sums over data x
seq while the time is split.  With P = S = M = 1 the data group is the
whole world.

Ranks come from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
or from ``spawn`` (one host, a ``Rendezvous`` per rank).  The backend is
``nccl`` for CUDA devices and ``gloo`` for the CPU unless ``init`` is
given one: two ``gloo`` ranks can share one card, which NCCL refuses.
``all_reduce`` and ``broadcast`` run on the devices' tensors; FSDP's
``all_gather`` / ``reduce_scatter`` (``gather_dim`` / ``reduce_scatter_dim``)
go through host memory under ``gloo`` with CUDA tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
import os
import socket
from datetime import timedelta
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this raises: a rank that died leaves
# the others waiting at most this long (the data check of a large corpus
# runs before the first collective, on every rank at once)
DEFAULT_TIMEOUT_S = 1800.0


class Rendezvous(NamedTuple):
    """Where rank ``rank`` of ``world_size`` meets the others."""
    rank: int
    world_size: int
    init_method: str


AXES = ("data", "pipe", "seq", "model")


class Grid(NamedTuple):
    """A rank's place in the (data, pipe, seq, model) grid: each axis's
    size, this rank's index on it and its process group (None: the whole
    world where the axis is the world, no group for a size of 1); and
    the data x seq group (``data_seq``), over which BatchNorm sums while
    the encoder's time is split."""
    data_size: int
    model_size: int
    data_rank: int
    model_rank: int
    data: Optional[object]
    model: Optional[object]
    pipe_size: int = 1
    pipe_rank: int = 0
    pipe: Optional[object] = None
    seq_size: int = 1
    seq_rank: int = 0
    seq: Optional[object] = None
    data_seq: Optional[object] = None


# the grid of the process group that ``init`` joined (set with it, cleared
# by ``shutdown``; torch.distributed's own group is process-wide too)
_GRID: List[Grid] = []


def grid() -> Grid:
    """This rank's grid; without one, a data axis over the whole world."""
    if _GRID:
        return _GRID[0]
    return Grid(world_size(), 1, rank(), 0, None, None)


def data_size() -> int:
    """The data-parallel ranks: the world divided by the other axes."""
    return grid().data_size


def data_rank() -> int:
    return grid().data_rank


def model_size() -> int:
    """The tensor-parallel ranks of a model group (1 without one)."""
    return grid().model_size


def model_rank() -> int:
    return grid().model_rank


def seq_size() -> int:
    """The sequence-parallel ranks of a seq group (1 without one)."""
    return grid().seq_size


def seq_rank() -> int:
    return grid().seq_rank


def pipe_size() -> int:
    """The pipeline ranks of a pipe group (1 without one)."""
    return grid().pipe_size


def pipe_rank() -> int:
    return grid().pipe_rank


def replicas() -> int:
    """The ranks of a data index: pipe x seq x model."""
    g = grid()
    return g.pipe_size * g.seq_size * g.model_size


def _make_grid(model_parallel: int, seq_parallel: int = 1,
               pipeline_parallel: int = 1) -> Grid:
    """Every rank makes every group, in the same order (new_group's
    rule)."""
    n, r = world_size(), rank()
    for flag, k in (("pipeline_parallel", pipeline_parallel),
                    ("seq_parallel", seq_parallel),
                    ("model_parallel", model_parallel)):
        if k < 1:
            raise ValueError(f"-{flag} {k}: expected a count >= 1")
    inner = pipeline_parallel * seq_parallel * model_parallel
    if n % inner:
        raise ValueError(f"-pipeline_parallel {pipeline_parallel} x "
                         f"-seq_parallel {seq_parallel} x -model_parallel "
                         f"{model_parallel} = {inner} does not divide the "
                         f"world size {n}")
    shape = (n // inner, pipeline_parallel, seq_parallel, model_parallel)
    coords = list(itertools.product(*map(range, shape)))
    mine = coords[r]

    def group(axes):
        """The group of the ranks that differ from this one on ``axes``
        alone (made on every rank, for every such set, in one order)."""
        if all(shape[AXES.index(a)] == 1 for a in axes):
            return None
        if len(coords) == math.prod(shape[AXES.index(a)] for a in axes):
            return None
        fixed = [i for i, a in enumerate(AXES) if a not in axes]
        found = None
        keys = sorted({tuple(c[i] for i in fixed) for c in coords})
        for key in keys:
            members = [j for j, c in enumerate(coords)
                       if tuple(c[i] for i in fixed) == key]
            g = dist.new_group(members)
            if key == tuple(mine[i] for i in fixed):
                found = g
        return found

    groups = {a: group((a,)) for a in AXES}
    return Grid(shape[0], shape[3], mine[0], mine[3], groups["data"],
                groups["model"], shape[1], mine[1], groups["pipe"],
                shape[2], mine[2], groups["seq"], group(("data", "seq")))


def world_size() -> int:
    """The process group's size; 1 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main() -> bool:
    """Rank 0: the rank that writes checkpoints, hparams and metrics."""
    return rank() == 0


def launched_by_torchrun() -> bool:
    """Whether the environment names this process's rank (``torchrun``
    and other ``env://`` launchers)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def layout() -> Tuple[int, int, int, int]:
    """(host index, host count, data rank on the host, data ranks on the
    host).

    Under ``torchrun`` the ranks on a host are ``LOCAL_WORLD_SIZE``, and
    rank r lies on host r // LOCAL_WORLD_SIZE; ``spawn``'s ranks are one
    host.  The dataset hands the hosts whole batches round-robin (as
    ``lasr_tpu`` hands its processes) and a host's data ranks its rows;
    the pipe, seq and model ranks of a data index take the same rows."""
    n, r = world_size(), rank()
    if n == 1:
        return 0, 1, 0, 1
    m = replicas()
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if local_n < 1 or n % local_n or local_n % m:
        raise RuntimeError(f"LOCAL_WORLD_SIZE={local_n} does not divide "
                           f"the world size {n} in whole data indices of "
                           f"{m} ranks")
    return r // local_n, n // local_n, (r % local_n) // m, local_n // m


def init(device, backend: Optional[str] = None,
         rendezvous: Optional[Rendezvous] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S,
         model_parallel: int = 1, seq_parallel: int = 1,
         pipeline_parallel: int = 1) -> str:
    """Join this rank's process group and return its backend; the grid's
    model, seq and pipe axes have ``model_parallel``, ``seq_parallel``
    and ``pipeline_parallel`` ranks (``Grid``).

    ``rendezvous``: ``spawn``'s; without one, ``torchrun``'s environment
    (``env://``) when it is set, else a group of one.  ``backend``
    defaults to ``nccl`` on a CUDA ``device`` and ``gloo`` on the CPU.
    Every collective of the group raises after ``timeout_s``.  With
    several ranks, NCCL makes its communicator at once and a first
    all-reduce on ``device`` checks that every rank joined and that the
    backend moves the device's tensors; a failure raises.  A group of
    one communicates nothing, so it makes no communicator."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if rendezvous is not None:
        world = rendezvous.world_size
    elif launched_by_torchrun():
        world = int(os.environ["WORLD_SIZE"])
    else:
        world = 1
    kw = dict(backend=backend, timeout=timedelta(seconds=timeout_s))
    if backend == "nccl":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if world > 1:
            kw["device_id"] = device
    if rendezvous is not None:
        dist.init_process_group(init_method=rendezvous.init_method,
                                rank=rendezvous.rank,
                                world_size=rendezvous.world_size, **kw)
    elif launched_by_torchrun():
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    if world > 1:
        probe = torch.ones((), device=device)
        dist.all_reduce(probe)
        if int(probe.item()) != world:
            shutdown()
            raise RuntimeError(f"the {backend} group's first all-reduce "
                               f"gave {float(probe)}, not its size {world}")
    try:
        set_grid(model_parallel, seq_parallel, pipeline_parallel)
    except ValueError:
        shutdown()
        raise
    return backend


def set_grid(model_parallel: int = 1, seq_parallel: int = 1,
             pipeline_parallel: int = 1) -> Grid:
    """(Re)divide the joined group into the grid of these axes (every
    rank calls it, with the same sizes) and return this rank's place."""
    _GRID[:] = [_make_grid(model_parallel, seq_parallel, pipeline_parallel)]
    return _GRID[0]


def shutdown() -> None:
    """Leave the process group, if there is one."""
    _GRID.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the data ranks by
    default), differentiable: the backward sums the incoming gradient over
    them, so that each rank's gradient is its share of the gradient of the
    summed losses.  ``x`` itself with one rank."""
    size, handle = _group(group)
    return x if size == 1 else _AllReduceSum.apply(x, handle)


@torch.no_grad()
def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks, outside autograd (a count, a
    metric).  ``x`` itself with one data rank."""
    g = grid()
    if g.data_size == 1:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=g.data)
    return out


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    group: str = "data") -> List[torch.Tensor]:
    """The sum over the ranks of ``group`` (an axis, "data_seq" or
    "world") of each of ``tensors`` (one dtype), through one all-reduce
    of a flat buffer.  The tensors themselves where the group is one
    rank."""
    size, handle = _group(group)
    if size == 1 or not tensors:
        return list(tensors)
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("all_reduce_flat takes tensors of one dtype")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=handle)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _group(name: str):
    """(size, process group handle) of an axis of the grid, of
    "data_seq" or of "world"."""
    g = grid()
    if name == "world":
        return world_size(), None
    if name == "data_seq":
        return g.data_size * g.seq_size, g.data_seq
    if name in AXES:
        return getattr(g, f"{name}_size"), getattr(g, name)
    raise ValueError(f"unknown group {name!r}")


def group_size(name: str) -> int:
    """The ranks of an axis of the grid, of "data_seq" or of "world"."""
    return _group(name)[0]


def _host_route(t: torch.Tensor) -> bool:
    """gloo's all_gather / reduce_scatter take CPU tensors."""
    return t.is_cuda and dist.get_backend() == "gloo"


@torch.no_grad()
def gather_dim(x: torch.Tensor, dim: int, group: str) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in rank
    order (not differentiable); ``x`` itself for a group of one."""
    size, handle = _group(group)
    if size == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    dev = src.device
    if _host_route(src):
        src = src.cpu()
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=handle)
    return out.to(dev).movedim(0, dim).contiguous()


@torch.no_grad()
def reduce_scatter_dim(x: torch.Tensor, dim: int,
                       group: str = "data") -> torch.Tensor:
    """This rank's part (its 1/size along ``dim``) of the sum of the
    ranks' ``x`` over ``group``; ``x`` itself for a group of one."""
    size, handle = _group(group)
    if size == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    dev = src.device
    if _host_route(src):
        src = src.cpu()
    out = src.new_empty((src.shape[0] // size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=handle)
    return out.to(dev).movedim(0, dim).contiguous()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers into every rank's ``module`` (one
    broadcast per dtype): every rank starts from the same weights and
    BatchNorm statistics, however it was seeded."""
    if world_size() == 1:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, 0)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def broadcast_int(value: int, device) -> int:
    """Rank 0's ``value`` on every rank."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return int(t.item())


def barrier(device) -> None:
    """Wait until every rank got here (an all-reduce on ``device``)."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros((), device=device))


# ---- tensor parallelism's collectives (parallel/tensor.py) ----

def _model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model ranks, in float32, in x's dtype."""
    out = x.float().contiguous()
    dist.all_reduce(out, group=grid().model)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _model_sum(grad)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _model_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-1]
        return gather_dim(x.float(), x.ndim - 1, "model").to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        r = model_rank()
        return grad.narrow(-1, r * ctx.n, ctx.n).contiguous()


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, start, n):
        ctx.meta = (x.shape, dim, start, n)
        return x.narrow(dim, start, n).clone()

    @staticmethod
    def backward(ctx, grad):
        shape, dim, start, n = ctx.meta
        full = grad.new_zeros(shape)
        full.narrow(dim, start, n).copy_(grad)
        return _model_sum(full), None, None, None


def copy_to_model(x):
    return _CopyToModel.apply(x)


def reduce_from_model(x):
    return _ReduceFromModel.apply(x)


def gather_from_model(x):
    return _GatherFromModel.apply(x)


def slice_replicated(x, dim: int):
    """The model rank's 1/N of the replicated ``x`` along ``dim``."""
    n = x.shape[dim] // model_size()
    return _SliceReplicated.apply(x, dim, model_rank() * n, n)


# ---- sequence parallelism: the encoder's time split over the seq ranks ----

class SeqSplit(NamedTuple):
    """The seq rank's rows of a time axis of ``length`` (a multiple of
    ``size``): ``local`` rows from ``offset``."""
    rank: int
    size: int
    length: int

    @property
    def local(self) -> int:
        return self.length // self.size

    @property
    def offset(self) -> int:
        return self.rank * self.local


_SEQ: contextvars.ContextVar = contextvars.ContextVar(
    "lasr_tpu_torch_seq_split", default=None)


@contextlib.contextmanager
def seq_split(length: int):
    """Inside the block, the encoder's blocks see this seq rank's rows of
    a ``length``-frame time axis (``current_seq_split``)."""
    g = grid()
    if length % g.seq_size:
        raise ValueError(f"{length} frames do not split over "
                         f"{g.seq_size} seq ranks")
    token = _SEQ.set(SeqSplit(g.seq_rank, g.seq_size, length))
    try:
        yield _SEQ.get()
    finally:
        _SEQ.reset(token)


def current_seq_split() -> Optional[SeqSplit]:
    """The innermost ``seq_split`` block's split, or None."""
    return _SEQ.get()


def _seq_all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    return gather_dim(x.float(), dim, "seq").to(x.dtype)


class _SeqGather(torch.autograd.Function):
    """All-gather along ``dim``; the backward sums the ranks' gradients of
    the whole and keeps the rank's part (reduce-scatter): for keys,
    values and a kernel's operands, which every rank's rows read."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.meta = (dim, x.dtype)
        return _seq_all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, dtype = ctx.meta
        return reduce_scatter_dim(grad.float(), dim, "seq").to(dtype), None


class _SeqGatherOwn(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps the rank's part of the
    gradient: for the encoder's output, whose loss every seq rank
    computes alike."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.meta = (dim, x.shape[dim], seq_rank())
        return _seq_all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        dim, n, r = ctx.meta
        return grad.narrow(dim, r * n, n).contiguous(), None


def seq_gather(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The seq ranks' ``x`` concatenated along ``dim``, differentiable (a
    reduce-scatter backward)."""
    return x if seq_size() == 1 else _SeqGather.apply(x, dim)


def seq_gather_output(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``seq_gather`` whose backward takes the rank's rows of a gradient
    that every seq rank holds whole."""
    return x if seq_size() == 1 else _SeqGatherOwn.apply(x, dim)


# ---- pipeline parallelism: point to point between pipe ranks ----

def _pipe_peer(offset: int) -> int:
    """The world rank of the pipe rank ``offset`` away (same data, seq
    and model index)."""
    g = grid()
    return rank() + offset * g.seq_size * g.model_size


class _Sent(NamedTuple):
    work: object
    buf: torch.Tensor

    def wait(self) -> None:
        self.work.wait()


def pipe_send(x: torch.Tensor, offset: int) -> _Sent:
    """Start sending ``x`` to the pipe rank ``offset`` away (under
    ``gloo`` a CUDA tensor goes through host memory); ``wait()`` on the
    result ends it."""
    src = x.detach().contiguous()
    if _host_route(src):
        src = src.cpu()
    return _Sent(dist.isend(src, _pipe_peer(offset)), src)


def pipe_recv(like: torch.Tensor, offset: int) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device from the pipe rank
    ``offset`` away."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _host_route(like) else like.device)
    dist.recv(buf, _pipe_peer(offset))
    return buf.to(like.device)


@torch.no_grad()
def pipe_broadcast(x: torch.Tensor, src: int) -> torch.Tensor:
    """Pipe rank ``src``'s ``x`` on every pipe rank (in place)."""
    size, handle = _group("pipe")
    if size == 1:
        return x
    root = rank() + (src - pipe_rank()) * grid().seq_size * grid().model_size
    dist.broadcast(x, root, group=handle)
    return x


# ---- rows of a global batch ----

BATCH_KEYS = ("wav_array", "wav_len", "token_id", "token_len")


def pad_rows(batch: Dict, multiple: int) -> Dict:
    """``batch`` ({wav_array, wav_len, token_id, token_len}, numpy) with
    its rows padded to a multiple of ``multiple`` by zero-length rows, as
    the dataset's ``batch_pad_multiple`` pads: the one-process batch that
    an N-rank step on ``shard_rows`` equals."""
    B = len(batch["wav_len"])
    pad = -B % multiple
    out = dict(batch)
    for k in BATCH_KEYS:
        a = np.asarray(batch[k])
        out[k] = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return out


def shard_rows(batch: Dict, rank: int, world_size: int) -> Dict:
    """Rank ``rank``'s rows of a global host batch: B padded to a multiple
    of ``world_size`` (``pad_rows``), rows ``rank·b`` to ``(rank+1)·b``
    with b = B / world_size, and ``row0`` and ``global_wav_len`` (the
    global batch's (B,) wave lengths), which the Trainer needs under a
    process group."""
    full = pad_rows(batch, world_size)
    b = len(full["wav_len"]) // world_size
    rows = slice(rank * b, (rank + 1) * b)
    out = {k: full[k][rows] for k in BATCH_KEYS}
    out.update(row0=rank * b, global_wav_len=full["wav_len"],
               n_utts=int((np.asarray(batch["wav_len"]) > 0).sum()))
    return out


# ---- the launcher ----

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank_: int, fn, nprocs: int, init_method: str, args) -> None:
    fn(Rendezvous(rank_, nprocs, init_method), *args)


def spawn(fn, nprocs: int, args: Tuple = ()) -> None:
    """Run ``fn(rendezvous, *args)`` in ``nprocs`` processes of this host
    (``spawn`` start method: CUDA must not be forked), rank i in the i-th,
    and wait for all of them.  A rank that fails ends the others and
    raises here.  ``fn`` must be importable by name (a module-level
    function)."""
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    torch.multiprocessing.start_processes(
        _spawned, args=(fn, nprocs, init_method, args), nprocs=nprocs,
        join=True, start_method="spawn")
