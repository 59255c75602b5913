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

Ranks come from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
or from ``spawn`` (one host, a ``Rendezvous`` per rank).  The backend is
``nccl`` for CUDA devices and ``gloo`` for the CPU unless ``init`` is
given one: two ``gloo`` ranks can share one card, which NCCL refuses.
Only ``all_reduce`` and ``broadcast`` are used; both backends run them on
CUDA tensors.
"""

from __future__ import annotations

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
    """(host index, host count, rank on the host, ranks on the host).

    Under ``torchrun`` the ranks on a host are ``LOCAL_WORLD_SIZE``, and
    rank r lies on host r // LOCAL_WORLD_SIZE; ``spawn``'s ranks are one
    host.  The dataset hands the hosts whole batches round-robin (as
    ``lasr_tpu`` hands its processes) and a host's ranks its rows."""
    n, r = world_size(), rank()
    if n == 1:
        return 0, 1, 0, 1
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if local_n < 1 or n % local_n:
        raise RuntimeError(f"LOCAL_WORLD_SIZE={local_n} does not divide "
                           f"the world size {n}")
    return r // local_n, n // local_n, r % local_n, local_n


def init(device, backend: Optional[str] = None,
         rendezvous: Optional[Rendezvous] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join this rank's process group and return its backend.

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
    return backend


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the backward sums
    the incoming gradient over the ranks, so that each rank's gradient is
    its share of the gradient of the summed losses.  ``x`` itself at
    world size 1."""
    return x if world_size() == 1 else _AllReduceSum.apply(x)


@torch.no_grad()
def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, outside autograd (a count, a
    metric).  ``x`` itself at world size 1."""
    if world_size() == 1:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out)
    return out


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over the ranks of each of ``tensors`` (one dtype), through
    one all-reduce of a flat buffer.  The tensors themselves at world size
    1."""
    if world_size() == 1:
        return list(tensors)
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("all_reduce_flat takes tensors of one dtype")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


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
    global_sum(torch.zeros((), device=device))


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
