"""Data parallelism over ``torch.distributed``: one process per card.

Port of ``dilabhelmholtzoct_tpu/parallel/distributed.py``. The JAX package
runs data parallelism as one process over every local device (and one per
host across hosts): the batch is sharded, the parameters replicated, and
XLA inserts the gradient all-reduce. PyTorch does the same work with one
process per card: ``initialize`` joins the group, every rank iterates the
same seeded batches and takes its ``process_slice`` of each, and the
trainer sums the gradients over the ranks itself (``all_reduce_sum_``).

The sharded JAX step is the single-device step on the padded global batch.
``global_count`` and ``mean_share`` keep that meaning here: a rank's loss is
its local numerator over the global batch's denominator, so the losses and
their gradients summed over the ranks are those of the whole batch. With no
group every helper is the identity, and the single-process path runs the
same operations as before.

``global_batch_array`` has no counterpart: each rank holds its own rows as
a plain tensor on its card, and nothing assembles a global array.
"""

from __future__ import annotations

import os
import warnings

import torch
import torch.distributed as tdist


def _env_int(name: str) -> int | None:
    return int(os.environ[name]) if name in os.environ else None


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    explicit: bool = False,
    backend: str | None = None,
) -> bool:
    """Join the process group from the arguments or the env ``torchrun``
    sets. Returns True when a group of more than one process is up.

    Env fallbacks: ``MASTER_ADDR`` / ``MASTER_PORT`` (the coordinator,
    "host:port"), ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the card
    under NCCL. Partial information warns (``RuntimeWarning``) and is
    ignored. With none, ``explicit=False`` returns False; ``explicit=True``
    (the trainer passes it for ``multihost``) warns that it continues
    single-process. A second call returns what the first did.

    ``backend``: "nccl" (CUDA tensors) or "gloo" (CPU tensors, and CUDA
    tensors through the host); by default NCCL where a card is present,
    else gloo. The choice is never changed behind the caller's back."""
    if is_initialized():
        return tdist.get_world_size() > 1
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr is not None and port is not None:
            coordinator_address = f"{addr}:{port}"
        elif addr is not None or port is not None:
            coordinator_address = ""  # half of it: partial information
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    have_all = (bool(coordinator_address) and num_processes is not None
                and process_id is not None)
    if not have_all:
        if any(v is not None
               for v in (coordinator_address, num_processes, process_id)):
            warnings.warn(
                "partial multihost coordinator info found (need ALL of "
                "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK); ignoring it "
                "and running single-process", RuntimeWarning, stacklevel=2)
        if explicit:
            warnings.warn(
                "multihost was requested but no coordinator info was found "
                "(set MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK, as torchrun "
                "does); continuing SINGLE-process", RuntimeWarning,
                stacklevel=2)
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return tdist.get_world_size() > 1


def is_initialized() -> bool:
    """True while a process group is up: the data-parallel path."""
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """The card of this rank on its host (``LOCAL_RANK``, 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def process_slice(n_rows: int) -> slice:
    """Contiguous slice of a global batch owned by this process.

    n_rows must already be padded to a multiple of the process count
    (``parallel/mesh.pad_to_multiple``)."""
    pc = process_count()
    assert n_rows % pc == 0, (n_rows, pc)
    per = n_rows // pc
    pi = process_index()
    return slice(pi * per, (pi + 1) * per)


def global_count(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, without a gradient (a loss
    denominator: every rank divides by the whole batch's count); ``x``
    itself with no group."""
    if not is_initialized():
        return x
    out = x.detach().clone()
    tdist.all_reduce(out)
    return out


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """``x.mean()`` scaled to this rank's share of the global mean: the
    ranks' values sum to the mean over every rank's elements. With no group
    ``x.mean()``; with equal shards the scale is 1 / world size."""
    m = x.mean()
    if not is_initialized():
        return m
    n = torch.tensor(float(x.numel()), device=x.device)
    return m * (n / global_count(n))


def all_reduce_sum_(tensors) -> None:
    """Sum each tensor over the ranks, in place, as one flat bucket (the
    tensors share one dtype; every rank passes the same tensors in the same
    order); nothing with no group."""
    if not is_initialized():
        return
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def barrier() -> None:
    """Wait for every rank (nothing with no group)."""
    if is_initialized():
        tdist.barrier()


def shutdown() -> None:
    """Leave the group, so that a later ``initialize`` may join another."""
    if is_initialized():
        tdist.destroy_process_group()
