"""The batch and the parameters under data parallelism.

Port of ``dilabhelmholtzoct_tpu/parallel/mesh.py``. There a ``('data',)``
mesh shards the batch over the local devices and replicates the
parameters; here each rank is one process on one card:

  * ``pad_to_multiple`` pads the host batch to a multiple of the rank count
    (a copy of the JAX function: pad rows get a zero ``channel_mask`` and
    the ``-1`` sentinel in ``indices``);
  * ``shard_batch`` takes this rank's ``process_slice`` of the padded host
    batch (``shard_batch(batch, mesh)`` there);
  * ``replicate`` broadcasts rank 0's parameters to every rank, in place, at
    the start of a run (``replicate(tree, mesh)`` there).

``set_kernel_mesh`` / ``kernel_mesh`` / ``shard_map_kernel`` have no
counterpart: each rank launches its kernels on its own rows, so GSPMD's
replication of opaque Pallas calls, which they work around, does not arise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from . import distributed as dist


def pad_to_multiple(batch: dict, multiple: int):
    """Pad the leading (batch) axis up to a multiple of the mesh size so the
    per-device shard is even; padded rows get zero channel_mask so they do
    not contribute to the loss."""
    b = next(iter(batch.values())).shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch, b
    out = {}
    for k, v in batch.items():
        pad_width = [(0, pad)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width)
    if "channel_mask" in out:
        out["channel_mask"][b:] = 0.0
    if "indices" in out:
        # -1 sentinel, same convention as the pipeline's last-batch padding
        # (data/pipeline.py): pad rows must never alias sample 0
        out["indices"][b:] = -1
    return out, b


def shard_batch(batch: dict) -> dict:
    """This rank's contiguous rows of every array of a padded host batch
    (the whole batch with no group)."""
    n_rows = next(iter(batch.values())).shape[0]
    sl = dist.process_slice(n_rows)
    return {k: v[sl] for k, v in batch.items()}


def replicate(tensors) -> None:
    """Overwrite each tensor with rank 0's, in place, one flat broadcast per
    (device, dtype) group; nothing with no group. Every rank passes the same
    tensors in the same order."""
    if not dist.is_initialized():
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    with torch.no_grad():
        for ts in groups.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            tdist.broadcast(flat, src=0)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
