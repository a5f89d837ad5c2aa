"""Prompt-count bucketing (copy of ``dilabhelmholtzoct_tpu/data/sampling.py``'s
``bucket_for``; the port imports nothing of the JAX package)."""

from __future__ import annotations

DEFAULT_BUCKETS = (8, 16, 32, 64)


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Smallest bucket holding ``n``; the largest bucket when none does."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
