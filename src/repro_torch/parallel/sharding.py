"""What one rank holds under a ``("data", "model")`` mesh (port of the part
of ``repro.parallel.sharding`` that the serving path shards).

Each function is a pure function of a shape and the mesh: the slice of the
global dimension that rank ``(batch_rank, model_rank)`` keeps. They follow
the reference's specs where those shard:

* :func:`slot_rows` — the expert slot rows of the EP regime
  (``param_spec``: the slot dim over ``model``);
* :func:`cache_slots` — the dense KV cache's sequence dim (the
  reference's ``seq_parallel_kv`` layout, ``cache_specs``' ``kv_spec``:
  S over ``model``);
* :func:`batch_rows` — the batch over ``data`` (``batch_spec_for``).

Where the reference degrades a non-dividing dim to another layout
(hidden-dim ESP sharding, KV-head sharding, replication), the port raises:
those layouts are tensor parallelism, a later item (ROADMAP Queue 1
item 5).
"""

from __future__ import annotations


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise NotImplementedError(
            f"{what}={n} does not divide the {parts}-way mesh axis; the "
            f"reference falls back to another layout there, which the port "
            f"does not have yet (ROADMAP Queue 1 item 5)"
        )
    size = n // parts
    return slice(index * size, (index + 1) * size)


def slot_rows(n_slots: int, n_model: int, model_rank: int) -> slice:
    """The expert slot rows a rank holds: ``[r*spd, (r+1)*spd)`` with
    ``spd = n_slots / n_model``."""
    return _block(n_slots, n_model, model_rank, "n_slots")


def cache_slots(cache_len: int, n_model: int, model_rank: int) -> slice:
    """The dense cache slots (sequence positions of the ring) a rank
    holds."""
    return _block(cache_len, n_model, model_rank, "cache length")


def batch_rows(batch: int, n_batch: int, batch_rank: int) -> slice:
    """The requests a rank serves."""
    return _block(batch, n_batch, batch_rank, "batch")
