"""Size-targeted gradient buckets for the bucketed dp collectives
(counterpart: ``paddle_tpu/distributed/comm_overlap/bucketing.py``:
``LeafSlot``, ``Bucket``, ``BucketPlan``, ``build_bucket_plan``,
``pack_bucket``, ``unpack_bucket``, ``local_shape``).

A :class:`BucketPlan` is shape metadata: the same partition of leaves as
the JAX package's for the same shapes, dtypes and ``bucket_bytes`` (leaves
in REVERSE tree order, the order backward finishes them, filled greedily
until a bucket holds at least ``bucket_bytes``). Each bucket travels as
one flat buffer, so small leaves never pay a collective each.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Sequence, Tuple

import torch

__all__ = ["LeafSlot", "Bucket", "BucketPlan", "build_bucket_plan",
           "pack_bucket", "unpack_bucket", "local_shape", "ShapeDtype"]


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype without its data (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's place inside a bucket's flat buffer."""
    leaf_index: int          # position in the tree's flat leaf list
    shape: Tuple[int, ...]
    dtype: Any
    offset: int              # element offset inside the bucket's buffer

    @property
    def size(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1


@dataclasses.dataclass(frozen=True)
class Bucket:
    index: int
    slots: Tuple[LeafSlot, ...]

    @property
    def size(self) -> int:
        return sum(s.size for s in self.slots)

    @property
    def nbytes(self) -> int:
        return sum(s.size * s.dtype.itemsize for s in self.slots)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    n_leaves: int            # leaves of the source list (None entries too)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def local_sizes(self) -> List[int]:
        return [b.size for b in self.buckets]


def build_bucket_plan(leaves: Sequence[Any], bucket_bytes: float,
                      reverse: bool = True) -> BucketPlan:
    """Partition ``leaves`` (tensors or :class:`ShapeDtype`; None entries
    are skipped) into buckets of at least ``bucket_bytes`` each;
    ``bucket_bytes <= 0`` puts everything in one bucket."""
    order = range(len(leaves) - 1, -1, -1) if reverse else range(len(leaves))
    buckets: List[Bucket] = []
    cur: List[LeafSlot] = []
    cur_bytes = 0
    cur_off = 0

    def close():
        nonlocal cur, cur_bytes, cur_off
        if cur:
            buckets.append(Bucket(index=len(buckets), slots=tuple(cur)))
            cur, cur_bytes, cur_off = [], 0, 0

    for i in order:
        leaf = leaves[i]
        if leaf is None:
            continue
        slot = LeafSlot(leaf_index=i,
                        shape=tuple(int(d) for d in leaf.shape),
                        dtype=leaf.dtype, offset=cur_off)
        cur.append(slot)
        cur_off += slot.size
        cur_bytes += slot.size * leaf.dtype.itemsize
        if bucket_bytes > 0 and cur_bytes >= bucket_bytes:
            close()
    close()
    return BucketPlan(buckets=tuple(buckets), n_leaves=len(leaves))


def pack_bucket(leaves: Sequence[torch.Tensor], bucket: Bucket,
                dtype=None) -> torch.Tensor:
    """The bucket's leaves concatenated into one flat buffer. ``dtype`` None
    takes the widest leaf dtype (a bf16 / fp32 bucket travels in fp32)."""
    if dtype is None:
        dtype = leaves[bucket.slots[0].leaf_index].dtype
        for s in bucket.slots[1:]:
            dtype = torch.promote_types(dtype, leaves[s.leaf_index].dtype)
    parts = [leaves[s.leaf_index].reshape(-1).to(dtype)
             for s in bucket.slots]
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)


def unpack_bucket(flat: torch.Tensor, bucket: Bucket,
                  cast_back: bool = True) -> List[Tuple[int,
                                                        torch.Tensor]]:
    """(leaf_index, leaf) pairs out of a bucket's flat buffer (the inverse
    of ``pack_bucket``); the leaves are views of ``flat`` unless cast."""
    out = []
    for s in bucket.slots:
        piece = flat[s.offset:s.offset + s.size].view(s.shape)
        if cast_back:
            piece = piece.to(s.dtype)
        out.append((s.leaf_index, piece))
    return out


def local_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """A leaf's per-rank shape under a spec (a tuple of mesh axis names,
    tuples of them, or None per dim)."""
    out = [int(d) for d in shape]
    for d, entry in enumerate(tuple(spec)[:len(out)]):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[d] //= mesh.shape[a]
    return tuple(out)
