"""Host memory for the offload tiers (counterpart: the ``pinned_host``
memory kind that ``paddle_tpu/distributed/sharding/param_stream.py`` and
``group_sharded.py`` ``device_put`` to).

On a CUDA device "host" means page-locked (pinned) host memory, so a copy
either way is a DMA that runs beside the compute. A :class:`HostBuffer` is
one flat pinned buffer, cut from a larger block of PyTorch's pinned
allocator: that allocator rounds each block up to a power of two (a 402 MB
block of parameters would take 512 MiB), so the buffers are packed into
blocks of a power-of-two size (up to 4 GiB) and a block goes back to the
allocator when no buffer cut from it is left. If pinning fails the code
raises; it never carries on in pageable memory. On the CPU
(``device="cpu"``, the tests) "host" is plain CPU memory and a copy is a
CPU copy.

A :class:`Segment` is a tree (nested dicts) whose tensor leaves are views
of one flat buffer, each at a 256-byte aligned offset; a segment moves
between host and device as ONE copy of its buffer. :class:`Copier` issues
the host-to-device copies on one stream and the device-to-host copies on
another, so both overlap the compute stream: a fetch returns a handle whose
``get()`` makes the compute stream wait for the copy's event; a park waits
for the compute stream's event before it copies, and keeps the device
buffer alive until the copy is done (``record_stream``). ``drain()`` waits
for both streams: nothing reads a parked host tensor before then.
"""

from __future__ import annotations

import functools
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import _tree

__all__ = ["HostBuffer", "Segment", "Copier", "park", "fetch",
           "supports_pinned_host", "overlap_summary"]

ALIGN = 256          # byte offset of every leaf in a flat buffer


def _align(n: int, a: int = ALIGN) -> int:
    return (n + a - 1) // a * a


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


CHUNK_MIN = 64 << 20
CHUNK_MAX = 4 << 30
_blocks: List[weakref.ref] = []      # the live pinned blocks, first fit


class _Block:
    """A block of the pinned allocator and the bytes handed out of it."""

    def __init__(self, nbytes: int):
        self.tensor = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        if not self.tensor.is_pinned():
            raise RuntimeError(f"could not pin {nbytes} bytes of host memory")
        self.used = 0


def _pinned(nbytes: int):
    """(block, offset) of ``nbytes`` of pinned memory: the first live block
    with room, else a new block of a power-of-two size between CHUNK_MIN
    and CHUNK_MAX (or the request's own power of two above that)."""
    n = _align(max(nbytes, 1))
    _blocks[:] = [r for r in _blocks if r() is not None]
    for ref in _blocks:
        blk = ref()
        if blk is not None and blk.tensor.numel() - blk.used >= n:
            off, blk.used = blk.used, blk.used + n
            return blk, off
    size = max(CHUNK_MIN, min(CHUNK_MAX, 1 << (8 * n - 1).bit_length()))
    size = max(size, 1 << (n - 1).bit_length())
    blk = _Block(size)
    blk.used = n
    _blocks.append(weakref.ref(blk))
    return blk, 0


class HostBuffer:
    """``nbytes`` of host memory as one flat uint8 tensor (``tensor``):
    pinned when ``pinned`` (a slice of a pinned block this buffer keeps
    alive), plain CPU memory otherwise."""

    def __init__(self, nbytes: int, pinned: bool):
        self.nbytes = int(nbytes)
        self.pinned = bool(pinned)
        if not pinned:
            self.tensor = torch.empty(self.nbytes, dtype=torch.uint8)
            return
        self.block, off = _pinned(self.nbytes)
        self.tensor = self.block.tensor[off:off + self.nbytes]


Layout = List[Tuple[tuple, Tuple[int, ...], torch.dtype, int]]


def layout_of(tree) -> Tuple[Layout, int]:
    """(path, shape, dtype, byte offset) of each tensor leaf of ``tree`` in
    the tree's leaf order, and the flat size."""
    out, off = [], 0
    for path, t in _tree.flatten(tree):
        out.append((path, tuple(t.shape), t.dtype, off))
        off = _align(off + _nbytes(t))
    return out, off


class Segment(dict):
    """A nested dict whose leaves are views of ``buffer`` (flat uint8) at
    ``layout``'s offsets. ``owner`` keeps a host buffer's pinning alive."""

    buffer: torch.Tensor
    layout: Layout
    owner: Optional[HostBuffer]

    @classmethod
    def over(cls, buffer: torch.Tensor, layout: Layout, owner=None):
        vals = []
        for _, shape, dtype, off in layout:
            n = int(torch.Size(shape).numel()) * torch.empty(
                (), dtype=dtype).element_size()
            vals.append(buffer[off:off + n].view(dtype).view(shape))
        seg = cls(_tree.unflatten([p for p, *_ in layout], vals))
        seg.buffer, seg.layout, seg.owner = buffer, layout, owner
        return seg

    @classmethod
    def host(cls, layout: Layout, nbytes: int, pinned: bool):
        hb = HostBuffer(nbytes, pinned)
        return cls.over(hb.tensor, layout, hb)

    def like(self, pinned: bool) -> "Segment":
        """A new host Segment of this one's layout (its leaves outside the
        buffer are this one's)."""
        return _extras(Segment.host(self.layout, self.buffer.numel(), pinned),
                       self)


def _extras(seg: Segment, src: Segment) -> Segment:
    """``seg`` with the leaves of ``src`` that lie outside its buffer (kept
    on the device) set at their paths."""
    inside = {p for p, *_ in src.layout}
    for path, t in _tree.flatten(src):
        if path not in inside:
            d = seg
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = t
    return seg


class _Ready:
    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value


class _Fetched:
    """A host-to-device copy in flight; ``get()`` orders the compute
    stream after it and returns the device tree."""

    def __init__(self, value, bufs, event, device):
        self.value, self.bufs, self.event = value, bufs, event
        self.device = device

    def get(self):
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self.event)
        for b in self.bufs:
            b.record_stream(cur)
        return self.value


class Copier:
    """Host <-> device copies on their own streams (CUDA) or as plain CPU
    copies. ``stats`` counts the bytes each way; with ``trace`` on, every
    copy and every ``compute(...)`` span records CUDA events into
    ``timeline`` (read by :func:`overlap_summary` after ``drain()``)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(self.device)
            self.d2h = torch.cuda.Stream(self.device)
        self.stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        self.trace = False
        self.timeline: List[Tuple[str, Any, Any]] = []
        self.origin = None

    def reset(self):
        """Zero the counters; when tracing, start the timeline at an event
        that both copy streams wait on, so every span is taken from it."""
        self.stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        self.timeline = []
        self.origin = None
        if self.cuda and self.trace:
            self.origin = self._event()
            self.h2d.wait_event(self.origin)
            self.d2h.wait_event(self.origin)

    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=self.trace)
        ev.record(stream)
        return ev

    # -- host -> device ----------------------------------------------------
    def fetch(self, tree):
        """The device copy of a host tree: one copy of a Segment's buffer,
        leaf by leaf otherwise (a 0-dim leaf already on the device stays)."""
        if not self.cuda:
            if isinstance(tree, Segment):
                self.stats["h2d_bytes"] += tree.buffer.numel()
                return _Ready(_extras(Segment.over(tree.buffer.clone(),
                                                   tree.layout), tree))
            return _Ready(_tree.tree_map(self._fetch_leaf_cpu, tree))
        with torch.cuda.stream(self.h2d):
            t0 = self._event(self.h2d) if self.trace else None
            if isinstance(tree, Segment):
                dev = torch.empty(tree.buffer.numel(), dtype=torch.uint8,
                                  device=self.device)
                dev.copy_(tree.buffer, non_blocking=True)
                self.stats["h2d_bytes"] += tree.buffer.numel()
                value = _extras(Segment.over(dev, tree.layout), tree)
                bufs = [dev]
            else:
                bufs = []

                def one(t):
                    if t is None or t.device == self.device:
                        return t
                    d = t.to(self.device, non_blocking=True)
                    self.stats["h2d_bytes"] += _nbytes(t)
                    bufs.append(d)
                    return d
                value = _tree.tree_map(one, tree)
            ev = self._event(self.h2d)
            if self.trace:
                self.timeline.append(("h2d", t0, ev))
        return _Fetched(value, bufs, ev, self.device)

    def _fetch_leaf_cpu(self, t):
        if t is None:
            return t
        self.stats["h2d_bytes"] += _nbytes(t)
        return t.clone()

    # -- device -> host ----------------------------------------------------
    def park(self, dev_tree, host_tree):
        """Copy a device tree into the host tree of the same structure (one
        copy when both are Segments of one layout). The copy starts when
        the compute stream's work so far is done."""
        flat = (isinstance(dev_tree, Segment)
                and isinstance(host_tree, Segment)
                and dev_tree.layout == host_tree.layout)
        if not self.cuda:
            if flat:
                host_tree.buffer.copy_(dev_tree.buffer)
                self.stats["d2h_bytes"] += host_tree.buffer.numel()
            else:
                for (_, h), (_, d) in zip(_tree.flatten(host_tree),
                                          _tree.flatten(dev_tree)):
                    if h is not None and h is not d:
                        h.copy_(d)
                        self.stats["d2h_bytes"] += _nbytes(h)
            return host_tree
        ready = self._event()
        self.d2h.wait_event(ready)
        with torch.cuda.stream(self.d2h):
            t0 = self._event(self.d2h) if self.trace else None
            if flat:
                host_tree.buffer.copy_(dev_tree.buffer, non_blocking=True)
                if dev_tree.buffer.is_cuda:
                    dev_tree.buffer.record_stream(self.d2h)
                self.stats["d2h_bytes"] += host_tree.buffer.numel()
            else:
                for (_, h), (_, d) in zip(_tree.flatten(host_tree),
                                          _tree.flatten(dev_tree)):
                    if h is None or h is d:
                        continue
                    h.copy_(d, non_blocking=True)
                    if d.is_cuda:
                        d.record_stream(self.d2h)
                    self.stats["d2h_bytes"] += _nbytes(h)
            if self.trace:
                self.timeline.append(("d2h", t0, self._event(self.d2h)))
        return host_tree

    def park_new(self, dev_tree, keep=None):
        """A new host Segment (pinned for a CUDA device) holding
        ``dev_tree`` (leaves for which ``keep(leaf)`` is true stay where
        they are, outside the buffer)."""
        parked, kept = [], []
        for path, t in _tree.flatten(dev_tree):
            (kept if keep is not None and keep(t) else parked).append(
                (path, t))
        sub = _tree.unflatten([p for p, _ in parked], [t for _, t in parked])
        layout, nbytes = layout_of(sub)
        host = Segment.host(layout, nbytes, self.cuda)
        src = sub
        if self.cuda and not (isinstance(dev_tree, Segment)
                              and dev_tree.layout == layout):
            src = self.pack(sub, layout, nbytes)
        self.park(src, host)
        for path, t in kept:
            d = host
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = t
        return host

    def pack(self, tree, layout: Layout, nbytes: int) -> Segment:
        """The leaves of ``tree`` copied into one flat buffer on their
        device (one device-to-host copy then moves them all)."""
        leaves = [t for _, t in _tree.flatten(tree)]
        dev = leaves[0].device if leaves else self.device
        seg = Segment.over(torch.empty(nbytes, dtype=torch.uint8,
                                       device=dev), layout)
        for (_, d), t in zip(_tree.flatten(seg), leaves):
            d.copy_(t)
        return seg

    # -- compute spans and the end of a step --------------------------------
    def compute(self, tag: str):
        """A context that records the compute stream's span when tracing."""
        return _Span(self, tag)

    def drain(self):
        if self.cuda:
            self.h2d.synchronize()
            self.d2h.synchronize()
            torch.cuda.current_stream(self.device).synchronize()


class _Span:
    def __init__(self, copier: Copier, tag: str):
        self.copier, self.tag = copier, tag

    def __enter__(self):
        if self.copier.cuda and self.copier.trace:
            self.t0 = self.copier._event()
        return self

    def __exit__(self, *exc):
        if self.copier.cuda and self.copier.trace:
            self.copier.timeline.append((self.tag, self.t0,
                                         self.copier._event()))
        return False


def _union(spans):
    """Total length and the merged list of [a, b) spans."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _measure(merged):
    return sum(b - a for a, b in merged)


def _intersect(x, y):
    out, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap_summary(timeline, origin) -> Dict[str, float]:
    """From a drained Copier's ``timeline`` and ``origin`` event: the
    milliseconds the copies each way and the compute spans cover, and the
    share of the copy time that runs under compute."""
    if not timeline:
        return {}
    t0 = origin
    spans: Dict[str, list] = {"h2d": [], "d2h": [], "compute": []}
    for tag, a, b in timeline:
        key = tag if tag in ("h2d", "d2h") else "compute"
        spans[key].append((t0.elapsed_time(a), t0.elapsed_time(b)))
    u = {k: _union(v) for k, v in spans.items()}
    copies = _union(spans["h2d"] + spans["d2h"])
    copy_ms = _measure(copies)
    under = _intersect(copies, u["compute"])
    return {"h2d_ms": _measure(u["h2d"]), "d2h_ms": _measure(u["d2h"]),
            "copy_ms": copy_ms, "compute_ms": _measure(u["compute"]),
            "copy_under_compute_ms": under,
            "overlap_share": under / copy_ms if copy_ms else 0.0}


# ---------------------------------------------------------------------------
# the public park / fetch / supports_pinned_host
# ---------------------------------------------------------------------------
def _device(device):
    from ... import resolve_device
    return resolve_device(device)


@functools.lru_cache(maxsize=None)
def _pinned_ok(device_str: str) -> bool:
    if torch.device(device_str).type != "cuda":
        return False
    try:
        HostBuffer(ALIGN, pinned=True)
        return True
    except RuntimeError:
        return False


def supports_pinned_host(device=None) -> bool:
    """Whether ``device``'s host memory can be pinned: True on a CUDA card
    whose runtime pins memory, False for ``device="cpu"``."""
    return _pinned_ok(str(_device(device)))


def park(tree, device=None):
    """Every tensor leaf of ``tree`` in one new host buffer (pinned for a
    CUDA ``device``), returned as a :class:`Segment`; the copy is done when
    this returns."""
    dev = _device(device)
    c = Copier(dev)
    seg = c.park_new(tree)
    c.drain()
    return seg


def fetch(tree, device=None):
    """Every leaf of the host tree ``tree`` on ``device`` (one copy of a
    Segment's buffer); the copy is ordered before later work on the
    current stream."""
    return Copier(_device(device)).fetch(tree).get()
