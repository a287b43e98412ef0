"""A rank-0 TCP key-value store for rendezvous (counterpart:
``paddle_tpu/distributed/store.py``: ``StoreError``,
``TransientStoreError``, ``StoreTimeout``, ``retry_stats`` /
``reset_retry_stats``, ``_with_retry``, ``TCPStore``, ``MasterStore``).

The transport is ``torch.distributed.TCPStore``; the error classes and the
retry and timeout behaviour are the JAX module's: the idempotent calls
(connect, set, get, wait) retry a transient fault (a refused or dropped
connection) with exponential backoff and +/-50 % jitter under
``FLAGS_store_retry_max`` / ``_base_s`` / ``_max_s``, inside one deadline
for the whole call; ``add`` and ``compare_set`` never retry (the server may
have applied a call whose reply was lost) and raise
``TransientStoreError``; an expired deadline raises ``StoreTimeout``. The
JAX module's fault-injection points (its ``resilience.faults``) are not
ported.
"""

from __future__ import annotations

import random
import threading
import time
from datetime import timedelta
from typing import Callable, Dict, Optional, TypeVar

import torch.distributed as dist

from ..flags import flag

__all__ = ["TCPStore", "MasterStore", "StoreError", "TransientStoreError",
           "StoreTimeout", "retry_stats", "reset_retry_stats"]


class StoreError(RuntimeError):
    """Base class for key-value store failures."""


class TransientStoreError(StoreError):
    """A transient fault: refused connection, io error, dropped socket.
    connect / set / get / wait retry it; add / compare_set raise it at
    once, and the caller must treat it as indeterminate."""


class StoreTimeout(StoreError, TimeoutError):
    """The deadline expired (a key never appeared, a peer never answered).
    Not retried."""


_RETRY_STATS: Dict[str, int] = {}
_RETRY_LOCK = threading.Lock()
_T = TypeVar("_T")


def retry_stats() -> Dict[str, int]:
    """Per-op transient-retry counts (op -> retries)."""
    with _RETRY_LOCK:
        return dict(_RETRY_STATS)


def reset_retry_stats() -> None:
    with _RETRY_LOCK:
        _RETRY_STATS.clear()


def _with_retry(op: str, attempt: Callable[[], _T],
                deadline: Optional[float] = None) -> _T:
    """Run ``attempt``, retrying TransientStoreError with exponential
    backoff and jitter; StoreTimeout and other errors pass through.
    ``deadline`` (``time.monotonic``) caps the whole sequence."""
    attempts = max(1, int(flag("store_retry_max")))
    delay = float(flag("store_retry_base_s"))
    cap = float(flag("store_retry_max_s"))
    for k in range(attempts):
        try:
            return attempt()
        except TransientStoreError as e:
            with _RETRY_LOCK:
                _RETRY_STATS[op] = _RETRY_STATS.get(op, 0) + 1
            if k == attempts - 1:
                raise
            if deadline is not None and time.monotonic() >= deadline:
                raise StoreTimeout(
                    f"TCPStore.{op} deadline expired during transient-fault "
                    f"retry: {e}") from e
            time.sleep(min(cap, delay) * (0.5 + random.random()))
            delay *= 2


def _typed(op: str, e: Exception) -> StoreError:
    if isinstance(e, dist.DistNetworkError):
        return TransientStoreError(f"TCPStore.{op}: {e}")
    if isinstance(e, dist.DistStoreError) and "timeout" in str(e).lower():
        return StoreTimeout(f"TCPStore.{op} timed out: {e}")
    return TransientStoreError(f"TCPStore.{op}: {e}")


class TCPStore:
    """Key-value store client; rank 0 (``is_master=True``) also hosts the
    server. ``port=0`` on the master picks a free port (``.port``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 world_size: int = 1, is_master: bool = False,
                 timeout: Optional[float] = None):
        if timeout is None:
            timeout = float(flag("tcp_store_timeout_s"))
        self._timeout = float(timeout)
        self.host = host
        self.world_size = world_size
        self.is_master = is_master
        deadline = time.monotonic() + self._timeout

        def connect():
            rem = max(1e-3, deadline - time.monotonic())
            try:
                return dist.TCPStore(host, port, world_size, is_master,
                                     timeout=timedelta(seconds=rem),
                                     wait_for_workers=False)
            except (dist.DistError, RuntimeError) as e:
                raise TransientStoreError(
                    f"TCPStore: cannot reach {host}:{port}: {e}") from e
        try:
            self._store = _with_retry("connect", connect, deadline=deadline)
        except TransientStoreError as e:
            raise StoreTimeout(str(e)) from e
        self.port = self._store.port

    def _call(self, op, fn, timeout=None):
        to = self._timeout if timeout is None else float(timeout)
        deadline = time.monotonic() + to

        def attempt():
            try:
                return fn(max(1e-3, deadline - time.monotonic()))
            except (dist.DistError, RuntimeError) as e:
                raise _typed(op, e) from e
        return _with_retry(op, attempt, deadline=deadline)

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._call("set", lambda rem: self._store.set(key, bytes(value)))

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        def fn(rem):
            self._store.wait([key], timedelta(seconds=rem))
            return bytes(self._store.get(key))
        return self._call("get", fn, timeout)

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        if isinstance(keys, str):
            keys = [keys]
        self._call("wait", lambda rem: self._store.wait(
            list(keys), timedelta(seconds=rem)), timeout)

    def add(self, key: str, amount: int = 1) -> int:
        try:
            return int(self._store.add(key, amount))
        except (dist.DistError, RuntimeError) as e:
            raise TransientStoreError(f"TCPStore.add({key!r}): {e}") from e

    def delete_key(self, key: str) -> bool:
        return bool(self._store.delete_key(key))

    def num_keys(self) -> int:
        return int(self._store.num_keys())

    def compare_set(self, key: str, expected, desired) -> bytes:
        if isinstance(expected, str):
            expected = expected.encode()
        if isinstance(desired, str):
            desired = desired.encode()
        try:
            return bytes(self._store.compare_set(key, expected, desired))
        except (dist.DistError, RuntimeError) as e:
            raise TransientStoreError(
                f"TCPStore.compare_set({key!r}): {e}") from e

    def barrier(self, name: str = "barrier", timeout: Optional[float] = None):
        """Every one of ``world_size`` participants arrives before any
        leaves; reusable per name (each call is a new round)."""
        rounds = self.__dict__.setdefault("_barrier_rounds", {})
        r = rounds.get(name, 0)
        rounds[name] = r + 1
        n = self.add(f"__barrier/{name}/{r}/count", 1)
        if n == self.world_size:
            self.set(f"__barrier/{name}/{r}/go", b"1")
        self.wait([f"__barrier/{name}/{r}/go"], timeout)

    def close(self):
        self._store = None


def MasterStore(endpoint: str, world_size: int, rank: int,
                timeout: float = 300.0) -> TCPStore:
    """A store from a ``host:port`` endpoint (rank 0 hosts)."""
    host, port = endpoint.rsplit(":", 1)
    return TCPStore(host, int(port), world_size, is_master=(rank == 0),
                    timeout=timeout)
