"""Batched device→host fetches: one stacked d2h transfer per stage.

Partition kernels register their device outputs as *slots* instead of
fetching eagerly; `Backend.map_collect` flushes every pending slot in one
concatenated transfer when the stage's partitions are done, so a 4-partition method call pays one
d2h transfer instead of four. (The reference's analogue is the driver
decoding all partitions' result bytes in one pass, Backend.scala:28-47.)

Slots resolve transparently: accessing a slot's host value before the stage
flush triggers an early flush of everything pending (correct, just smaller
batches).
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import List, Optional

import numpy as np

_lock = threading.Lock()
# entries are Slots (strong, until the owning stage ends) or weakrefs
# (after a lazy stage_end: live columns keep their slots alive, discarded
# batches free their device buffers)
_pending: List[object] = []
_policy = threading.local()


def _live(entry) -> Optional['Slot']:
    s = entry() if isinstance(entry, weakref.ref) else entry
    return s if (s is not None and s.host is None) else None


class Slot:
    """A pending device array; `get()` returns the host numpy array."""

    __slots__ = ('dev', 'host', '__weakref__')

    def __init__(self, dev):
        self.dev = dev
        self.host: Optional[np.ndarray] = None

    def get(self) -> np.ndarray:
        if self.host is None:
            flush()
        assert self.host is not None
        return self.host


def defer(dev) -> Slot:
    s = Slot(dev)
    with _lock:
        _pending.append(s)
    return s


@contextlib.contextmanager
def lazy_transfer():
    """Within this context, `stage_end()` blocks until every deferred device
    output has finished COMPUTING but does not move it to the host — the
    Spark `count()` contract (partitions materialize on executors; nothing is
    collected to the driver). Results stay registered; the first actual data
    read (a deferred column's `.values`) triggers the one stacked d2h."""
    prev = getattr(_policy, 'lazy', False)
    _policy.lazy = True
    try:
        yield
    finally:
        _policy.lazy = prev


def stage_end() -> None:
    """Called by `Backend.map_collect` when a stage's partitions are done."""
    if getattr(_policy, 'lazy', False):
        wait()
    else:
        flush()


def wait() -> None:
    """Block until every pending device output is computed (no transfer),
    then demote pending entries to weakrefs: results a consumer still holds
    stay fetchable; results nobody holds free their device buffers."""
    with _lock:
        slots = [s for e in _pending if (s := _live(e)) is not None]
    if slots:
        import jax
        jax.block_until_ready([s.dev for s in slots])
    with _lock:
        _pending[:] = [weakref.ref(s) for e in _pending
                       if (s := _live(e)) is not None]


def flush() -> None:
    """Fetch all pending slots: one d2h per (dtype, trailing-shape) group."""
    with _lock:
        slots = [s for e in _pending if (s := _live(e)) is not None]
        _pending.clear()
        if not slots:
            return
        groups = {}
        for s in slots:
            key = (str(s.dev.dtype), tuple(s.dev.shape[1:]))
            groups.setdefault(key, []).append(s)
        for ss in groups.values():
            if len(ss) == 1:
                ss[0].host = np.asarray(ss[0].dev)
                ss[0].dev = None
                continue
            import jax.numpy as jnp
            host = np.asarray(jnp.concatenate([s.dev for s in ss], axis=0))
            off = 0
            for s in ss:
                n = int(s.dev.shape[0])
                s.host = host[off:off + n]
                s.dev = None
                off += n


def pending_count() -> int:
    with _lock:
        return sum(1 for e in _pending if _live(e) is not None)
