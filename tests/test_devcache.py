"""Device-buffer cache (ops/devcache.py): anchor lifetime, LRU budget,
fingerprint keying (round-3 verdict item 1a)."""

import numpy as np
import pytest

import hail_tpu as hl  # noqa: F401  (forces CPU via conftest)
from hail_tpu.ops import devcache


class Anchor:
    pass


def test_hit_and_miss_by_fingerprint():
    devcache.clear()
    a = Anchor()
    calls = []

    def build():
        calls.append(1)
        import jax.numpy as jnp
        return jnp.zeros(10)

    b1 = devcache.get(a, ('x',), build)
    b2 = devcache.get(a, ('x',), build)
    assert b2 is b1 and len(calls) == 1
    devcache.get(a, ('y',), build)
    assert len(calls) == 2


def test_anchor_death_evicts():
    devcache.clear()
    a = Anchor()
    import jax.numpy as jnp
    devcache.get(a, ('x',), lambda: jnp.zeros(100))
    assert devcache.stats()['entries'] == 1
    del a
    import gc
    gc.collect()
    assert devcache.stats()['entries'] == 0


def test_lru_budget_eviction(monkeypatch):
    devcache.clear()
    monkeypatch.setenv('HAIL_TPU_DEVICE_CACHE_BYTES', '4000')
    import jax.numpy as jnp
    anchors = [Anchor() for _ in range(4)]
    for i, a in enumerate(anchors):
        devcache.get(a, (i,), lambda: jnp.zeros(300))   # 2400 bytes each
    st = devcache.stats()
    assert st['bytes'] <= 4000
    assert st['entries'] < 4


def test_zero_budget_disables(monkeypatch):
    devcache.clear()
    monkeypatch.setenv('HAIL_TPU_DEVICE_CACHE_BYTES', '0')
    import jax.numpy as jnp
    a = Anchor()
    calls = []

    def build():
        calls.append(1)
        return jnp.zeros(5)

    devcache.get(a, ('x',), build)
    devcache.get(a, ('x',), build)
    assert len(calls) == 2 and devcache.stats()['entries'] == 0


def test_unweakrefable_anchor_falls_through():
    devcache.clear()
    import jax.numpy as jnp
    out = devcache.get(42, ('x',), lambda: jnp.zeros(3))   # int: no weakref
    assert out.shape == (3,)
    assert devcache.stats()['entries'] == 0


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_cap_is_share_of_device_memory_limit():
    dev = _FakeDevice({'bytes_limit': 60 * 2**30, 'bytes_in_use': 2**20})
    assert devcache._device_cap(dev) == int(60 * 2**30 * devcache._DEVICE_SHARE)


@pytest.mark.parametrize('stats', [None, {}, {'bytes_in_use': 5}])
def test_cap_without_device_stats_is_fixed(stats):
    assert devcache._device_cap(_FakeDevice(stats)) == devcache._NO_STATS_CAP


def test_env_overrides_derived_cap(monkeypatch):
    monkeypatch.setenv('HAIL_TPU_DEVICE_CACHE_BYTES', '12345')
    assert devcache._cap() == 12345
    monkeypatch.delenv('HAIL_TPU_DEVICE_CACHE_BYTES')
    assert devcache._cap() == devcache._default_cap()
