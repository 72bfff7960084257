"""Device mesh + sharding helpers.

The device replacement for the reference's GridPartitioner/Spark-RDD
block distribution (`is/hail/linalg/GridPartitioner.scala`) and for its
tree-reduce fabric: a 2-D `jax.sharding.Mesh` with NamedSharding —
XLA inserts the SUMMA collectives for sharded matmuls (SURVEY §2.4) and psum
for reductions. Multi-host: the same code runs under `jax.distributed` with a
global mesh spanning processes.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_mesh_cache: Optional[Mesh] = None


def _factor2(n: int) -> Tuple[int, int]:
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def get_mesh(devices=None) -> Mesh:
    """A 2-D ('x', 'y') mesh over all devices (or the given ones)."""
    global _mesh_cache
    if devices is None and _mesh_cache is not None:
        return _mesh_cache
    devs = list(devices) if devices is not None else jax.devices()
    a, b = _factor2(len(devs))
    mesh = Mesh(np.asarray(devs).reshape(a, b), ('x', 'y'))
    if devices is None:
        _mesh_cache = mesh
    return mesh


def reset_mesh() -> None:
    global _mesh_cache
    _mesh_cache = None


def n_devices() -> int:
    return len(jax.devices())


def pick_2d_spec(shape: Tuple[int, int], mesh: Mesh) -> P:
    """Most-parallel PartitionSpec whose mesh dims divide the array dims
    (committed arrays require exact divisibility; inside jit XLA handles
    uneven shardings itself). Preference order: full 2-D grid, 1-D over all
    devices, 1-D over one mesh axis, replicated."""
    mx, my = (int(mesh.devices.shape[0]), int(mesh.devices.shape[1]))
    n, m = int(shape[0]), int(shape[1])
    for spec, (dn, dm) in (
        (P('x', 'y'), (mx, my)),
        (P('y', 'x'), (my, mx)),
        (P(('x', 'y'), None), (mx * my, 1)),
        (P(None, ('x', 'y')), (1, mx * my)),
        (P('x', None), (mx, 1)),
        (P('y', None), (my, 1)),
        (P(None, 'y'), (1, my)),
        (P(None, 'x'), (1, mx)),
    ):
        if dn <= n and dm <= m and n % dn == 0 and m % dm == 0:
            return spec
    return P()


def shard_2d(x, mesh: Optional[Mesh] = None):
    """Shard a 2-D array over the ('x','y') mesh, picking the most-parallel
    divisible layout (pick_2d_spec)."""
    mesh = mesh or get_mesh()
    if math.prod(mesh.devices.shape) == 1:
        return jax.device_put(x)
    sh = NamedSharding(mesh, pick_2d_spec(x.shape, mesh))
    return jax.device_put(x, sh)


def replicate(x, mesh: Optional[Mesh] = None):
    mesh = mesh or get_mesh()
    if math.prod(mesh.devices.shape) == 1:
        return jax.device_put(x)
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_rows(x, mesh: Optional[Mesh] = None):
    """Shard axis 0 over all devices ('x' and 'y' flattened)."""
    mesh = mesh or get_mesh()
    if math.prod(mesh.devices.shape) == 1:
        return jax.device_put(x)
    return jax.device_put(x, NamedSharding(mesh, P(('x', 'y'),)))
