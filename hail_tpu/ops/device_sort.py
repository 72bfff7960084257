"""Device-tier distributed sort: sample-pivot range exchange over the mesh.

The device shuffle tier of `Table.order_by` (reference
`lowering/LowerDistributedSort.scala:161,320-464` — sample pivots, range-
partition, per-range local sort; there via Spark exchanges, here via
`shard_map` + `lax.all_to_all` between the devices).

The device computes the sorted PERMUTATION, not the row payload motion: keys
and global row-ids ride the all_to_all; the host applies the resulting id
order to the (arbitrarily-typed) row columns with one gather per output
partition. Total order matches the host sample sort exactly: (key, row-id)
— i.e. a stable sort in input order.

Applicability (else the caller falls back to the host tier): >1 device in
the default mesh, a single sort key of a primitive numeric dtype, no
missing values, no NaNs, and no key equal to the padding sentinel.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import numpy as np


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def device_range_sort(keys: np.ndarray, ascending: bool,
                      n_samples: int = 4096) -> Optional[np.ndarray]:
    """Sorted order of `keys` (global row-ids, stable) computed via an
    all_to_all range exchange on the default jax device mesh. Returns None
    when the device tier does not apply."""
    import jax
    import jax.numpy as jnp

    devs = jax.devices()
    nd = len(devs)
    n = int(keys.shape[0])
    if nd < 2 or n < nd:
        return None
    if keys.dtype.kind == 'f':
        if np.isnan(keys).any():
            return None
        sentinel = np.inf
        k = keys if ascending else -keys
    elif keys.dtype.kind == 'i':
        info = np.iinfo(keys.dtype)
        k = keys if ascending else ~keys     # ~x: exact order reversal
        if (k == info.max).any():
            return None
        sentinel = info.max
    else:
        return None

    ids = np.arange(n, dtype=np.int64)
    local_n = -(-n // nd)
    pad = nd * local_n - n
    if pad:
        k = np.concatenate([k, np.full(pad, sentinel, k.dtype)])
        ids = np.concatenate([ids, np.full(pad, -1, np.int64)])

    # sample pivots on host (plan time, like the reference's samplePartition)
    if n > n_samples:
        rng = np.random.default_rng(0)
        sample = np.sort(k[:n][rng.choice(n, n_samples, replace=False)])
    else:
        sample = np.sort(k[:n])
    pivots = np.asarray(
        [sample[(i + 1) * len(sample) // nd] for i in range(nd - 1)],
        dtype=k.dtype)

    # per-(shard, bucket) capacity: exact host count, rounded to a power of
    # two so repeated sorts reuse the compiled exchange
    shard_k = k.reshape(nd, local_n)
    counts = np.stack([
        np.bincount(np.searchsorted(pivots, row, side='right'),
                    minlength=nd) for row in shard_k])
    cap = _next_pow2(int(counts.max()))

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.asarray(devs), ('d',))
    sh = NamedSharding(mesh, P('d'))
    k_sh = jax.device_put(jnp.asarray(k), sh)
    i_sh = jax.device_put(jnp.asarray(ids), sh)
    piv = jnp.asarray(pivots)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P('d'), P('d'), P()),
             out_specs=(P('d'), P('d')), check_vma=False)
    def exchange(lk, li, pv):
        bucket = jnp.searchsorted(pv, lk, side='right').astype(jnp.int32)
        order = jnp.argsort(bucket, stable=True)   # keeps id-order in-bucket
        sk, si, sb = lk[order], li[order], bucket[order]
        pos = jnp.arange(lk.shape[0]) - jnp.searchsorted(sb, sb, side='left')
        send_k = jnp.full((nd, cap), sentinel, lk.dtype).at[sb, pos].set(sk)
        send_i = jnp.full((nd, cap), -1, jnp.int64).at[sb, pos].set(si)
        # (nd_dst, cap) -> every device receives its bucket from all sources
        rk = jax.lax.all_to_all(send_k[None], 'd', split_axis=1,
                                concat_axis=0, tiled=False)[:, 0, :]
        ri = jax.lax.all_to_all(send_i[None], 'd', split_axis=1,
                                concat_axis=0, tiled=False)[:, 0, :]
        fk, fi = rk.reshape(-1), ri.reshape(-1)
        o = jnp.argsort(fk, stable=True)  # sources arrive id-ordered
        return fk[o][None], fi[o][None]

    _, sorted_ids = exchange(k_sh, i_sh, piv)
    out = np.asarray(sorted_ids).reshape(-1)
    out = out[out >= 0]
    assert out.shape[0] == n, 'device range exchange lost rows'
    return out


def sortable_single_key(batches, specs) -> Optional[Tuple[np.ndarray, bool]]:
    """(concatenated key values, ascending) when `specs` is one primitive
    numeric key with no missing values across `batches`, else None."""
    from ..ir import columns as C
    from .. import types as ht
    if len(specs) != 1:
        return None
    field, asc = specs[0]
    numeric = (ht.tint32, ht.tint64, ht.tfloat32, ht.tfloat64)
    vals: List[np.ndarray] = []
    for b in batches:
        col = b.columns.get(field)
        if (not isinstance(col, C.PrimitiveColumn) or col.typ not in numeric
                or col.missing is not None):
            return None
        vals.append(col.values)
    return np.concatenate(vals), asc
