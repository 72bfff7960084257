"""Device-banded windowed r² for LD pruning.

Device replacement for the reference's LocalLDPrune streaming CPU kernel
(`is/hail/methods/LocalLDPrune.scala` bit-packed SIMD r²) + its windowed
BlockMatrix stage (`hail/python/hail/methods/statgen.py:4708 ld_prune`
stage 2): instead of per-pair dot products on the host, every variant's r²
against its W predecessors is produced by blocked GEMMs over the
standardized genotype matrix, thresholded ON DEVICE, and fetched as one
small boolean band per block — the greedy window scans in ld_prune then run
on booleans with no further linear algebra.

band_hits[i, k] ↔ pair (i, j=i-W+k), k ∈ [0, W): True iff r²(Z_i, Z_j) ≥ t.
Rows j < 0 are zero-padded (r = 0 → never a hit). Contig/bp-window masking
happens in the caller (it owns the locus arrays).
"""

from __future__ import annotations

from functools import partial
from typing import Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_enable_x64', True)


@partial(jax.jit, static_argnames=('w', 'block'))
def _band_block(zpad, s, w, block, thresh):
    """One boolean band tile, BIT-PACKED on device to (block, ceil(w/8))
    uint8 — the band leaves the chip at 1 bit/pair instead of 1 byte/pair
    (the reference's LocalLDPrune keeps genotypes 2-bit-packed for the same
    bandwidth reason, `BitPackedVector`).

    zpad is Z with w zero rows prepended, so source row i sits at zpad[i+w].
    For output rows i ∈ [s, s+block): C = Z[s:s+block] · Z[s-w : s+block]ᵀ,
    and band[r, k] = C[r, r+k] (pair (s+r, s+r-w+k))."""
    zb = jax.lax.dynamic_slice_in_dim(zpad, s + w, block, 0)
    zw = jax.lax.dynamic_slice_in_dim(zpad, s, block + w, 0)
    c = zb @ zw.T                                   # (block, block + w)
    r = jnp.arange(block)[:, None]
    k = jnp.arange(w)[None, :]
    band = jnp.take_along_axis(c, r + k, axis=1)    # C[r, r + k]
    hits = (band * band) >= thresh
    w8 = (w + 7) // 8
    h = jnp.pad(hits, ((0, 0), (0, w8 * 8 - w)))
    # big-endian within the byte: bit 128 is k = 8j (np.unpackbits order)
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    return (h.reshape(block, w8, 8).astype(jnp.uint8)
            * weights[None, None, :]).sum(axis=-1, dtype=jnp.uint8)


def banded_r2_hits(zd, w: int, r2: float, block: int = 2048
                   ) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield (s, e, hits) per row block; hits is host bool (e-s, w).

    All block kernels are dispatched up front and the packed bands come
    back in ONE d2h transfer (the hits do not depend on the greedy scan's
    kept-set, so the whole band can be materialized before scanning)."""
    m = int(zd.shape[0])
    if m == 0 or w <= 0:
        return
    # zero rows before (j < 0) and after (tail-block padding): zero rows
    # never produce a hit, and dynamic_slice stays in bounds for every block
    pad_end = (-m) % block
    zpad = jnp.concatenate(
        [jnp.zeros((w, zd.shape[1]), zd.dtype), zd,
         jnp.zeros((pad_end, zd.shape[1]), zd.dtype)], axis=0)
    outs = [_band_block(zpad, s, w, block, jnp.float64(r2))
            for s in range(0, m, block)]
    packed = np.asarray(jnp.concatenate(outs, axis=0))   # one d2h
    bits = np.unpackbits(packed, axis=1)[:, :w].astype(bool)
    for s in range(0, m, block):
        e = min(s + block, m)
        yield s, e, bits[s:e]


def standardize_rows_device(gz8, m8):
    """(gz8, m8) int8 device pair → (Z, mean, ok): unit-norm mean-imputed
    rows on device plus host per-variant stats (the ld_prune normalization,
    reference statgen.py `mean_imputed` + `normalize`)."""
    g = gz8.astype(jnp.float64)
    miss = m8 > 0
    cnt = jnp.sum(~miss, axis=1).astype(jnp.float64)
    s = jnp.sum(g, axis=1)
    mean = jnp.where(cnt > 0, s / jnp.maximum(cnt, 1.0), 0.0)
    gi = jnp.where(miss, mean[:, None], g)
    centered = gi - mean[:, None]
    ss = jnp.sqrt(jnp.sum(centered * centered, axis=1))
    ok = ss > 0
    z = jnp.where(ok[:, None], centered / jnp.where(ok, ss, 1.0)[:, None],
                  0.0)
    # one stacked d2h for both stats
    stats = np.asarray(jnp.stack([mean, ok.astype(jnp.float64)]))
    return z, stats[0], stats[1] > 0.5
