"""Exact int8 digit-plane GRM: K = Zᵀ Z from int8 GEMMs, f64 parity.

Device replacement for the reference's Breeze/Spark BlockMatrix GRM
(`hail/python/hail/methods/statgen.py` genetic_relatedness_matrix →
`is/hail/linalg/BlockMatrix.scala` tiled f64 GEMM). The f64
normalized-genotype matrix is never materialized: the kernel reads int8
indicator matrices, and the normalization lives in per-variant weights.

With per-variant allele frequency p_v, weight w_v = 1/(2 p_v (1-p_v)) (the
GRM normalization d_v², scaled by 1/m outside), called-indicator C and
zero-at-missing genotypes gz ∈ {0,1,2}:

    Z_{v,s} = d_v (gz_{v,s} − 2 p_v) C_{v,s}
    K_{s,t} = Σ_v w_v gz_vs gz_vt
            − Σ_v 2 w_v p_v (gz_vs C_vt + C_vs gz_vt)
            + Σ_v 4 w_v p_v² C_vs C_vt

Every sum is Σ_v u_v A_vs B_vt with A, B ∈ {0,1} matrices (gz splits into
the indicators B1 = gz≥1 and B2 = gz=2) and u a per-variant f64 weight.
Decomposing u into int8 digit planes (u_v ≈ Σ_k c_k q_kv, |q| ≤ 127) makes
each term a sum of pure int8 GEMMs — Aᵀ (q_k ∘ B) with exact int32
accumulation — recombined in f64. Exactness is limited only by the weight
quantization: 7 planes × 7 bits ≈ 2⁻⁴⁹ relative, far below the 1e-8 parity
bar (tests assert ≤1e-12 vs the f64 oracle).

The output is produced in column strips so a 50k×50k kinship never needs a
20 GB f64 buffer resident at once (BASELINE config 5).
"""

from __future__ import annotations

from functools import partial
from typing import Iterator, Tuple

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_enable_x64', True)

_PLANES = 7
_BITS = 7


def weight_planes(u: np.ndarray, planes: int = _PLANES, bits: int = _BITS
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-variant f64 weights (m,) → int8 digit planes (planes, m) and f64
    scales (planes,). Same scheme as linreg_i8._digit_planes but for a
    single weight vector (shared block exponent)."""
    u = np.asarray(u, np.float64)
    amax = np.max(np.abs(u)) if u.size else 1.0
    base = float(np.exp2(np.ceil(np.log2(amax)))) if amax > 0 else 1.0
    resid = u / base
    mult = float(1 << bits)
    digs, scales = [], []
    for d in range(planes):
        q = np.clip(np.rint(resid * mult), -127, 127)
        digs.append(q.astype(np.int8))
        resid = resid * mult - q
        scales.append(base / (mult ** (d + 1)))
    return np.stack(digs, axis=0), np.asarray(scales)


@partial(jax.jit, static_argnames=('planes',))
def _grm_strip(b1, b2, c, b1s, b2s, cs, qw, sw, qwp, swp, qwp2, swp2,
               planes=_PLANES):
    """One output strip K[:, strip] in f64.

    Left operands (m, n) int8 0/1 indicators are strip-invariant; the digit
    planes scale the (m, B) strip-side operands so the big matrices are
    staged on device exactly once per GRM.
    """
    dn = (((0,), (0,)), ((), ()))   # contract over variants

    def sweep(A, Bs, q, s):
        # Σ_k s_k · Aᵀ (q_k ∘ Bs): int8 GEMMs, exact int32, f64 recombine
        def body(k, acc):
            qb = (jnp.take(q, k, axis=0)[:, None] * Bs).astype(jnp.int8)
            g = jax.lax.dot_general(A, qb, dn,
                                    preferred_element_type=jnp.int32)
            return acc + jnp.take(s, k) * g.astype(jnp.float64)
        init = jnp.zeros((A.shape[1], Bs.shape[1]), jnp.float64)
        return jax.lax.fori_loop(0, planes, body, init)

    # T1: Σ w gz gzᵀ with gz = B1 + B2
    k = sweep(b1, b1s, qw, sw) + sweep(b1, b2s, qw, sw) \
        + sweep(b2, b1s, qw, sw) + sweep(b2, b2s, qw, sw)
    # T2: − Σ 2wp (gz Cᵀ + C gzᵀ)
    k = k - (sweep(b1, cs, qwp, swp) + sweep(b2, cs, qwp, swp)
             + sweep(c, b1s, qwp, swp) + sweep(c, b2s, qwp, swp))
    # T3: + Σ 4wp² C Cᵀ
    return k + sweep(c, cs, qwp2, swp2)


class ExactGrm:
    """Strip-streaming exact GRM over int8 indicator matrices.

    Usage:
        g = ExactGrm(gz8, m8, p, ok)       # device staging, once
        for lo, hi, K_strip in g.strips(4096):   # f64 (n, hi-lo) on device
            ...
    `p` is the per-variant allele frequency, `ok` the rows actually used
    (denominator > 0); the 1/m normalization is applied here.
    """

    def __init__(self, gz8, m8, p: np.ndarray, ok: np.ndarray):
        gz8 = jnp.asarray(gz8, jnp.int8)
        m8 = jnp.asarray(m8, jnp.int8)
        okj = jnp.asarray(np.asarray(ok, bool))
        # excluded rows contribute nothing: zero their indicators
        keep = okj[:, None]
        self.b1 = jnp.where(keep, (gz8 >= 1).astype(jnp.int8), 0)
        self.b2 = jnp.where(keep, (gz8 == 2).astype(jnp.int8), 0)
        self.c = jnp.where(keep, (jnp.int8(1) - m8), 0)
        p = np.asarray(p, np.float64)
        ok = np.asarray(ok, bool)
        m_used = max(int(ok.sum()), 1)
        denom = 2.0 * p * (1.0 - p)
        w = np.where(ok, 1.0 / np.where(denom > 0, denom, 1.0), 0.0) / m_used
        self.m_used = m_used
        qw, sw = weight_planes(w)
        qwp, swp = weight_planes(2.0 * w * p)
        qwp2, swp2 = weight_planes(4.0 * w * p * p)
        self._planes = tuple(jnp.asarray(x) for x in
                             (qw, sw, qwp, swp, qwp2, swp2))
        self.n = int(gz8.shape[1])

    def strip(self, lo: int, hi: int):
        """f64 (n, hi-lo) strip of K (device array)."""
        sl = slice(lo, hi)
        return _grm_strip(self.b1, self.b2, self.c,
                          self.b1[:, sl], self.b2[:, sl], self.c[:, sl],
                          *self._planes)

    def strips(self, width: int) -> Iterator[Tuple[int, int, 'jax.Array']]:
        for lo in range(0, self.n, width):
            hi = min(lo + width, self.n)
            yield lo, hi, self.strip(lo, hi)

    def to_numpy(self, width: int = 8192) -> np.ndarray:
        out = np.empty((self.n, self.n), np.float64)
        for lo, hi, s in self.strips(width):
            out[:, lo:hi] = np.asarray(s)
        return out
