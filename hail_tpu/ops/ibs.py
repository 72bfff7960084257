"""IBS (identity-by-state) pairwise counting.

Device replacement for the reference's SIMD C++ kernel (`hail/c/ibs.cpp`,
called via `methods/IBSFFI.scala:13-77`): the pairwise IBS0/1/2 counts are
indicator-matrix products, computed as int8×int8→int32 GEMMs on the tensor
cores in place of the libsimdpp popcount loop. Symmetry halves the work:
IBS0 and IBS1 each take one product plus its transpose, and IBS2 follows
from the shared-called count, so three products cover all three counts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _i8(x):
    return jnp.asarray(x, dtype=jnp.int8)


@jax.jit
def _ibs_dot(het, hom_ref, hom_var, called):
    """IBS counts via int8 GEMMs. Inputs (m, n) bool arrays (variants ×
    samples); outputs three (n, n) int32 arrays."""
    def dot(a, b):
        # contract over variants: (m, n)ᵀ (m, n) → (n, n), exact in int32
        return jax.lax.dot_general(_i8(a), _i8(b), (((0,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    ibs0 = dot(hom_ref, hom_var)
    ibs0 = ibs0 + ibs0.T
    ibs1_half = dot(het, hom_ref | hom_var)
    ibs1 = ibs1_half + ibs1_half.T
    shared = dot(called, called)
    ibs2 = shared - ibs0 - ibs1
    return ibs0, ibs1, ibs2


def ibs_counts(het: np.ndarray, hom_ref: np.ndarray, hom_var: np.ndarray,
               called: np.ndarray):
    """Pairwise (n, n) IBS0/1/2 counts from (m, n) indicator matrices, as
    host int32 arrays."""
    out = _ibs_dot(jnp.asarray(het), jnp.asarray(hom_ref),
                   jnp.asarray(hom_var), jnp.asarray(called))
    return tuple(np.asarray(o) for o in out)
