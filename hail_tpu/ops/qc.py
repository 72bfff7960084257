"""Device-tier QC kernels: fused per-variant and per-sample counters.

The jnp/jit tier for `variant_qc` / `sample_qc` over packed-call blocks —
the device replacement for the reference's generated seqOp bytecode loops
(`agg/CallStatsAggregator`, `methods/qc.py` hot paths): one fused kernel
computes all counters in a single pass over the (R, C) block. Used by
hail_tpu.methods.qc when the block is large enough to amortize dispatch
(`jit_threshold_rows` flag); numerically identical to the aggregator tier.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..genetics.call import J_MASK, J_SHIFT, K_MASK, K_SHIFT, PLOIDY_MASK


@partial(jax.jit, static_argnames=('max_alleles', 'has_dp', 'has_gq'))
def variant_qc_block(packed, missing, dp, gq, max_alleles: int,
                     has_dp: bool, has_gq: bool):
    """All per-variant QC counters in one pass.

    packed: (R, C) int32 calls; missing: (R, C) bool; dp/gq: (R, C) int32 (or
    dummy) with their own missing folded in as <0 sentinel by the caller.
    Returns dict of (R,)-shaped arrays (+ (R, A) allele counts).
    """
    called = ~missing
    ploidy = packed & PLOIDY_MASK
    j = (packed >> J_SHIFT) & J_MASK
    k = (packed >> K_SHIFT) & K_MASK
    diploid = called & (ploidy == 2)
    het = diploid & (j != k)
    hom_ref = called & (j == 0) & ((ploidy < 2) | (k == 0))
    hom_var = called & (j > 0) & ((ploidy < 2) | (j == k))

    out = {}
    out['n_called'] = jnp.sum(called, axis=1)
    out['n_het'] = jnp.sum(het, axis=1)
    out['n_hom_ref_diploid'] = jnp.sum(diploid & (j == 0) & (k == 0), axis=1)
    out['n_hom_var_diploid'] = jnp.sum(diploid & (j == k) & (j > 0), axis=1)
    out['n_non_ref'] = jnp.sum(called & ((j > 0) | ((ploidy == 2) & (k > 0))), axis=1)
    out['AN'] = jnp.sum(jnp.where(called, ploidy, 0), axis=1)
    # allele counts via one-hot sums (A is small; VPU-friendly)
    alleles = jnp.arange(max_alleles, dtype=jnp.int32)
    jc = (j[..., None] == alleles[None, None, :]) & (called & (ploidy >= 1))[..., None]
    kc = (k[..., None] == alleles[None, None, :]) & (called & (ploidy == 2))[..., None]
    out['AC'] = jnp.sum(jc, axis=1) + jnp.sum(kc, axis=1)
    homc = ((j[..., None] == alleles[None, None, :])
            & (diploid & (j == k))[..., None])
    out['homozygote_count'] = jnp.sum(homc, axis=1)
    if has_dp:
        # DP/GQ stats are over defined values regardless of GT call status
        ok = dp >= 0
        dpf = dp.astype(jnp.float64)
        out['dp_sum'] = jnp.sum(jnp.where(ok, dpf, 0.0), axis=1)
        out['dp_sumsq'] = jnp.sum(jnp.where(ok, dpf * dpf, 0.0), axis=1)
        out['dp_n'] = jnp.sum(ok, axis=1)
        out['dp_min'] = jnp.min(jnp.where(ok, dpf, jnp.inf), axis=1)
        out['dp_max'] = jnp.max(jnp.where(ok, dpf, -jnp.inf), axis=1)
    if has_gq:
        ok = gq >= 0
        gqf = gq.astype(jnp.float64)
        out['gq_sum'] = jnp.sum(jnp.where(ok, gqf, 0.0), axis=1)
        out['gq_sumsq'] = jnp.sum(jnp.where(ok, gqf * gqf, 0.0), axis=1)
        out['gq_n'] = jnp.sum(ok, axis=1)
        out['gq_min'] = jnp.min(jnp.where(ok, gqf, jnp.inf), axis=1)
        out['gq_max'] = jnp.max(jnp.where(ok, gqf, -jnp.inf), axis=1)
    return out


def run_variant_qc_block(packed: np.ndarray, missing: np.ndarray,
                         dp=None, dp_missing=None, gq=None, gq_missing=None,
                         max_alleles: int = 2):
    """Host wrapper: sentinel-encode missing DP/GQ, run the fused kernel,
    return numpy dict."""
    R, Cn = packed.shape
    if dp is not None:
        dp_in = np.where(dp_missing, -1, dp).astype(np.int32) if dp_missing is not None \
            else np.asarray(dp, dtype=np.int32)
    else:
        dp_in = np.zeros((1, 1), np.int32)
    if gq is not None:
        gq_in = np.where(gq_missing, -1, gq).astype(np.int32) if gq_missing is not None \
            else np.asarray(gq, dtype=np.int32)
    else:
        gq_in = np.zeros((1, 1), np.int32)
    out = variant_qc_block(jnp.asarray(packed), jnp.asarray(missing),
                           jnp.asarray(dp_in), jnp.asarray(gq_in),
                           int(max_alleles), dp is not None, gq is not None)
    return {k: np.asarray(v) for k, v in out.items()}
