"""Relatedness: KING, PC-Relate, PLINK-style IBD, maximal_independent_set.

Capability parity with reference `hail/python/hail/methods/relatedness/`
(`king.py`, `pc_relate.py:38`, `identity_by_descent` → C++ SIMD IBS kernel
`hail/c/ibs.cpp` + `methods/IBSFFI.scala`). The pairwise kernels are
indicator-matrix matmuls (an int8 GEMM replaces the reference's SIMD
popcount loop).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_enable_x64', True)

from .. import types as ht
from ..expr import functions as F
from ..expr.expression import Expression, to_expr
from ..genetics.call import calls_is_het, calls_is_hom_ref, calls_is_hom_var
from ..ir import columns as C
from ..ir.columns import Batch, PrimitiveColumn, StructColumn
from ..matrixtable import MatrixBatch, MatrixStage, MatrixTable
from ..table import Table, TableStage
from ..utils.structs import Struct
from .statgen import _entry_expr_to_blocks


def _gt_indicator_matrices(call_expr):
    """(het, hom_ref, hom_var, called) float64 (m, n) indicator matrices."""
    e = to_expr(call_expr)
    mt = e._indices.source
    packeds, misses = [], []
    for i, ctx in enumerate(mt._stage.contexts):
        mb = mt._stage.partition_fn(ctx)
        env = mt._entry_env(mb, i)
        col = e._ir.evaluate(env)
        packeds.append(np.asarray(col.values))
        misses.append(col.missing_mask())
    packed = np.concatenate(packeds, axis=0)
    miss = np.concatenate(misses, axis=0)
    called = ~miss
    het = (calls_is_het(packed) & called)
    hom_ref = (calls_is_hom_ref(packed) & called)
    hom_var = (calls_is_hom_var(packed) & called)
    return het, hom_ref, hom_var, called, mt


@jax.jit
def _king_kernel(H, R, A, Cl):
    """KING-robust kinship via matmuls. All args (m, n) f64 indicators."""
    both_het = H.T @ H                      # N_Aa,Aa
    opp = R.T @ A
    opp = opp + opp.T                       # N_AA,aa
    het_shared = H.T @ Cl                   # N_Aa^i over sites where j called
    n_i = het_shared
    n_j = het_shared.T
    min_het = jnp.minimum(n_i, n_j)
    # KING between-family estimator (Manichaikul eq. 11; reference king.py):
    # phi = 1/2 + (2 N_AaAa - 4 N_AAaa - N_Aa^i - N_Aa^j) / (4 min(N_Aa^i, N_Aa^j))
    phi = 0.5 + (2.0 * both_het - 4.0 * opp - n_i - n_j) / jnp.maximum(4.0 * min_het, 1e-300)
    return phi


def king(call_expr, *, block_size: Optional[int] = None) -> MatrixTable:
    """KING-robust kinship (reference `methods/relatedness/king.py`); returns
    a sample×sample MatrixTable with entry `phi`."""
    het, hom_ref, hom_var, called, mt = _gt_indicator_matrices(call_expr)
    phi = np.asarray(_king_kernel(jnp.asarray(het, jnp.float64),
                                  jnp.asarray(hom_ref, jnp.float64),
                                  jnp.asarray(hom_var, jnp.float64),
                                  jnp.asarray(called, jnp.float64)))
    return _pairwise_mt(mt, {'phi': phi})


def _pairwise_mt(mt: MatrixTable, entries_np: Dict[str, np.ndarray]) -> MatrixTable:
    """Build a sample×sample MatrixTable from (n, n) matrices."""
    st = mt._stage
    n = st.n_cols
    col_key_fields = st.col_key
    row_cols = {}
    for kf in col_key_fields:
        row_cols[kf] = st.cols.columns[kf]
    rows = Batch(row_cols, n)
    row_t = ht.tstruct(**{kf: st.col_type[kf] for kf in col_key_fields})
    ents = {k: PrimitiveColumn(ht.tfloat64, v) for k, v in entries_np.items()}
    entry_t = ht.tstruct(**{k: ht.tfloat64 for k in entries_np})
    mb = MatrixBatch(rows, ents)
    return MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), st.cols.select(col_key_fields), col_key_fields, col_key_fields,
        row_t, ht.tstruct(**{kf: st.col_type[kf] for kf in col_key_fields}),
        entry_t, [mb]))


def pc_relate(call_expr, min_individual_maf: float, *, k: Optional[int] = None,
              scores_expr=None, min_kinship: Optional[float] = None,
              statistics: str = 'all', block_size: Optional[int] = None,
              include_self_kinship: bool = False) -> Table:
    """PC-Relate kinship + IBD (reference `relatedness/pc_relate.py:38`,
    `is/hail/methods/PCRelate.scala:18-180`): individual-specific allele
    frequencies from PC regression, then matmul moments."""
    e = to_expr(call_expr)
    mt = e._indices.source
    if (k is None) == (scores_expr is None):
        raise ValueError('specify exactly one of k or scores_expr')
    if scores_expr is not None:
        col = mt._eval_col_expr(to_expr(scores_expr))
        scores = np.asarray([list(v) for v in C.to_object(col).values])
    else:
        from .pca import hwe_normalized_pca
        _, scores_t, _ = hwe_normalized_pca(e, k=k, compute_loadings=False)
        scores = np.asarray([list(r.scores) for r in scores_t.collect()])

    ne = e.n_alt_alleles() if e.dtype == ht.tcall else e
    G, M = _entry_expr_to_blocks(ne)          # (m, n)
    m, n = G.shape
    X = np.concatenate([np.ones((n, 1)), scores], axis=1)   # (n, p)
    Gz = np.where(M, 0.0, G)
    cnt = (~M).sum(axis=1)
    # beta per variant: solve (X^T X) beta = X^T g  (using only called entries
    # approximated by zero-filled with count correction is biased; use full X
    # since missingness is typically low — matches reference mu fit on called)
    XtX = X.T @ X
    B = np.linalg.solve(XtX, X.T @ np.where(M, (Gz.sum(axis=1) / np.maximum(cnt, 1))[:, None], G).T).T  # (m, p)
    mu = (B @ X.T) / 2.0                      # (m, n) individual-specific af
    # mu is invalid (no contribution) when outside (maf, 1-maf) / (0, 1) or
    # when the genotype is missing (reference pc_relate.py:385 _bad_mu)
    bad = (mu <= min_individual_maf) | (mu >= 1 - min_individual_maf) | \
        (mu <= 0.0) | (mu >= 1.0) | M
    ok = ~bad
    variance = np.where(ok, mu * (1 - mu), 0.0)
    centered_af = np.where(ok, G - 2 * mu, 0.0)
    stddev = np.sqrt(variance)

    def gram(A):
        return np.asarray(jnp.asarray(A).T @ jnp.asarray(A))

    with np.errstate(all='ignore'):
        kin = gram(centered_af) / (4 * gram(stddev))

    # IBD2 (reference PCRelate.scala:267 k2): dominance-coded genotypes with
    # an inbreeding correction from the kinship diagonal
    f_i = 2.0 * np.diag(kin) - 1.0
    gd = np.where(~ok, 0.0,
                  np.where(G == 0.0, mu,
                           np.where(G == 1.0, 0.0, 1.0 - mu)))
    normalized_gd = gd - variance * (1.0 + f_i)[None, :]
    with np.errstate(all='ignore'):
        k2 = gram(normalized_gd) / gram(variance)

    # IBD0 (reference PCRelate.scala:287 k0): IBS0 ratio for close relatives,
    # 1 - 4*phi + k2 otherwise; cutoff 2^(-5/2)
    hom_alt = np.where(ok & (G == 2.0), 1.0, 0.0)
    hom_ref = np.where(ok & (G == 0.0), 1.0, 0.0)
    tmp = np.asarray(jnp.asarray(hom_alt).T @ jnp.asarray(hom_ref))
    ibs0 = tmp + tmp.T
    mu2 = np.where(ok, mu * mu, 0.0)
    om2 = np.where(ok, (1 - mu) * (1 - mu), 0.0)
    tmp2 = np.asarray(jnp.asarray(mu2).T @ jnp.asarray(om2))
    k0_den = tmp2 + tmp2.T
    k0cutoff = 2.0 ** (-5.0 / 2.0)
    with np.errstate(all='ignore'):
        k0 = np.where(kin <= k0cutoff, 1.0 - 4.0 * kin + k2, ibs0 / k0_den)
    k1 = 1.0 - (k2 + k0)

    # build pairs table
    st = mt._stage
    col_keys = st.cols.select(st.col_key).to_pylist()
    rows = []
    for i in range(n):
        j0 = i if include_self_kinship else i + 1
        for j in range(j0, n):
            if min_kinship is not None and kin[i, j] < min_kinship:
                continue
            # i/j are STRUCTS of the col key fields, even for a single key
            # (reference pc_relate returns key fields typed tstruct(col_key))
            r = {'i': col_keys[i], 'j': col_keys[j],
                 'kin': float(kin[i, j])}
            if statistics in ('kin2', 'kin20', 'all'):
                r['ibd2'] = float(k2[i, j])
            if statistics in ('kin20', 'all'):
                r['ibd0'] = float(k0[i, j])
            if statistics == 'all':
                r['ibd1'] = float(k1[i, j])
            rows.append(Struct(**r))
    kt = ht.tstruct(**{kf: st.col_type[kf] for kf in st.col_key})
    fields = [('i', kt), ('j', kt), ('kin', ht.tfloat64)]
    if statistics in ('kin2', 'kin20', 'all'):
        fields.append(('ibd2', ht.tfloat64))
    if statistics in ('kin20', 'all'):
        fields.append(('ibd0', ht.tfloat64))
    if statistics == 'all':
        fields.append(('ibd1', ht.tfloat64))
    row_t = ht.tstruct.from_fields(fields)
    b = Batch.from_pylist(row_t, rows)
    return Table(TableStage.from_batches(Batch({}, 1), ['i', 'j'], row_t, [b]))


def identity_by_descent(dataset: MatrixTable, maf=None, bounded: bool = True,
                        min: Optional[float] = None, max: Optional[float] = None) -> Table:
    """PLINK-style method-of-moments IBD (reference `methods/IBD` + C++ SIMD
    IBS kernel `hail/c/ibs.cpp:13-77`): IBS counts computed as indicator
    matmuls on device, then PLINK's E[IBS|IBD] inversion."""
    mt = dataset
    het, hom_ref, hom_var, called, mt = _gt_indicator_matrices(mt.GT)
    if maf is not None:
        mafe = to_expr(maf)
        vals = []
        for i, ctx in enumerate(mt._stage.contexts):
            mb = mt._stage.partition_fn(ctx)
            env = mt._row_env(mb, i)
            col = mafe._ir.evaluate(env)
            vals.append(np.asarray(col.values, dtype=np.float64))
        p = np.concatenate(vals)
    else:
        n_alt = het + 2 * hom_var
        with np.errstate(all='ignore'):
            p = n_alt.sum(axis=1) / np.maximum(2 * called.sum(axis=1), 1)
    keep = (p > 0) & (p < 1)
    p = p[keep]
    q = 1 - p

    from ..ops.ibs import ibs_counts
    ibs0, ibs1, ibs2 = ibs_counts(np.asarray(het[keep]), np.asarray(hom_ref[keep]),
                                  np.asarray(hom_var[keep]), np.asarray(called[keep]))
    shared = ibs0 + ibs1 + ibs2

    # PLINK expected IBS given IBD state (Purcell et al. 2007)
    m_v = p.size
    e00 = float(np.sum(2 * p * p * q * q))                    # P(IBS0 | IBD0)
    e10 = float(np.sum(4 * p ** 3 * q + 4 * p * q ** 3))      # P(IBS1 | IBD0)
    e11 = float(np.sum(2 * p * p * q + 2 * p * q * q))        # P(IBS1 | IBD1)
    e20 = float(np.sum(p ** 4 + q ** 4 + 4 * p * p * q * q))  # P(IBS2 | IBD0)
    e21 = float(np.sum(p ** 3 + q ** 3 + p * p * q + p * q * q))
    with np.errstate(all='ignore'):
        z0 = ibs0 / e00 * m_v / np.maximum(shared, 1)
        z1 = (ibs1 - z0 * e10 * shared / m_v) / (e11 * shared / m_v + 1e-300)
        z2 = 1 - z0 - z1
        if bounded:
            z0 = np.clip(z0, 0, 1)
            z1 = np.clip(z1, 0, 1)
            z2 = np.clip(1 - z0 - z1, 0, 1)
            s = z0 + z1 + z2
            z0, z1, z2 = z0 / s, z1 / s, z2 / s
        pi_hat = z1 / 2 + z2

    st = mt._stage
    skey = st.col_key[0]
    samples = [r[skey] for r in st.cols.to_pylist()]
    n = len(samples)
    rows = []
    for i in range(n):
        for j in range(i + 1, n):
            ph = float(pi_hat[i, j])
            if min is not None and ph < min:
                continue
            if max is not None and ph > max:
                continue
            rows.append(Struct(
                i=samples[i], j=samples[j],
                ibd=Struct(Z0=float(z0[i, j]), Z1=float(z1[i, j]),
                           Z2=float(z2[i, j]), PI_HAT=ph),
                ibs0=int(ibs0[i, j]), ibs1=int(ibs1[i, j]), ibs2=int(ibs2[i, j])))
    row_t = ht.tstruct(
        i=ht.tstr, j=ht.tstr,
        ibd=ht.tstruct(Z0=ht.tfloat64, Z1=ht.tfloat64, Z2=ht.tfloat64, PI_HAT=ht.tfloat64),
        ibs0=ht.tint64, ibs1=ht.tint64, ibs2=ht.tint64)
    b = Batch.from_pylist(row_t, rows)
    return Table(TableStage.from_batches(Batch({}, 1), ['i', 'j'], row_t, [b]))


def maximal_independent_set(i_expr, j_expr, keep: bool = True,
                            tie_breaker=None, keyed: bool = True) -> Table:
    """Greedy maximal independent set over an edge table (reference
    `methods/relatedness/maximal_independence.py` → Graph.scala)."""
    ie = to_expr(i_expr)
    je = to_expr(j_expr)
    if ie.dtype != je.dtype:
        raise ValueError(
            "'maximal_independent_set' expects arguments `i` and `j` to have "
            f"same type. Found {ie.dtype} and {je.dtype}.")
    src = ie._indices.source
    from ..table import Table as _Table
    if not isinstance(src, _Table):
        raise ValueError(
            "'maximal_independent_set' expects an expression of 'Table'. Found {}".format(
                f"expression of '{src.__class__}'" if src is not None
                else 'scalar expression'))
    if je._indices.source is not src:
        raise ValueError(
            "'maximal_independent_set' expects arguments `i` and `j` to be "
            "expressions of the same Table.")
    edges = list(zip(src._collect_expr(ie), src._collect_expr(je)))
    # greedy removal of max-degree nodes (reference methods/misc.py:16 →
    # ArrayMaximalIndependentSet): when degrees tie, remove the node that is
    # LARGEST under tie_breaker's ordering.
    from collections import defaultdict
    adj = defaultdict(set)
    for a, b in edges:
        if a != b:
            adj[a].add(b)
            adj[b].add(a)
    tb_cache = {}

    def tb(u, v):
        key = (repr(u), repr(v))
        if key not in tb_cache:
            lu = F.literal(u, ie.dtype)
            lv = F.literal(v, ie.dtype)
            tb_cache[key] = float(F.eval_expr(F.float64(tie_breaker(lu, lv))))
        return tb_cache[key]

    removed = set()
    while True:
        best, best_deg = None, 0
        for v, ns in adj.items():
            if v in removed:
                continue
            deg = sum(1 for u in ns if u not in removed)
            if deg > best_deg:
                best, best_deg = v, deg
            elif deg == best_deg and deg > 0 and tie_breaker is not None:
                if tb(v, best) > 0:
                    best = v
        if best is None or best_deg == 0:
            break
        removed.add(best)
    all_nodes = set(adj.keys())
    kept = all_nodes - removed
    out_nodes = sorted(kept, key=lambda v: (v is None, str(v))) if keep else \
        sorted(removed, key=lambda v: (v is None, str(v)))
    row_t = ht.tstruct(node=ie.dtype)
    b = Batch.from_pylist(row_t, [Struct(node=v) for v in out_nodes])
    return Table(TableStage.from_batches(Batch({}, 1), ['node'] if keyed else [],
                                         row_t, [b]))
