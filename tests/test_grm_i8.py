"""Exact int8 digit-plane GRM (ops/grm.py) vs the f64 oracle.

Oracle: the definitional K = ZᵀZ/m with Z the hail-normalized genotype
matrix (reference methods/statgen genetic_relatedness_matrix semantics).
"""

import numpy as np

from hail_tpu.ops.grm import ExactGrm


def _oracle(G, M):
    cnt = (~M).sum(axis=1)
    s = np.where(M, 0, G).sum(axis=1)
    mean = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    Gi = np.where(M, mean[:, None], G).astype(np.float64)
    p = mean / 2
    denom = np.sqrt(2 * p * (1 - p))
    ok = (denom > 0) & (cnt > 0)
    Z = np.where(ok[:, None], (Gi - mean[:, None])
                 / np.where(ok, denom, 1)[:, None], 0.0)
    m = max(int(ok.sum()), 1)
    return (Z.T @ Z) / m, p, ok


def _make(m, n, miss_rate, seed):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, (m, n)).astype(np.int64)
    M = rng.random((m, n)) < miss_rate
    return G, M


def test_exact_grm_matches_oracle():
    G, M = _make(64, 48, 0.05, 0)
    K_ref, p, ok = _oracle(G, M)
    gz8 = np.where(M, 0, G).astype(np.int8)
    g = ExactGrm(gz8, M.astype(np.int8), p, ok)
    K = g.to_numpy(width=16)
    assert np.max(np.abs(K - K_ref)) < 1e-12, np.max(np.abs(K - K_ref))


def test_exact_grm_no_missing_and_monomorphic_rows():
    G, M = _make(40, 16, 0.0, 1)
    G[3] = 0          # monomorphic: excluded (ok=False)
    G[17] = 2
    K_ref, p, ok = _oracle(G, M)
    assert not ok[3] and not ok[17]
    gz8 = G.astype(np.int8)
    g = ExactGrm(gz8, M.astype(np.int8), p, ok)
    K = g.to_numpy(width=7)   # ragged strips
    assert np.max(np.abs(K - K_ref)) < 1e-12


def test_exact_grm_via_public_method():
    """genetic_relatedness_matrix (which runs ExactGrm) agrees with the
    strip kernel and the f64 oracle."""
    import jax
    import hail_tpu as hl

    hl.init(idempotent=True)
    mt = hl.balding_nichols_model(2, 30, 50)
    bm = hl.genetic_relatedness_matrix(mt.GT)
    K_pub = bm.to_numpy()

    from hail_tpu.methods.statgen import _entry_expr_to_blocks
    from hail_tpu.expr.functions import to_expr
    ne = to_expr(mt.GT).n_alt_alleles()
    G, M = _entry_expr_to_blocks(ne)
    K_ref, p, ok = _oracle(np.asarray(G), np.asarray(M, bool))
    g = ExactGrm(np.where(M, 0, G).astype(np.int8), np.asarray(M, np.int8),
                 p, ok)
    K_i8 = g.to_numpy(width=32)
    assert np.max(np.abs(K_i8 - K_ref)) < 1e-12
    assert np.max(np.abs(K_pub - K_ref)) < 1e-10
