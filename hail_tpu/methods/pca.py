"""PCA: exact and randomized (Blanczos) SVD, device GEMMs + host LAPACK.

Capability parity with reference `hail/python/hail/methods/pca.py` (`pca`,
`hwe_normalized_pca`, `_blanczos_pca` with `_krylov_factorization`,
`pca.py:210-404`). Like the reference — which distributes only the matmuls
and runs the small factorization on the driver (`pca.py:345-404`) — all
QR/SVD/eigh here run in host LAPACK (`ops/decomp.py`); the device sees only
GEMMs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_enable_x64', True)

from .. import types as ht
from ..context import Env
from ..expr.expression import to_expr
from ..ir.columns import Batch, DenseArrayColumn, PrimitiveColumn
from ..table import Table, TableStage
from ..utils.structs import Struct
from ..ops.decomp import randomized_svd as _randomized_svd
from .statgen import _entry_expr_to_blocks


def _pca_core(A: np.ndarray, k: int, compute_loadings: bool,
              exact: Optional[bool] = None):
    """A: (variants m × samples n). Returns (eigvals, scores (n,k), loadings (m,k)).

    A arrives host-side (from `_entry_expr_to_blocks`). Exact path: host
    LAPACK directly (the data is already on the driver; matches reference
    driver-side SVD). Randomized path: device GEMMs + host small
    factorizations (ops/decomp.py)."""
    m, n = A.shape
    if exact is None:
        exact = min(m, n) <= 2048
    if exact:
        U, s, Vt = np.linalg.svd(A, full_matrices=False)
        U, s, Vt = U[:, :k], s[:k], Vt[:k]
    else:
        U, s, Vt = _randomized_svd(jnp.asarray(A), k, q=2,
                                   seed=Env.next_seed())
    eigvals = np.asarray(s)**2
    scores = np.asarray(Vt).T * np.asarray(s)[None, :]   # (n, k)
    loadings = np.asarray(U)                             # (m, k)
    return eigvals, scores, loadings


def _scores_table(mt, scores: np.ndarray, field: str = 'scores') -> Table:
    st = mt._stage
    cols = st.cols
    k = scores.shape[1]
    b = Batch({
        **{kf: cols.columns[kf] for kf in st.col_key},
        field: DenseArrayColumn(ht.tarray(ht.tfloat64), scores,
                                np.full(scores.shape[0], k, np.int32)),
    }, cols.length)
    return Table(TableStage.from_batches(Batch({}, 1), st.col_key, b.row_type, [b]))


def _loadings_table(mt, loadings: np.ndarray, field: str = 'loadings') -> Table:
    st = mt._stage
    rows = mt.rows()._stage.collect_single()
    k = loadings.shape[1]
    b = Batch({
        **{kf: rows.columns[kf] for kf in st.row_key},
        field: DenseArrayColumn(ht.tarray(ht.tfloat64), loadings,
                                np.full(loadings.shape[0], k, np.int32)),
    }, rows.length)
    return Table(TableStage.from_batches(Batch({}, 1), st.row_key, b.row_type, [b]))


def pca(entry_expr, k: int = 10, compute_loadings: bool = False
        ) -> Tuple[list, Table, Optional[Table]]:
    """PCA of an entry expression (reference `pca.py:35`). Missing entries are
    mean-imputed (as the reference requires defined entries; we match
    hwe_normalized_pca's imputation behavior)."""
    e = to_expr(entry_expr)
    mt = e._indices.source
    G, M = _entry_expr_to_blocks(e)
    if M.any():
        cnt = (~M).sum(axis=1)
        s = np.where(M, 0, G).sum(axis=1)
        mean = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
        G = np.where(M, mean[:, None], G)
    eigvals, scores, loadings = _pca_core(G, k, compute_loadings)
    st = _scores_table(mt, scores)
    lt = _loadings_table(mt, loadings) if compute_loadings else None
    return list(eigvals), st, lt


def hwe_normalized_pca(call_expr, k: int = 10, compute_loadings: bool = False
                       ) -> Tuple[list, Table, Optional[Table]]:
    """PCA of the HWE-normalized genotype matrix (reference `pca.py:100`):
    entries (g - 2p)/sqrt(2p(1-p)·m/n?) — we use the reference's normalization
    (g - mean) / sqrt(2p(1-p) * m) with mean imputation, filtering
    monomorphic variants."""
    e = to_expr(call_expr)
    mt = e._indices.source
    ne = e.n_alt_alleles() if e.dtype == ht.tcall else e
    G, M = _entry_expr_to_blocks(ne)
    cnt = (~M).sum(axis=1)
    s = np.where(M, 0, G).sum(axis=1)
    mean = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    G = np.where(M, mean[:, None], G)
    p = mean / 2
    keep = (p > 0) & (p < 1) & (cnt > 0)
    Gk = G[keep]
    meank = mean[keep]
    pk = p[keep]
    m = Gk.shape[0]
    denom = np.sqrt(2 * pk * (1 - pk) * m)
    Z = (Gk - meank[:, None]) / denom[:, None]
    eigvals, scores, loadings = _pca_core(Z, k, compute_loadings)
    st = _scores_table(mt, scores)
    lt = None
    if compute_loadings:
        # map loadings back to kept rows only
        st_rows = mt.rows()._stage.collect_single().compress(keep)
        kk = loadings.shape[1]
        b = Batch({
            **{kf: st_rows.columns[kf] for kf in mt._stage.row_key},
            'loadings': DenseArrayColumn(ht.tarray(ht.tfloat64), loadings,
                                         np.full(loadings.shape[0], kk, np.int32)),
        }, st_rows.length)
        lt = Table(TableStage.from_batches(Batch({}, 1), mt._stage.row_key, b.row_type, [b]))
    return list(eigvals), st, lt


def _blanczos_pca(entry_expr, k: int = 10, compute_loadings: bool = False,
                  q_iterations: int = 10, oversampling_param=None,
                  block_size: int = 128, compute_scores: bool = True,
                  transpose: bool = False) -> Tuple[list, Optional[Table], Optional[Table]]:
    """Randomized PCA with explicit Blanczos parameters (reference
    `pca.py:538` `_blanczos_pca`). With `transpose=True` the input holds the
    matrix transposed: loadings live on the input's columns and scores on its
    rows (reference test_blanczos_flags semantics)."""
    e = _unwrap_tsm(entry_expr)
    if oversampling_param is None:
        oversampling_param = 10
    mt = e._indices.source
    G, M = _tsm_blocks(entry_expr)
    if M.any():
        cnt = (~M).sum(axis=1)
        s = np.where(M, 0, G).sum(axis=1)
        mean = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
        G = np.where(M, mean[:, None], G)
    if G.size <= (4 << 20):
        # small problem: exact host SVD beats the randomized scheme in both
        # time and accuracy (device/randomized path is for at-scale inputs)
        U, s, Vt = np.linalg.svd(np.asarray(G, np.float64), full_matrices=False)
        U, s, Vt = U[:, :k], s[:k], Vt[:k]
    else:
        U, s, Vt = _randomized_svd(jnp.asarray(G), k, q=q_iterations,
                                   oversample=oversampling_param, seed=Env.next_seed())
    eigvals = list(np.asarray(s * s))
    U = np.asarray(U)
    V = np.asarray(Vt.T)
    sv = np.asarray(s)
    if not transpose:
        st = _scores_table(mt, V * sv[None, :]) if compute_scores else None
        lt = _loadings_table(mt, U) if compute_loadings else None
    else:
        # input is A^T: A = V Σ U^T, so A's left-singulars are the input's
        # column vectors and A's scores span the input's rows
        st = _loadings_table(mt, U * sv[None, :], field='scores') if compute_scores else None
        lt = _scores_table(mt, V, field='loadings') if compute_loadings else None
    return eigvals, st, lt


class TallSkinnyMatrix:
    """Blocked view of an (entries × samples) matrix (reference `pca.py:210`).

    The reference materializes a table of row-block ndarrays; here the entry
    expression itself is the handle — blocks are extracted on demand by the
    columnar evaluator and shipped to the device in one piece. When built
    with `whiten_window_size` the whitened row blocks ARE materialized, as
    `block_table`/`block_expr` (the reference's surface: a table with an
    `ndarray` field per block, pca.py:210-217)."""

    def __init__(self, entry_expr, block_size: int = 128, col_key=None,
                 block_table=None, block_expr=None, whitened=None):
        self.entry_expr = entry_expr
        self.block_size = block_size
        src = entry_expr._indices.source
        self.col_key = col_key if col_key is not None else list(src.col_key)
        self.ncols = src.count_cols()
        self.source_table = src.rows()
        self.block_table = block_table
        self.block_expr = block_expr
        self._whitened = whitened     # (n_rows, n_cols) f64 or None


def _local_whiten_rows(G: np.ndarray, w: int, chunk: int = 2048) -> np.ndarray:
    """Sliding-window whitening: row j minus its projection onto the span of
    the previous `w` ORIGINAL rows (reference
    `is/hail/methods/LocalWhitening.scala:88-470` via ir.StreamWhiten;
    semantics pinned by test_local_whitening.py naive_whiten).

    The reference maintains a sliding blocked-Givens QR; here each row's
    residual is an independent least-squares solve against its own window,
    batched over rows (np.linalg.pinv broadcasts over the leading dim), so
    the whole pass is a handful of batched GEMM/SVD calls instead of a
    sequential per-row update — the batch, not the recurrence, is the unit
    of work. Ragged leading windows are zero-padded: zero columns don't
    change the span, so the residual is unaffected."""
    n, m = G.shape
    if n == 0 or w <= 0:
        return G.astype(np.float64, copy=True)
    Gp = np.vstack([np.asarray(G, np.float64), np.zeros((1, m))])
    out = np.empty((n, m), dtype=np.float64)
    offs = np.arange(w)[None, :] - w
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        idx = np.arange(s, e)[:, None] + offs       # (b, w) window row ids
        idx = np.where(idx < 0, n, idx)             # out-of-range -> zero row
        Wt = np.swapaxes(Gp[idx], 1, 2)             # (b, m, w) window cols
        x = Gp[s:e][:, :, None]                     # (b, m, 1)
        beta = np.linalg.pinv(Wt) @ x               # (b, w, 1)
        out[s:e] = (x - Wt @ beta)[:, :, 0]
    return out


def _make_tsm(entry_expr, block_size, *, partition_size=None,
              whiten_window_size=None, whiten_block_size=64,
              normalize_after_whiten=False):
    """Build a TallSkinnyMatrix from an entry expression (reference
    `pca.py:220` _make_tsm), optionally whitening each row block against the
    trailing window of previous rows (reference pca.py:225-267 StreamWhiten
    path)."""
    e = to_expr(entry_expr)
    if whiten_window_size is None:
        return TallSkinnyMatrix(e, block_size)
    G, M = _entry_expr_to_blocks(e)
    G = np.where(M, 0.0, G) if M is not None and M.any() else np.asarray(G, np.float64)
    vec_size = G.shape[1]
    if vec_size <= whiten_window_size:
        raise ValueError('whiten_window_size must be smaller than number of cols')
    Xw = _local_whiten_rows(G, whiten_window_size)
    if normalize_after_whiten:
        norms = np.linalg.norm(Xw, axis=1, keepdims=True)
        Xw = np.where(norms > 0, Xw / np.where(norms == 0, 1.0, norms), Xw)
    n = Xw.shape[0]
    rows = [Struct(idx=start // block_size, ndarray=Xw[start:start + block_size])
            for start in range(0, n, block_size)]
    t_row = ht.tstruct(idx=ht.tint64, ndarray=ht.tndarray(ht.tfloat64, 2))
    bt = Table(TableStage.from_batches(Batch({}, 1), ['idx'], t_row,
                                       [Batch.from_pylist(t_row, rows)]))
    src = e._indices.source
    return TallSkinnyMatrix(e, block_size, col_key=list(src.col_key),
                            block_table=bt, block_expr=bt.ndarray,
                            whitened=Xw)


def _unwrap_tsm(A):
    return A.entry_expr if isinstance(A, TallSkinnyMatrix) else to_expr(A)


def _tsm_blocks(A) -> Tuple[np.ndarray, np.ndarray]:
    """(G, M) for an entry expression or TSM — whitened values when the TSM
    was built with a whitening window."""
    if isinstance(A, TallSkinnyMatrix) and A._whitened is not None:
        return A._whitened, np.zeros(A._whitened.shape, dtype=bool)
    return _entry_expr_to_blocks(_unwrap_tsm(A))


def _spectral_moments(A, num_moments: int, p=None, moment_samples: int = 500,
                      block_size: int = 128):
    """Estimate spectral moments (reference `pca.py:426` _spectral_moments).

    Computed exactly via host-side SVD of the extracted matrix (small
    decompositions belong on the host), so the returned stdev estimates are
    exactly zero."""
    G, M = _tsm_blocks(A)
    if M.any():
        G = np.where(M, 0.0, G)
    s = np.linalg.svd(G, compute_uv=False)    # host LAPACK (G is host-side)
    moments = [float(np.sum(s ** (2 * i))) for i in range(1, num_moments + 1)]
    stdevs = [0.0] * len(moments)
    return moments, stdevs


def _hwe_normalized_blanczos(call_expr, k: int = 10,
                             compute_loadings: bool = False,
                             q_iterations: int = 10,
                             oversampling_param: int = 10,
                             block_size: int = 128):
    """HWE-normalize the genotype matrix then run the randomized (Blanczos)
    PCA (reference pca.py:687 _hwe_normalized_blanczos)."""
    e = to_expr(call_expr)
    mt = e._indices.source
    ne = e.n_alt_alleles() if e.dtype == ht.tcall else e
    G, M = _entry_expr_to_blocks(ne)
    cnt = (~M).sum(axis=1)
    s = np.where(M, 0, G).sum(axis=1)
    mean = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    G = np.where(M, mean[:, None], G)
    p = mean / 2
    keep = (p > 0) & (p < 1) & (cnt > 0)
    Gk = G[keep]
    m = Gk.shape[0]
    denom = np.sqrt(2 * p[keep] * (1 - p[keep]) * m)
    Z = (Gk - mean[keep][:, None]) / denom[:, None]
    U, sv, Vt = _randomized_svd(jnp.asarray(Z), k, q=q_iterations,
                                oversample=oversampling_param,
                                seed=Env.next_seed())
    eigvals = list(np.asarray(sv * sv))
    scores = np.asarray(Vt.T * np.asarray(sv)[None, :])
    st = _scores_table(mt, scores)
    lt = None
    if compute_loadings:
        st_rows = mt.rows()._stage.collect_single().compress(keep)
        loadings = np.asarray(U)
        kk = loadings.shape[1]
        b = Batch({
            **{kf: st_rows.columns[kf] for kf in mt._stage.row_key},
            'loadings': DenseArrayColumn(ht.tarray(ht.tfloat64), loadings,
                                         np.full(loadings.shape[0], kk, np.int32)),
        }, st_rows.length)
        lt = Table(TableStage.from_batches(Batch({}, 1), mt._stage.row_key,
                                           b.row_type, [b]))
    return eigvals, st, lt


def _pca_and_moments(A, k=10, num_moments=5, compute_loadings=False,
                     q_iterations=10, oversampling_param=None, block_size=128,
                     moment_samples=100):
    """Joint randomized PCA + spectral-moment estimates
    (reference pca.py:458 _pca_and_moments)."""
    if oversampling_param is None:
        oversampling_param = 10
    eigvals, st, lt = _blanczos_pca(A, k=k, compute_loadings=compute_loadings,
                                    q_iterations=q_iterations,
                                    oversampling_param=oversampling_param,
                                    block_size=block_size)
    moments, stdevs = _spectral_moments(A, num_moments, block_size=block_size)
    return eigvals, st, lt, moments, stdevs
