"""Device/host-split matrix decompositions.

The reference does big GEMMs distributed and all small factorizations
on the driver (`hail/python/hail/methods/pca.py:345-404` — the Krylov
factorization runs the tiny SVD locally; `linalg/BlockMatrix.scala` svd
localizes under a complexity bound and otherwise eigendecomposes the smaller
gramian locally). This module is that split for JAX:

- device: only matmuls — never a device-side factorization;
- host: LAPACK on small matrices (l x l Cholesky/eigh, driver-side SVD).

Every function accepts jax or numpy inputs; GEMMs run wherever the input
lives. Device->host fetches are limited to l x l (or k-column) matrices.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ['chol_qr', 'randomized_svd', 'gramian_svd', 'host_svd']


def _host(x) -> np.ndarray:
    return np.asarray(x)


def _orthonormalizer(G: np.ndarray) -> np.ndarray:
    """Given G = Y^T Y (host, l x l), return host R^{-1} with Y @ R^{-1}
    orthonormal. Cholesky when G is PD; symmetric (eigh) orthogonalization
    as the rank-deficient fallback."""
    l = G.shape[0]
    try:
        L = np.linalg.cholesky(G)
        return np.linalg.inv(L).T          # R^{-1} = (L^T)^{-1}
    except np.linalg.LinAlgError:
        w, V = np.linalg.eigh(G)
        tol = max(np.max(w), 0.0) * l * np.finfo(G.dtype).eps
        inv_sqrt = np.where(w > tol, 1.0 / np.sqrt(np.maximum(w, tol)), 0.0)
        return (V * inv_sqrt[None, :]) @ V.T


def chol_qr(Y, rounds: int = 2):
    """Tall-skinny orthonormalization via CholeskyQR^2.

    Y: (m, l) with small l. Each round is one device GEMM (Y^T Y), one host
    l x l factorization, and one device GEMM (Y @ R^{-1}). Two rounds give
    orthogonality to machine precision for any reasonably conditioned Y
    (CholeskyQR2, Yamamoto et al.). Returns Q on the same backend as Y."""
    Q = Y
    for _ in range(rounds):
        G = _host(Q.T @ Q)
        Rinv = _orthonormalizer(G)
        Rinv = jnp.asarray(Rinv) if isinstance(Q, jnp.ndarray) else Rinv
        Q = Q @ Rinv
    return Q


def randomized_svd(A, k: int, q: int = 2, oversample: int = 10,
                   seed: int = 0):
    """Halko randomized SVD (the reference's Blanczos scheme, pca.py:345)
    with only GEMMs on device.

    Returns (U (m,k) device/backend-of-A, s (k,) host float64,
    Vt (k,n) backend-of-A)."""
    m, n = A.shape
    l = min(k + oversample, min(m, n))
    rng = np.random.default_rng(seed & 0xFFFFFFFF)
    Omega = rng.normal(size=(n, l)).astype(np.dtype(A.dtype))
    if isinstance(A, jnp.ndarray):
        Omega = jnp.asarray(Omega)
    Y = A @ Omega
    Q = chol_qr(Y)
    for _ in range(q):
        Z = A.T @ Q
        Qz = chol_qr(Z)
        Y = A @ Qz
        Q = chol_qr(Y)
    B = Q.T @ A                              # (l, n), device
    BBt = _host(B @ B.T)                     # l x l fetch
    w, V = np.linalg.eigh(BBt)               # host, ascending
    w = w[::-1]
    V = V[:, ::-1]
    s = np.sqrt(np.maximum(w, 0.0))
    tol = s[0] * max(m, n) * np.finfo(s.dtype).eps if s.size else 0.0
    sinv = np.where(s > tol, 1.0 / np.maximum(s, tol if tol > 0 else 1.0), 0.0)
    W = sinv[:, None] * V.T                  # diag(1/s) @ V^T, host l x l
    W = jnp.asarray(W) if isinstance(A, jnp.ndarray) else W
    Vt = W @ B                               # (l, n) device GEMM
    Ub = jnp.asarray(V) if isinstance(A, jnp.ndarray) else V
    U = Q @ Ub                               # (m, l) device GEMM
    return U[:, :k], s[:k], Vt[:k]


def gramian_svd(A, compute_uv: bool = True):
    """Exact SVD of a (possibly device-resident) matrix via the smaller
    gramian: device GEMM for A^T A (or A A^T), host eigh, device GEMM to
    recover the long factor. Mirrors the reference BlockMatrix svd path
    above its complexity bound (`linalg/BlockMatrix.scala` svd)."""
    m, n = A.shape
    on_dev = isinstance(A, jnp.ndarray)
    if n <= m:
        G = _host(A.T @ A)                   # n x n fetch
        w, V = np.linalg.eigh(G)
        w, V = w[::-1], V[:, ::-1]
        s = np.sqrt(np.maximum(w, 0.0))
        if not compute_uv:
            return s
        tol = (s[0] * max(m, n) * np.finfo(s.dtype).eps) if s.size else 0.0
        sinv = np.where(s > tol, 1.0 / np.maximum(s, max(tol, 1e-300)), 0.0)
        Vd = jnp.asarray(V) if on_dev else V
        U = (A @ Vd) * (jnp.asarray(sinv) if on_dev else sinv)[None, :]
        return _host(U), s, V.T
    G = _host(A @ A.T)                       # m x m fetch
    w, U = np.linalg.eigh(G)
    w, U = w[::-1], U[:, ::-1]
    s = np.sqrt(np.maximum(w, 0.0))
    if not compute_uv:
        return s
    tol = (s[0] * max(m, n) * np.finfo(s.dtype).eps) if s.size else 0.0
    sinv = np.where(s > tol, 1.0 / np.maximum(s, max(tol, 1e-300)), 0.0)
    Ud = jnp.asarray(U) if on_dev else U
    Vt = (jnp.asarray(sinv) if on_dev else sinv)[:, None] * (Ud.T @ A)
    return U, s, _host(Vt)


def host_svd(A, full_matrices: bool = False):
    """Driver-side LAPACK SVD of a small matrix (fetches A if on device)."""
    return np.linalg.svd(_host(A), full_matrices=full_matrices)
