"""Jitted regression kernels (the device GEMM tier).

These are the hot GWAS loops: batched per-variant OLS via the projection
trick and batched Newton iterations for logistic/poisson regression —
replacing the reference's per-partition Breeze GEMMs
(`is/hail/methods/LinearRegression.scala:18-198`,
`LogisticRegression.scala`) with XLA-fused jnp over (block_rows, n_samples)
dosage blocks. f64 on the solver path for numeric parity with the JVM
(SURVEY §7 hard-parts: jax_enable_x64).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_enable_x64', True)


def _impute_mean(G: jnp.ndarray, missing: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Mean-impute missing entries per variant row. G: (R, N); missing bool."""
    cnt = jnp.sum(~missing, axis=1)
    s = jnp.sum(jnp.where(missing, 0.0, G), axis=1)
    mean = jnp.where(cnt > 0, s / jnp.maximum(cnt, 1), 0.0)
    Gi = jnp.where(missing, mean[:, None], G)
    return Gi, cnt, s


def _impute_mean_nan(G: jnp.ndarray, missing: jnp.ndarray) -> jnp.ndarray:
    """Reference mean_impute semantics (statgen.py:490): missing entries take
    the mean of the non-missing entries; an all-missing row imputes NaN."""
    cnt = jnp.sum(~missing, axis=1).astype(G.dtype)
    s = jnp.sum(jnp.where(missing, 0.0, G), axis=1)
    mean = s / cnt                                   # 0/0 → nan, as reference
    return jnp.where(missing, mean[:, None], G)


@partial(jax.jit, static_argnames=())
def linreg_block(G: jnp.ndarray, missing: jnp.ndarray, sqrtw: jnp.ndarray,
                 Q: jnp.ndarray, Ys: jnp.ndarray, Qty: jnp.ndarray,
                 yyp: jnp.ndarray, d: jnp.ndarray):
    """Per-variant OLS, the reference `_linear_regression_rows_nd` block
    formula (statgen.py:631 process_block) on the device.

    G: (R, n) raw dosages over the group's kept samples; missing: (R, n);
    sqrtw: (n,) sqrt-weights (ones when unweighted); Q: (n, k) orthonormal
    basis of the (scaled) covariates; Ys: (n, P) scaled phenotypes;
    Qty: (k, P) = Qᵀ Ys; yyp: (P,) residual y·y; d: scalar dof = n-k-1.
    Degenerate fits propagate NaN (no masking), matching the reference.
    Returns (sum_x, ytx, beta, se, t).
    """
    Gi = _impute_mean_nan(G, missing)
    X = Gi * sqrtw[None, :]                  # (R, n)
    sum_x = jnp.sum(X, axis=1)
    Qtx = X @ Q                              # (R, k)   [GEMM]
    ytx = X @ Ys                             # (R, P)   [GEMM]
    xyp = ytx - Qtx @ Qty                    # (R, P)
    xxp = jnp.sum(X * X, axis=1) - jnp.sum(Qtx * Qtx, axis=1)
    xxp_rec = 1.0 / xxp
    beta = xyp * xxp_rec[:, None]
    se = jnp.sqrt((1.0 / d) * (yyp[None, :] * xxp_rec[:, None] - beta * beta))
    t = beta / se
    return sum_x, ytx, beta, se, t


@partial(jax.jit, static_argnames=())
def linreg_block_f32(G, missing, sqrtw, Q, Ys, Qty, yyp, d):
    """f32 variant of linreg_block (for when 1e-8 JVM parity
    is not required — betas agree to ~1e-5 relative)."""
    return linreg_block(G.astype(jnp.float32), missing,
                        sqrtw.astype(jnp.float32), Q.astype(jnp.float32),
                        Ys.astype(jnp.float32), Qty.astype(jnp.float32),
                        yyp.astype(jnp.float32), d.astype(jnp.float32))


def linreg_stats(G: np.ndarray, missing: np.ndarray, sqrtw, Q: np.ndarray,
                 Ys: np.ndarray, Qty: np.ndarray, yyp: np.ndarray, dof: int,
                 precision: str = 'float64'):
    """Host wrapper: returns numpy (R, P) arrays incl. p-values
    (2·pT(-|t|, d), scipy t-dist)."""
    import scipy.stats as st
    kernel = linreg_block if precision == 'float64' else linreg_block_f32
    if sqrtw is None:
        sqrtw = np.ones(G.shape[1])
    sum_x, ytx, beta, se, t = (np.asarray(v, dtype=np.float64) for v in kernel(
        jnp.asarray(G), jnp.asarray(missing), jnp.asarray(sqrtw),
        jnp.asarray(Q), jnp.asarray(Ys), jnp.asarray(Qty), jnp.asarray(yyp),
        jnp.asarray(float(dof))))
    with np.errstate(all='ignore'):
        p = 2 * st.t.sf(np.abs(t), dof) if dof > 0 else np.full_like(t, np.nan)
    return dict(sum_x=sum_x, y_transpose_x=ytx, beta=beta,
                standard_error=se, t_stat=t, p_value=p)


# ---------------------------------------------------------------------------
# logistic / poisson regression (batched Newton)
# ---------------------------------------------------------------------------

def _psd_solve(H, b):
    """Batched SPD solve via Cholesky (the Newton Hessians here are SPD, so
    Cholesky needs half the work of LU)."""
    L = jnp.linalg.cholesky(H)
    y = jax.lax.linalg.triangular_solve(L, b[..., None], left_side=True, lower=True)
    x = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                        transpose_a=True)
    return x[..., 0]


def _psd_inv(H):
    k = H.shape[-1]
    L = jnp.linalg.cholesky(H)
    eye = jnp.broadcast_to(jnp.eye(k, dtype=H.dtype), H.shape)
    y = jax.lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    return jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                           transpose_a=True)


def _psd_logdet(H):
    L = jnp.linalg.cholesky(H)
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(jnp.maximum(d, 1e-300)), axis=-1)


def _sigmoid(x):
    return 0.5 * (jnp.tanh(x / 2) + 1)


@partial(jax.jit, static_argnames=('max_iter',))
def logreg_null_fit(X: jnp.ndarray, y: jnp.ndarray, max_iter: int = 25,
                    tol: float = 1e-6):
    """Fit logit(y) ~ X by Newton-Raphson. X: (N, k), y: (N,).
    Returns (beta, mu, converged, ll)."""
    N, k = X.shape

    def step(state):
        beta, _, it, _ = state
        eta = X @ beta
        mu = _sigmoid(eta)
        W = mu * (1 - mu)
        grad = X.T @ (y - mu)
        H = (X * W[:, None]).T @ X
        delta = _psd_solve(H + 1e-12 * jnp.eye(k), grad)
        new_beta = beta + delta
        return new_beta, jnp.max(jnp.abs(delta)), it + 1, H

    def cond(state):
        _, delta, it, _ = state
        return (delta > tol) & (it < max_iter)

    beta0 = jnp.zeros(k).at[0].set(jnp.log(jnp.mean(y) / (1 - jnp.mean(y) + 1e-12) + 1e-12))
    state = (beta0, jnp.inf, 0, jnp.eye(k))
    beta, delta, it, H = jax.lax.while_loop(cond, step, state)
    mu = _sigmoid(X @ beta)
    ll = jnp.sum(y * jnp.log(mu + 1e-300) + (1 - y) * jnp.log(1 - mu + 1e-300))
    return beta, mu, (delta <= tol), ll, it


@partial(jax.jit, static_argnames=('max_iter', 'link'))
def glm_per_variant_fit(G, missing, Cov, y, beta_null, max_iter: int = 25,
                        tol: float = 1e-6, link: str = 'logistic'):
    """Batched per-variant GLM fit: logit/log(y) ~ Cov + g.

    G: (R, N); Cov: (N, k); y: (N,); beta_null: (k,) warm start.
    Returns (beta_full (R, k+1) [g coef last], se_g, chi2_lrt, converged, n_iter,
             ll_full, score_chi2).
    """
    R, N = G.shape
    k = Cov.shape[1]
    Gi, cnt, _ = _impute_mean(G, missing)

    def linkinv(eta):
        return _sigmoid(eta) if link == 'logistic' else jnp.exp(eta)

    def variance(mu):
        return mu * (1 - mu) if link == 'logistic' else mu

    b0 = jnp.concatenate([jnp.broadcast_to(beta_null, (R, k)), jnp.zeros((R, 1))], axis=1)

    def newton_step(state):
        b, _, it = state
        eta = Cov @ b[:, :k].T            # (N, R)
        eta = eta.T + Gi * b[:, k:k + 1]  # (R, N)
        mu = linkinv(eta)
        W = variance(mu)
        r = y[None, :] - mu               # (R, N)
        grad_c = r @ Cov                  # (R, k)
        grad_g = jnp.sum(r * Gi, axis=1)  # (R,)
        grad = jnp.concatenate([grad_c, grad_g[:, None]], axis=1)
        Hcc = jnp.einsum('rn,nk,nl->rkl', W, Cov, Cov)
        Hcg = jnp.einsum('rn,rn,nk->rk', W, Gi, Cov)
        Hgg = jnp.sum(W * Gi * Gi, axis=1)
        H = jnp.zeros((R, k + 1, k + 1))
        H = H.at[:, :k, :k].set(Hcc)
        H = H.at[:, :k, k].set(Hcg)
        H = H.at[:, k, :k].set(Hcg)
        H = H.at[:, k, k].set(Hgg)
        delta = _psd_solve(H + 1e-12 * jnp.eye(k + 1)[None], grad)
        nb = b + delta
        return nb, jnp.max(jnp.abs(delta), axis=1), it + 1

    def cond(state):
        _, delta, it = state
        return (jnp.max(delta) > tol) & (it < max_iter)

    state = (b0, jnp.full(R, jnp.inf), 0)
    b, delta, it = jax.lax.while_loop(cond, newton_step, state)

    eta = (Cov @ b[:, :k].T).T + Gi * b[:, k:k + 1]
    mu = linkinv(eta)
    W = variance(mu)
    Hcc = jnp.einsum('rn,nk,nl->rkl', W, Cov, Cov)
    Hcg = jnp.einsum('rn,rn,nk->rk', W, Gi, Cov)
    Hgg = jnp.sum(W * Gi * Gi, axis=1)
    H = jnp.zeros((R, k + 1, k + 1))
    H = H.at[:, :k, :k].set(Hcc)
    H = H.at[:, :k, k].set(Hcg)
    H = H.at[:, k, :k].set(Hcg)
    H = H.at[:, k, k].set(Hgg)
    cov = _psd_inv(H + 1e-12 * jnp.eye(k + 1)[None])
    se_g = jnp.sqrt(jnp.maximum(cov[:, k, k], 0.0))
    if link == 'logistic':
        ll = jnp.sum(y[None] * jnp.log(mu + 1e-300) + (1 - y[None]) * jnp.log(1 - mu + 1e-300), axis=1)
    else:
        ll = jnp.sum(y[None] * eta - mu, axis=1)
    converged = delta <= tol
    return b, se_g, ll, converged, it, cnt


@partial(jax.jit, static_argnames=('link',))
def glm_score_test(G, missing, Cov, y, beta_null, link: str = 'logistic'):
    """Score test at the null fit (reference LogisticRegression score path)."""
    Gi, cnt, _ = _impute_mean(G, missing)
    eta0 = Cov @ beta_null
    mu0 = _sigmoid(eta0) if link == 'logistic' else jnp.exp(eta0)
    W0 = mu0 * (1 - mu0) if link == 'logistic' else mu0
    r0 = y - mu0
    U_g = Gi @ r0                               # (R,)
    Icc = (Cov * W0[:, None]).T @ Cov           # (k, k)
    Icg = (Gi * W0[None, :]) @ Cov              # (R, k)
    Igg = jnp.sum(W0[None, :] * Gi * Gi, axis=1)
    sol = _psd_solve(jnp.broadcast_to(Icc[None], (Icg.shape[0],) + Icc.shape), Icg)  # (R, k)
    var_g = Igg - jnp.sum(Icg * sol, axis=1)
    chi2 = U_g * U_g / jnp.maximum(var_g, 1e-300)
    return chi2, cnt


@partial(jax.jit, static_argnames=('max_iter', 'm0'))
def firth_fit(G, missing, Cov, y, beta_start, m0: int, max_iter: int = 100,
              tol: float = 1e-6):
    """Batched Firth penalized fit of logit(y) ~ [Cov, g] updating only the
    first m0 coefficients (reference `stats/LogisticRegressionModel.scala`
    fitFirth: the hat diagonal and the penalty 0.5·logdet(XᵀWX) always use
    the FULL design — the restricted null fit per variant freezes the
    genotype coefficient at 0 but keeps its column in the penalty).
    Returns (beta, penalized logLkhd, converged, n_iter)."""
    R, N = G.shape
    k = Cov.shape[1]
    m = k + 1
    Gi, cnt, _ = _impute_mean(G, missing)

    def design_apply(b):
        # X @ b with X = [Cov, g]
        return (Cov @ b[:, :k].T).T + Gi * b[:, k:k + 1]

    def full_quadratics(W):
        Hcc = jnp.einsum('rn,nk,nl->rkl', W, Cov, Cov)
        Hcg = jnp.einsum('rn,rn,nk->rk', W, Gi, Cov)
        Hgg = jnp.sum(W * Gi * Gi, axis=1)
        H = jnp.zeros((R, m, m))
        H = H.at[:, :k, :k].set(Hcc)
        H = H.at[:, :k, k].set(Hcg)
        H = H.at[:, k, :k].set(Hcg)
        H = H.at[:, k, k].set(Hgg)
        return H

    def halfstep(state):
        b, _, it = state
        eta = design_apply(b)
        mu = _sigmoid(eta)
        W = mu * (1 - mu)
        H = full_quadratics(W) + 1e-12 * jnp.eye(m)[None]
        Hinv = _psd_inv(H)
        # hat diagonal h_i = w_i · x_iᵀ H⁻¹ x_i over the FULL design
        # expand x_i = [cov_i, g_i]: quadratic form via blocks
        A = Hinv[:, :k, :k]
        bvec = Hinv[:, :k, k]
        dgg = Hinv[:, k, k]
        q_cc = jnp.einsum('nk,rkl,nl->rn', Cov, A, Cov)
        q_cg = jnp.einsum('rn,rk,nk->rn', Gi, bvec, Cov)
        h = W * (q_cc + 2 * q_cg + dgg[:, None] * Gi * Gi)
        adj_r = y[None] - mu + h * (0.5 - mu)
        grad_c = adj_r @ Cov
        grad_g = jnp.sum(adj_r * Gi, axis=1)
        grad = jnp.concatenate([grad_c, grad_g[:, None]], axis=1)
        # restricted solve: only the first m0 coefficients move
        H0 = H[:, :m0, :m0]
        delta0 = _psd_solve(H0, grad[:, :m0])
        delta = jnp.zeros((R, m)).at[:, :m0].set(delta0)
        return b + delta, jnp.max(jnp.abs(delta), axis=1), it + 1

    def cond(state):
        _, delta, it = state
        return (jnp.max(delta) > tol) & (it < max_iter)

    state = (beta_start, jnp.full(R, jnp.inf), 0)
    b, delta, it = jax.lax.while_loop(cond, halfstep, state)
    eta = design_apply(b)
    mu = _sigmoid(eta)
    W = mu * (1 - mu)
    H = full_quadratics(W) + 1e-12 * jnp.eye(m)[None]
    logdet = _psd_logdet(H)
    ll = jnp.sum(y[None] * jnp.log(mu + 1e-300) + (1 - y[None]) * jnp.log(1 - mu + 1e-300), axis=1)
    ll_pen = ll + 0.5 * logdet
    return b, ll_pen, delta <= tol, it, cnt
