"""LinearMixedModel: REML fit via GRM eigendecomposition (EMMAX/FaST-LMM
formulation).

Capability parity with reference `is/hail/stats/LinearMixedModel.scala` /
`hail/python/hail/stats/linear_mixed_model.py`: y = Xβ + g + ε with
g ~ N(0, σ²_g K), ε ~ N(0, σ²_e I). With K = U S Uᵀ, rotating by Uᵀ
diagonalizes the covariance: Var(Uᵀy) = σ²_g (S + δ I), δ = σ²_e/σ²_g.
The device tier does the eigendecomposition and rotations (GEMMs); the scalar
REML optimization over log δ runs per dataset on the host.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


class LinearMixedModel:
    def __init__(self, py: np.ndarray, px: np.ndarray, s: np.ndarray,
                 y: Optional[np.ndarray] = None, x: Optional[np.ndarray] = None):
        """py = Uᵀ y (rotated phenotype), px = Uᵀ X (rotated covariates),
        s = eigenvalues of K (descending)."""
        self.py = np.asarray(py, dtype=np.float64)
        self.px = np.asarray(px, dtype=np.float64)
        self.s = np.asarray(s, dtype=np.float64)
        self.y = y
        self.x = x
        self.beta: Optional[np.ndarray] = None
        self.sigma_sq: Optional[float] = None
        self.tau_sq: Optional[float] = None
        self.gamma: Optional[float] = None
        self.log_gamma: Optional[float] = None
        self.h_sq: Optional[float] = None
        self._fitted = False
        self._u: Optional[np.ndarray] = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_kinship(cls, y: np.ndarray, x: np.ndarray, k: np.ndarray,
                     p_path=None, overwrite=False) -> 'LinearMixedModel':
        """Full-rank: eigendecompose the kinship matrix K (n×n)."""
        y = np.asarray(y, np.float64)
        x = np.asarray(x, np.float64)
        k = np.asarray(k, np.float64)
        import jax.numpy as jnp
        s, u = np.linalg.eigh(k)
        order = np.argsort(s)[::-1]
        s = s[order]
        u = u[:, order]
        model = cls(u.T @ y, u.T @ x, np.maximum(s, 0.0), y, x)
        model._u = u
        return model

    @classmethod
    def from_random_effects(cls, y: np.ndarray, x: np.ndarray, z: np.ndarray,
                            p_path=None, overwrite=False, max_rank=None
                            ) -> 'LinearMixedModel':
        """Low-rank: Z (n×m) random-effect design; K = ZZᵀ/m."""
        y = np.asarray(y, np.float64)
        x = np.asarray(x, np.float64)
        z = np.asarray(z, np.float64)
        m = z.shape[1]
        u, sv, _ = np.linalg.svd(z, full_matrices=True)
        s = np.zeros(z.shape[0])
        s[:len(sv)] = sv * sv / m
        model = cls(u.T @ y, u.T @ x, s, y, x)
        model._u = u
        return model

    # -- REML fit ----------------------------------------------------------
    def _neg_reml(self, log_delta: float) -> Tuple[float, np.ndarray, float]:
        delta = math.exp(log_delta)
        d = self.s + delta                     # eigenvalue weights
        w = 1.0 / d
        px, py = self.px, self.py
        n, k = px.shape
        xtx = (px * w[:, None]).T @ px
        xty = (px * w[:, None]).T @ py
        try:
            beta = np.linalg.solve(xtx, xty)
        except np.linalg.LinAlgError:
            return np.inf, np.zeros(k), 1.0
        r = py - px @ beta
        rss = float(np.sum(w * r * r))
        dof = n - k
        sigma_g2 = rss / dof
        # REML log-likelihood (up to constants)
        sign, logdet_xtx = np.linalg.slogdet(xtx)
        ll = -0.5 * (np.sum(np.log(d)) + dof * math.log(rss) + logdet_xtx)
        return -ll, beta, sigma_g2

    def fit(self, log_gamma: Optional[float] = None, bounds=(-8.0, 8.0),
            tol: float = 1e-8, maxiter: int = 500) -> None:
        from scipy.optimize import minimize_scalar
        if log_gamma is not None:
            # gamma = sigma_g^-2? reference parameterizes log_gamma = log(1/delta)
            best_ld = -log_gamma
        else:
            res = minimize_scalar(lambda ld: self._neg_reml(ld)[0],
                                  bounds=bounds, method='bounded',
                                  options={'xatol': tol, 'maxiter': maxiter})
            best_ld = float(res.x)
        _, beta, sigma_g2 = self._neg_reml(best_ld)
        delta = math.exp(best_ld)
        self.beta = beta
        self.sigma_sq = sigma_g2                # genetic variance component
        self.tau_sq = sigma_g2 * delta          # environmental
        self.gamma = 1.0 / delta
        self.log_gamma = -best_ld
        self.h_sq = self.sigma_sq / (self.sigma_sq + self.tau_sq)
        self._fitted = True

    @property
    def fitted(self) -> bool:
        return self._fitted

    # -- per-variant association ------------------------------------------
    def fit_alternatives_numpy(self, pa: np.ndarray, a=None):
        """Per-variant LRT given rotated genotypes pa (n×m variants).
        Returns dict of arrays (beta, sigma_sq, chi_sq, p_value)."""
        import scipy.stats as st
        assert self._fitted
        delta = 1.0 / self.gamma
        d = self.s + delta
        w = 1.0 / d
        px, py = self.px, self.py
        n, k = px.shape
        m = pa.shape[1]
        betas = np.zeros(m)
        chi2 = np.zeros(m)
        sig = np.zeros(m)
        # null restricted LL
        null_nll, _, _ = self._neg_reml(math.log(delta))
        wpx = px * w[:, None]
        xtx0 = wpx.T @ px
        xty0 = wpx.T @ py
        for j in range(m):
            g = pa[:, j]
            wg = w * g
            xtx = np.zeros((k + 1, k + 1))
            xtx[:k, :k] = xtx0
            xtx[:k, k] = wpx.T @ g
            xtx[k, :k] = xtx[:k, k]
            xtx[k, k] = float(g @ wg)
            xty = np.concatenate([xty0, [float(wg @ py)]])
            try:
                beta = np.linalg.solve(xtx, xty)
            except np.linalg.LinAlgError:
                betas[j] = np.nan
                chi2[j] = np.nan
                continue
            r = py - px @ beta[:k] - g * beta[k]
            rss = float(np.sum(w * r * r))
            dof = n - k - 1
            sigma_g2 = rss / dof
            sign, logdet = np.linalg.slogdet(xtx)
            ll = -0.5 * (np.sum(np.log(d)) + dof * math.log(rss) + logdet)
            betas[j] = beta[k]
            sig[j] = sigma_g2
            chi2[j] = 2 * (ll - (-null_nll))
        chi2 = np.maximum(chi2, 0)
        p = st.chi2.sf(chi2, 1)
        return {'beta': betas, 'sigma_sq': sig, 'chi_sq': chi2, 'p_value': p}

    def fit_alternatives_batched(self, pa: np.ndarray):
        """Vectorized per-variant LRT over rotated genotypes pa (n×m).

        Same statistics as `fit_alternatives_numpy` but computed in closed
        form for all variants at once (rank-one update of the weighted
        normal equations — the augmented RSS is RSS_X - (gᵀWM_Xy)²/(gᵀWM_Xg)
        and logdet grows by log of the Schur complement), with the heavy
        GEMMs on the device. The per-variant Python loop is O(m·k³);
        this is two (k×n)·(n×m) GEMMs + elementwise.
        """
        import scipy.stats as st
        import jax.numpy as jnp
        assert self._fitted
        delta = 1.0 / self.gamma
        d = self.s + delta
        w = 1.0 / d
        px, py = self.px, self.py
        n, k = px.shape

        wpx = px * w[:, None]                  # n×k
        xtx0 = wpx.T @ px                      # k×k
        xty0 = wpx.T @ py                      # k
        xtx0_inv = np.linalg.inv(xtx0)
        beta0 = xtx0_inv @ xty0
        r0 = py - px @ beta0                   # weighted-fit residual
        sign0, logdet0 = np.linalg.slogdet(xtx0)
        sum_log_d = float(np.sum(np.log(d)))
        null_nll, _, _ = self._neg_reml(math.log(delta))

        paj = jnp.asarray(pa)
        wj = jnp.asarray(w)
        # gW* contractions (device): xg = pxᵀW g per variant, plus scalars
        xg = jnp.asarray(wpx).T @ paj                      # k×m
        ggw = jnp.sum(paj * (wj[:, None] * paj), axis=0)    # m
        gy = (wj * py) @ paj                                # m
        gr0 = (wj * r0) @ paj                               # m  (= gᵀ W M_X y)
        xg_h = np.asarray(xg)
        ggw_h = np.asarray(ggw)
        gy_h = np.asarray(gy)
        gr0_h = np.asarray(gr0)

        s_g = ggw_h - np.einsum('km,kl,lm->m', xg_h, xtx0_inv, xg_h)
        with np.errstate(divide='ignore', invalid='ignore'):
            beta_g = gr0_h / s_g
            rss_x = float(np.sum(w * r0 * r0))
            rss = rss_x - gr0_h * gr0_h / s_g
            dof = n - k - 1
            sigma_g2 = rss / dof
            ll = -0.5 * (sum_log_d + dof * np.log(rss) + logdet0 + np.log(s_g))
            chi2 = 2 * (ll - (-null_nll))
        bad = ~np.isfinite(s_g) | (s_g <= 0) | ~np.isfinite(rss) | (rss <= 0)
        beta_g[bad] = np.nan
        chi2 = np.where(bad, np.nan, np.maximum(chi2, 0))
        p = st.chi2.sf(chi2, 1)
        return {'beta': beta_g, 'sigma_sq': sigma_g2, 'chi_sq': chi2,
                'p_value': p}

    def compute_neg_log_reml(self, log_gamma, return_parameters=False):
        """Historical API (reference docs): -REML log-likelihood at the given
        log γ (γ = σ²_g/σ²_e ⇒ log δ = -log γ)."""
        nll, beta, sigma_g2 = self._neg_reml(-float(log_gamma))
        if return_parameters:
            delta = math.exp(-float(log_gamma))
            return nll, beta, sigma_g2, sigma_g2 * delta
        return nll

    @property
    def h_sq_standard_error(self) -> Optional[float]:
        """Delta-method SE of h² from the curvature of the REML surface in
        log γ (numerical second derivative), mirroring the historical
        LinearMixedModel.h_sq_standard_error."""
        if not self._fitted:
            return None
        lg = self.log_gamma
        eps = 1e-3
        f = lambda x: self.compute_neg_log_reml(x)
        d2 = (f(lg + eps) - 2 * f(lg) + f(lg - eps)) / (eps * eps)
        if not np.isfinite(d2) or d2 <= 0:
            return None
        var_lg = 1.0 / d2
        g = math.exp(lg)
        dh_dlg = g / (1 + g) ** 2      # h² = γ/(1+γ)
        return float(dh_dlg * math.sqrt(var_lg))

    def h_sq_normalized_lkhd(self, n_points: int = 101) -> np.ndarray:
        """Normalized REML likelihood over an h² grid in (0,1) (historical
        API: discretized posterior for h²)."""
        hs = np.linspace(0.01, 0.99, n_points)
        lls = np.array([-self.compute_neg_log_reml(math.log(h / (1 - h)))
                        for h in hs])
        lls -= lls.max()
        lk = np.exp(lls)
        return lk / lk.sum()
