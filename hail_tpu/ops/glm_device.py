"""Device-tier GLM: batched per-variant Newton / Firth fits on the device.

This is the default engine behind `logistic_regression_rows` and
`poisson_regression_rows` (methods/statgen.py): one jitted kernel fits a
whole block of variants at once, replacing the reference's per-variant
LAPACK loops (`is/hail/methods/LogisticRegression.scala`, lowered python in
reference statgen.py:1041 `logreg_fit` / :1191 `_firth_fit` / :1852
`_poisson_fit`) with per-variant-frozen batched iterations.

Faithfulness contract (vs the host port in stats/glmfit.py, which is the
operation-for-operation reference mirror):
  * each variant's Newton trajectory is identical to its independent host
    loop: converged/exploded/maxed variants FREEZE (their b stops moving and
    their n_iterations/log_lkhd are recorded at the stop), while the batch
    keeps iterating the rest — so `n_iterations`, `converged`, `exploded`
    match the reference exactly, and b/se/p match to float-reassociation
    noise (~1e-13).
  * the initial score/fisher reuse the null fit's covariate blocks (the
    reference quirk at statgen.py:1069-1078), and the poisson wald/lrt
    prelude evaluates its initial mu with sigmoid (statgen.py:1833).
  * explosion = singular solve, detected on device as a non-finite Newton
    step (Cholesky of a singular SPD fisher yields NaNs; the reference's
    dgesv raises on the same matrices). No ridge is added — a ridge would
    mask the singularity the reference reports as `exploded`.

Solves use Cholesky (`jnp.linalg.cholesky` + triangular solves): the Newton
fisher matrices are SPD by construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_enable_x64', True)

from .regression import _impute_mean_nan  # noqa: E402


def _sigmoid(x):
    return 1.0 / (1.0 + jnp.exp(-x))


def _chol_solve(H, g):
    """Batched SPD solve; singular → NaN (explosion signal, see module doc)."""
    L = jnp.linalg.cholesky(H)
    y = jax.lax.linalg.triangular_solve(L, g[..., None], left_side=True,
                                        lower=True)
    x = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                        transpose_a=True)
    return x[..., 0]


def _bernoulli_ll(y, mu):
    return jnp.sum(jnp.log(y[None, :] * mu + (1.0 - y[None, :]) * (1.0 - mu)),
                   axis=-1)


# status codes for the per-variant freeze
_ACTIVE, _CONV, _EXPL, _MAXED = 0, 1, 2, 3


@partial(jax.jit, static_argnames=('max_iterations', 'link'))
def glm_newton_batch(G, Mmask, Cov, y, null_b, null_score, null_fisher,
                     max_iterations: int, tolerance: float,
                     link: str = 'logistic'):
    """Batched per-variant Newton fit of y ~ link⁻¹([Cov, g]·b).

    G: (R, N) raw dosages; Mmask: (R, N) missing; Cov: (N, k); y: (N,);
    null_b/score/fisher: the host null fit (k,), (k,), (k, k).

    Returns (b (R,m), score (R,m), fisher (R,m,m), n_iter (R,), ll (R,),
    status (R,)) with m = k+1 and status in {1: converged, 2: exploded,
    3: hit max_iterations}. Matches stats/glmfit.logreg_fit / poisson_fit
    per variant (see module docstring).
    """
    R, N = G.shape
    k = Cov.shape[1]
    m = k + 1
    Gi = _impute_mean_nan(G, Mmask)

    # initial state (reference statgen.py:1069-1078 / :1820-1840): b_g = 0 so
    # eta/mu are the shared null linear predictor; for poisson the prelude's
    # mu uses sigmoid (the reference quirk), the loop's updates use exp.
    eta0 = Cov @ null_b
    mu0 = _sigmoid(eta0)
    w0 = mu0 * (1.0 - mu0) if link == 'logistic' else mu0
    r0 = y - mu0
    # P[n, k*l] = Cov[n,k]·Cov[n,l]: turns the per-variant covariate Fisher
    # block Σ_n w[r,n]·Cov[n,k]·Cov[n,l] into ONE (R,N)x(N,k²) GEMM —
    # the batched-einsum form lowers to R tiny (k×N)(N×k) GEMMs, far too
    # small to fill the matrix units (k=4)
    P = (Cov[:, :, None] * Cov[:, None, :]).reshape(N, k * k)
    b0 = jnp.concatenate(
        [jnp.broadcast_to(null_b, (R, k)), jnp.zeros((R, 1))], axis=1)
    score0 = jnp.concatenate(
        [jnp.broadcast_to(null_score, (R, k)), (Gi @ r0)[:, None]], axis=1)
    f01 = (Gi * w0[None, :]) @ Cov                        # (R, k)
    f11 = jnp.sum(w0[None, :] * Gi * Gi, axis=1)          # (R,)
    fisher0 = jnp.zeros((R, m, m))
    fisher0 = fisher0.at[:, :k, :k].set(jnp.broadcast_to(null_fisher, (R, k, k)))
    fisher0 = fisher0.at[:, :k, k].set(f01)
    fisher0 = fisher0.at[:, k, :k].set(f01)
    fisher0 = fisher0.at[:, k, k].set(f11)
    mu_init = jnp.broadcast_to(mu0, (R, N))

    def loglik(mu):
        if link == 'logistic':
            return _bernoulli_ll(y, mu)
        return jnp.sum(y[None, :] * jnp.log(mu) - mu, axis=-1)

    def body(state):
        b, score, fisher, mu, status, n_iter, ll, it = state
        active = status == _ACTIVE
        delta = _chol_solve(fisher, score)                # (R, m)
        bad = ~jnp.all(jnp.isfinite(delta), axis=1)
        maxd = jnp.max(jnp.abs(delta), axis=1)
        now_expl = active & bad
        now_conv = active & ~bad & (maxd < tolerance)
        now_maxed = active & ~bad & ~(maxd < tolerance) & (it >= max_iterations)
        stopped = now_expl | now_conv | now_maxed
        status = jnp.where(now_expl, _EXPL,
                           jnp.where(now_conv, _CONV,
                                     jnp.where(now_maxed, _MAXED, status)))
        n_iter = jnp.where(stopped, it, n_iter)
        # ll is NOT computed here: mu freezes for stopped rows, so the
        # post-loop loglik(mu_final) equals the value at stop time — this
        # drops ~2·R·N f64 logs from every Newton iteration
        step = active & ~stopped
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        b = jnp.where(step[:, None], b + delta, b)
        # recompute mu/score/fisher at the stepped b (full recompute: the
        # null-block reuse happens only at initialization, as in reference)
        eta = (Cov @ b[:, :k].T).T + Gi * b[:, k:k + 1]   # (R, N)
        mu_new = _sigmoid(eta) if link == 'logistic' else jnp.exp(eta)
        w = mu_new * (1.0 - mu_new) if link == 'logistic' else mu_new
        r = y[None, :] - mu_new
        sc = jnp.concatenate([r @ Cov, jnp.sum(r * Gi, axis=1)[:, None]],
                             axis=1)
        Hcc = (w @ P).reshape(R, k, k)
        Hcg = (w * Gi) @ Cov
        Hgg = jnp.sum(w * Gi * Gi, axis=1)
        fi = jnp.zeros((R, m, m))
        fi = fi.at[:, :k, :k].set(Hcc)
        fi = fi.at[:, :k, k].set(Hcg)
        fi = fi.at[:, k, :k].set(Hcg)
        fi = fi.at[:, k, k].set(Hgg)
        mu = jnp.where(step[:, None], mu_new, mu)
        score = jnp.where(step[:, None], sc, score)
        fisher = jnp.where(step[:, None, None], fi, fisher)
        return b, score, fisher, mu, status, n_iter, ll, it + 1

    def cond(state):
        status = state[4]
        return jnp.any(status == _ACTIVE)

    state = (b0, score0, fisher0, mu_init,
             jnp.zeros(R, jnp.int32), jnp.zeros(R, jnp.int32),
             jnp.zeros(R), jnp.int32(1))
    b, score, fisher, mu, status, n_iter, ll, _ = jax.lax.while_loop(
        cond, body, state)
    ll = loglik(mu)          # mu is frozen at each row's stopping iteration
    return b, score, fisher, n_iter, ll, status


@jax.jit
def wald_stats_batch(b, fisher):
    """se/z for the genotype coefficient from inv(fisher) at the fit
    (reference wald_test, statgen.py:1136)."""
    m = b.shape[1]
    L = jnp.linalg.cholesky(fisher)
    eye = jnp.broadcast_to(jnp.eye(m), fisher.shape)
    yv = jax.lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    cov = jax.lax.linalg.triangular_solve(L, yv, left_side=True, lower=True,
                                          transpose_a=True)
    se = jnp.sqrt(cov[:, m - 1, m - 1])
    z = b[:, m - 1] / se
    return se, z


@partial(jax.jit, static_argnames=('link',))
def glm_score_batch(G, Mmask, Cov, y, null_b, null_score, null_fisher,
                    link: str = 'logistic'):
    """Batched full-system score test at the null (reference
    logistic_score_test statgen.py:1161 / _poisson_score_test :1924):
    chi² = scoreᵀ fisher⁻¹ score over the full (k+1) system, including the
    null fit's (≈tolerance-sized, nonzero) covariate score block."""
    R, N = G.shape
    k = Cov.shape[1]
    m = k + 1
    Gi = _impute_mean_nan(G, Mmask)
    eta0 = Cov @ null_b
    mu0 = _sigmoid(eta0) if link == 'logistic' else jnp.exp(eta0)
    w0 = mu0 * (1.0 - mu0) if link == 'logistic' else mu0
    r0 = y - mu0
    score = jnp.concatenate(
        [jnp.broadcast_to(null_score, (R, k)), (Gi @ r0)[:, None]], axis=1)
    f01 = (Gi * w0[None, :]) @ Cov
    f11 = jnp.sum(w0[None, :] * Gi * Gi, axis=1)
    fisher = jnp.zeros((R, m, m))
    fisher = fisher.at[:, :k, :k].set(jnp.broadcast_to(null_fisher, (R, k, k)))
    fisher = fisher.at[:, :k, k].set(f01)
    fisher = fisher.at[:, k, :k].set(f01)
    fisher = fisher.at[:, k, k].set(f11)
    sol = _chol_solve(fisher, score)
    chi2 = jnp.sum(score * sol, axis=1)
    return chi2


@partial(jax.jit, static_argnames=('m0', 'max_iterations'))
def firth_fit_batch(Gi, Cov, y, b0, m0: int, max_iterations: int,
                    tolerance: float):
    """Batched Firth penalized fit (reference _firth_fit, statgen.py:1191):
    QR of the weighted FULL design [Cov, g]·√W every iteration; only the
    first m0 coefficients move. Gi: (R, N) already-imputed dosages;
    b0: (R, m0) start. Returns (b, n_iter, ll, status) with the same
    per-variant freeze semantics as glm_newton_batch."""
    R, N = Gi.shape
    k = Cov.shape[1]
    M = k + 1   # full design width

    def eta_of(b):
        if m0 <= k:
            return jnp.broadcast_to((Cov[:, :m0] @ b.T).T, (R, N))
        return (Cov @ b[:, :k].T).T + Gi * b[:, k:k + 1]

    def body(state):
        b, status, n_iter, ll, it = state
        active = status == _ACTIVE
        mu = _sigmoid(eta_of(b))                          # (R, N)
        w = mu * (1.0 - mu)
        # Normal equations instead of the reference's per-variant QR of
        # √W·X (statgen.py:1222): with M ≤ a handful the Cholesky route is
        # exact enough and cheaper than a batched QR (F = XᵀWX = RᵀR, so
        # Σ log diag L = Σ log|diag R|, h_n = w_n‖L⁻¹xₙ‖², and the leading
        # m0×m0 block of L is the Cholesky of F₁₁). Explosion = non-SPD
        # F → NaNs in L, the same singularities QR reported via diag R.
        wg = w * Gi                                       # (R, N)
        F_cc = jnp.einsum('ni,rn,nj->rij', Cov, w, Cov)
        F_cg = jnp.einsum('ni,rn->ri', Cov, wg)
        F_gg = jnp.sum(wg * Gi, axis=1)
        F = jnp.concatenate([
            jnp.concatenate([F_cc, F_cg[:, :, None]], axis=2),
            jnp.concatenate([F_cg[:, None, :], F_gg[:, None, None]],
                            axis=2)], axis=1)             # (R, M, M)
        L = jnp.linalg.cholesky(F)
        Xt = jnp.concatenate(
            [jnp.broadcast_to(Cov.T[None], (R, k, N)), Gi[:, None, :]],
            axis=1)                                       # (R, M, N)
        V = jax.lax.linalg.triangular_solve(
            L, Xt, left_side=True, lower=True)
        h = w * jnp.sum(V * V, axis=1)                    # (R, N)
        resid = y[None, :] - mu
        rho = resid + h * (0.5 - mu)
        dep = jnp.einsum('rmn,rn->rm', Xt[:, :m0], rho)
        L11 = L[:, :m0, :m0]
        diag_l0 = jnp.diagonal(L11, axis1=1, axis2=2)
        bad_coef = (~jnp.all(jnp.isfinite(diag_l0), axis=1)
                    | jnp.any(diag_l0 == 0.0, axis=1))
        t1 = jax.lax.linalg.triangular_solve(
            L11, dep[..., None], left_side=True, lower=True)
        delta = jax.lax.linalg.triangular_solve(
            L11, t1, left_side=True, lower=True, transpose_a=True)[..., 0]
        bad = bad_coef | ~jnp.all(jnp.isfinite(delta), axis=1)
        maxd = jnp.where(jnp.all(jnp.isfinite(delta), axis=1),
                         jnp.max(jnp.abs(delta), axis=1), jnp.inf)
        diag_full = jnp.diagonal(L, axis1=1, axis2=2)
        ll_now = (_bernoulli_ll(y, mu)
                  + jnp.sum(jnp.log(jnp.abs(diag_full)), axis=1))
        now_expl = active & bad
        now_conv = active & ~bad & (maxd < tolerance)
        now_maxed = active & ~bad & ~(maxd < tolerance) & (it >= max_iterations)
        stopped = now_expl | now_conv | now_maxed
        status = jnp.where(now_expl, _EXPL,
                           jnp.where(now_conv, _CONV,
                                     jnp.where(now_maxed, _MAXED, status)))
        n_iter = jnp.where(stopped, it, n_iter)
        ll = jnp.where(stopped, ll_now, ll)
        step = active & ~stopped
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        b = jnp.where(step[:, None], b + delta, b)
        return b, status, n_iter, ll, it + 1

    def cond(state):
        return jnp.any(state[1] == _ACTIVE)

    state = (b0, jnp.zeros(R, jnp.int32), jnp.zeros(R, jnp.int32),
             jnp.zeros(R), jnp.int32(1))
    b, status, n_iter, ll, _ = jax.lax.while_loop(cond, body, state)
    return b, n_iter, ll, status


# ---------------------------------------------------------------------------
# host drivers: blocked execution + result assembly
# ---------------------------------------------------------------------------

def _firth_row_block(N: int, M: int) -> int:
    """Row block sized so the (R, N, M) QR workspace stays ≲0.5 GiB f64."""
    return max(16, min(1024, (1 << 26) // max(N * M, 1)))


def _row_blocks(R: int, block: int):
    for s in range(0, R, block):
        yield s, min(s + block, R)


def _pad_block(G, Mmask, s: int, e: int, block: int):
    """Slice rows [s, e) padded up to `block` rows (shape-bucketing: every
    device call sees the same (block, N) shape, so the XLA cache hits across
    partitions and datasets — pad rows are all-missing and their garbage
    outputs are sliced off by the caller)."""
    Gb = np.zeros((block, G.shape[1]), dtype=np.float64)
    Mb = np.ones((block, G.shape[1]), dtype=bool)
    n = e - s
    Gb[:n] = G[s:e]
    Mb[:n] = Mmask[s:e]
    return jnp.asarray(Gb), jnp.asarray(Mb), n


@partial(jax.jit, static_argnames=('block',))
def _slice_cached_block(gz8, m8, s, block):
    """Device-resident block slice from the cached int8 entry pair
    (ops/devcache.py form): no h2d at all — the GLM reads the same device
    buffers the linreg path staged. Pad rows are all-missing."""
    R = gz8.shape[0]
    pad = (-R) % block
    gzp = jnp.pad(gz8, ((0, pad), (0, 0)))
    m8p = jnp.pad(m8, ((0, pad), (0, 0)), constant_values=1)
    g = jax.lax.dynamic_slice_in_dim(gzp, s, block, 0).astype(jnp.float64)
    m = jax.lax.dynamic_slice_in_dim(m8p, s, block, 0) > 0
    return g, m


def _block_source(G, Mmask, cached: bool, block: int):
    """Yield (Gb, Mb, n) blocks; `cached` means (G, Mmask) are the device
    (gz8, m8) int8 pair and slicing happens on device."""
    R = int(G.shape[0])
    for s in range(0, R, block):
        n = min(block, R - s)
        if cached:
            Gb, Mb = _slice_cached_block(G, Mmask, s, block)
            yield Gb, Mb, n
        else:
            yield _pad_block(G, Mmask, s, s + n, block)


def _stacked_fetch(parts):
    """One d2h round trip for a whole partition's results: device blocks are
    concatenated per output and flattened into a single f64 buffer."""
    cats = [jnp.concatenate(p, axis=0) if len(p) > 1 else p[0]
            for p in parts]
    flat = jnp.concatenate([c.reshape(c.shape[0], -1).astype(jnp.float64)
                            for c in cats], axis=1)
    host = np.asarray(flat)
    out, o = [], 0
    for c in cats:
        w = int(np.prod(c.shape[1:])) if c.ndim > 1 else 1
        v = host[:, o:o + w]
        out.append(v.reshape((host.shape[0],) + tuple(c.shape[1:])))
        o += w
    return out


def _score_device(G, Mmask, Covd, yd, null_fit, link: str, block_rows: int,
                  cached: bool = False):
    """Score-test driver. Distinguishes the reference's two "no number"
    shapes: NaN inputs (all-missing / NaN dosage rows) flow through the
    reference's dgesv as NaN FLOATS (`nan_input`), while a singular finite
    fisher raises there and yields None (`valid`=False, `nan_input`=False)."""
    R = int(G.shape[0])
    chis = []
    for Gb, Mb, n in _block_source(G, Mmask, cached, block_rows):
        chi2 = glm_score_batch(Gb, Mb,
                               Covd, yd, jnp.asarray(null_fit['b']),
                               jnp.asarray(null_fit['score']),
                               jnp.asarray(null_fit['fisher']), link)
        chis.append(chi2[:n])
    (chi2,) = _stacked_fetch([chis]) if chis else (np.zeros(0),)
    if cached:
        # int8 entries are always finite; only all-missing rows are NaN-input
        nan_in = np.asarray(jnp.all(Mmask > 0, axis=1))
    else:
        nan_in = (Mmask.all(axis=1)
                  | (~np.isfinite(np.where(Mmask, 0.0, G))).any(axis=1))
    return dict(chi_sq_stat=chi2, valid=np.isfinite(chi2) | nan_in,
                nan_input=nan_in)


def logistic_rows_device(G, Mmask, Cov, y, null_fit, test: str,
                         max_iterations: int, tolerance: float,
                         block_rows: int = 1024, cached: bool = False):
    """Run one logistic test over a (R, N) block; returns a dict of numpy
    per-variant arrays shaped like stats/glmfit's outputs (None-able fields
    as (value_array, valid_mask)).

    `cached=True` means (G, Mmask) are the device-resident int8 (gz8, m8)
    pair from ops/devcache.py — the same buffers linear_regression_rows
    stages — so a warm logistic call moves nothing h2d and does one stacked
    d2h fetch per partition. Blocks grow to 2048 rows there: each block is
    one device dispatch, so fewer, larger blocks dispatch less."""
    R, N = int(G.shape[0]), int(G.shape[1])
    if cached and block_rows == 1024:
        block_rows = 2048
    k = Cov.shape[1]
    Covd = jnp.asarray(Cov)
    yd = jnp.asarray(y)
    nb = jnp.asarray(null_fit['b'])
    out = {}

    if test == 'score':
        return _score_device(G, Mmask, Covd, yd, null_fit, 'logistic',
                             block_rows, cached)

    if test == 'firth':
        # fb stays at the workspace-bounded size even when cached: the
        # (R, M, N) triangular-solve workspace at 2× blew past HBM next to
        # the resident entry cache (measured OOM at compile, r5)
        fb = _firth_row_block(N, k + 1)
        parts = [[] for _ in range(8)]
        for Gb, Mb, n in _block_source(G, Mmask, cached, fb):
            Gid = _impute_mean_nan(Gb, Mb)
            b0 = jnp.broadcast_to(nb, (fb, k))
            b_n, it_n, ll_n, st_n = firth_fit_batch(
                Gid, Covd, yd, b0, k, max_iterations, tolerance)
            # full fit warm-started from the improved null (reference
            # firth_test, statgen.py:1257); non-converged nulls run too and
            # are masked by the caller
            b_f0 = jnp.concatenate([b_n, jnp.zeros((fb, 1))], axis=1)
            b_f, it_f, ll_f, st_f = firth_fit_batch(
                Gid, Covd, yd, b_f0, k + 1, max_iterations, tolerance)
            for lst, arr in zip(parts, (b_n, it_n, ll_n, st_n,
                                        b_f, it_f, ll_f, st_f)):
                lst.append(arr[:n])
        (out['null_b'], out['null_n_iter'], out['null_ll'],
         out['null_status'], out['full_b'], out['full_n_iter'],
         out['full_ll'], out['full_status']) = _stacked_fetch(parts)
        return out

    # wald / lrt: full Newton fit per variant
    n_out = 6 if test == 'wald' else 4
    parts = [[] for _ in range(n_out)]
    for Gb, Mb, n in _block_source(G, Mmask, cached, block_rows):
        b, sc, fi, it, ll, st = glm_newton_batch(
            Gb, Mb, Covd, yd,
            nb, jnp.asarray(null_fit['score']), jnp.asarray(null_fit['fisher']),
            max_iterations, tolerance, 'logistic')
        arrs = [b, it, ll, st]
        if test == 'wald':
            se, z = wald_stats_batch(b, fi)
            arrs += [se, z]
        for lst, arr in zip(parts, arrs):
            lst.append(arr[:n])
    fetched = _stacked_fetch(parts)
    out['b'], out['n_iter'], out['ll'], out['status'] = fetched[:4]
    if test == 'wald':
        out['se'], out['z'] = fetched[4], fetched[5]
    return out


def poisson_rows_device(G, Mmask, Cov, y, null_fit, test: str,
                        max_iterations: int, tolerance: float,
                        block_rows: int = 1024, cached: bool = False):
    """Poisson wald/lrt/score on device (reference
    _lowered_poisson_regression_rows, statgen.py:1747). `cached` as in
    logistic_rows_device: (G, Mmask) are the devcache int8 pair."""
    R = int(G.shape[0])
    Covd = jnp.asarray(Cov)
    yd = jnp.asarray(y)
    nb = jnp.asarray(null_fit['b'])
    out = {}
    if test == 'score':
        return _score_device(G, Mmask, Covd, yd, null_fit, 'poisson',
                             block_rows, cached)
    if cached and block_rows == 1024:
        block_rows = 2048
    n_out = 8 if test == 'wald' else 6
    parts = [[] for _ in range(n_out)]
    for Gb, Mb, n in _block_source(G, Mmask, cached, block_rows):
        b, sc, fi, it, ll, st = glm_newton_batch(
            Gb, Mb, Covd, yd,
            nb, jnp.asarray(null_fit['score']), jnp.asarray(null_fit['fisher']),
            max_iterations, tolerance, 'poisson')
        arrs = [b, sc, fi, it, ll, st]
        if test == 'wald':
            se, z = wald_stats_batch(b, fi)
            arrs += [se, z]
        for lst, arr in zip(parts, arrs):
            lst.append(arr[:n])
    fetched = _stacked_fetch(parts)
    (out['b'], out['score'], out['fisher'], out['n_iter'], out['ll'],
     out['status']) = fetched[:6]
    if test == 'wald':
        out['se'], out['z'] = fetched[6], fetched[7]
    return out
