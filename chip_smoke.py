"""Drive hail_tpu's main path on an NVIDIA GPU and check every result.

    python chip_smoke.py           # one card: phases A, B and C
    python chip_smoke.py --four    # four cards: the multi-device paths only

Phase A, the headline: `hl.linear_regression_rows` at 10,000 samples ×
65,536 variants (8 partitions of 8,192 rows, 2% missing GT, one phenotype,
intercept + 3 covariates), cold and warm, against a host f64 numpy OLS
oracle. Phase B, breadth: QC, logistic regression, PCA, GRM, IBD, LD prune,
order_by, entry aggregation and a write/read round trip on
`hl.balding_nichols_model(3, 1000, 8192)`, each against its own reference.
Phase C: the `gpu`-marked tests, run by pytest inside this process so that
one process holds the card.

The script exits non-zero, and prints no result, when JAX finds no GPU or
any phase fails. Every timing is printed beside the card's name and power
limit. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

CARD = 'no card'          # nvidia-smi name and power limit, set by main()
REL_TOL = 1e-8            # BASELINE parity bar on beta, se and p-value


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, seconds: float) -> None:
    log(f'  {label}: {seconds:.3f} s [{CARD}]')


def max_rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.array_equal(np.isnan(got), np.isnan(ref)), 'NaN pattern differs'
    ok = ~np.isnan(ref)
    return float(np.max(np.abs(got[ok] - ref[ok]) / np.abs(ref[ok]),
                        initial=0.0))


# ---------------------------------------------------------------------------
# Phase A: linear_regression_rows at real width
# ---------------------------------------------------------------------------

def ols_oracle(nalt, missing, pheno, covariates):
    """Host f64 OLS per variant, mean-imputed x, covariates projected out:
    (beta, standard_error, p_value), each (rows,)."""
    import scipy.stats
    n = pheno.shape[0]
    X = np.concatenate([np.ones((n, 1)), covariates], axis=1)
    Q, _ = np.linalg.qr(X)
    y = pheno - Q @ (Q.T @ pheno)
    dof = n - X.shape[1] - 1
    G = nalt.astype(np.float64)
    G[missing] = 0.0
    cnt = n - missing.sum(axis=1)
    mean = G.sum(axis=1) / cnt
    G = np.where(missing, mean[:, None], G)
    G -= (G @ Q) @ Q.T                                  # residualize x
    xx = np.einsum('ij,ij->i', G, G)
    beta = (G @ y) / xx
    se = np.sqrt(((y @ y) / xx - beta * beta) / dof)
    p = 2 * scipy.stats.t.sf(np.abs(beta / se), dof)
    return beta, se, p


def gemm_kernels(hlo_text: str):
    """What XLA turned the GEMMs of a compiled module into: custom-call
    targets (cuBLAS/cuBLASLt) and fusion backends (Triton GEMM), plus the
    instructions that hold a dot."""
    names = set(re.findall(r'custom_call_target="([^"]+)"', hlo_text))
    names |= set(re.findall(r'"kind":"(__[a-z_$]+)"', hlo_text))
    dots = [ln.strip()[:200] for ln in hlo_text.splitlines()
            if ' dot(' in ln or 'custom_call_target' in ln]
    return sorted(names), dots


def check_s8_gemm(gz8, m8, Wdig):
    """The s8×s8→s32 product of the exact path, bit for bit against int64
    numpy at these shapes."""
    import jax
    import jax.numpy as jnp
    dn = (((1,), (0,)), ((), ()))
    prod = jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, dn, preferred_element_type=jnp.int32))
    W64 = np.asarray(Wdig).astype(np.int64)
    for name, a in (('gz8', gz8), ('m8', m8)):
        got = np.asarray(prod(a, Wdig))
        want = np.asarray(a).astype(np.int64) @ W64
        assert np.array_equal(got, want), f's8 GEMM of {name} is not exact'
    log(f'  s8xs8->s32 GEMM {tuple(gz8.shape)} x {tuple(Wdig.shape)}: '
        'bit-exact against int64 numpy')


def phase_a(n_samples=10_000, n_parts=8, rows_per_part=8192, seed=0):
    import jax.numpy as jnp
    import hail_tpu as hl
    from benchmarks.gwas_data import gwas_matrix_table
    from hail_tpu.ops import devcache
    from hail_tpu.ops.linreg_i8 import (_digit_planes, linreg_block_gz_exact_packed,
                                        pack_gt_2bit, unpack_gt_2bit)
    from hail_tpu.genetics.call import pack_diploid

    t0 = time.perf_counter()
    data = gwas_matrix_table(n_samples, n_parts, rows_per_part, 3,
                             miss_rate=0.02, seed=seed)
    timed(f'generate {n_samples} x {n_parts * rows_per_part} entries',
          time.perf_counter() - t0)
    mt = data.mt

    # precondition: the exact path's s8 GEMM at these shapes
    X = np.concatenate([np.ones((n_samples, 1)), data.covariates], axis=1)
    Q, _ = np.linalg.qr(X)
    Wdig, scales = _digit_planes(np.concatenate([Q, data.pheno[:, None]], 1))
    gt0 = pack_diploid(data.nalt[0] == 2, data.nalt[0] >= 1)
    gz8, m8 = unpack_gt_2bit(jnp.asarray(pack_gt_2bit(gt0, data.missing[0])),
                             n_samples)
    Wd = jnp.asarray(Wdig)
    check_s8_gemm(gz8, m8, Wd)
    k = Q.shape[1]
    lowered = linreg_block_gz_exact_packed.lower(
        gz8, m8, Wd, jnp.asarray(scales), jnp.zeros((k, 1)), jnp.zeros(1),
        jnp.asarray(1.0), k)
    names, dots = gemm_kernels(lowered.compile().as_text())
    log(f'  exact-path GEMM kernels (optimized HLO): {names}')
    for d in dots[:6]:
        log(f'    {d}')
    del gz8, m8

    covs = [1.0, mt.c0, mt.c1, mt.c2]

    def call():
        res = hl.linear_regression_rows(y=mt.pheno, x=mt.GT.n_alt_alleles(),
                                        covariates=covs)
        rows = res.select('beta', 'standard_error', 'p_value').collect()
        return {f: np.asarray([r[f] for r in rows], np.float64)
                for f in ('beta', 'standard_error', 'p_value')}

    devcache.clear()
    t0 = time.perf_counter()
    cold = call()
    timed('linear_regression_rows cold (incl. compile and h2d)',
          time.perf_counter() - t0)
    t0 = time.perf_counter()
    warm = call()
    timed('linear_regression_rows warm', time.perf_counter() - t0)
    log(f'  device cache: {devcache.stats()}')

    t0 = time.perf_counter()
    ref = [np.concatenate(v) for v in zip(*(
        ols_oracle(data.nalt[i], data.missing[i], data.pheno, data.covariates)
        for i in range(n_parts)))]
    timed('host f64 numpy oracle', time.perf_counter() - t0)
    worst = {}
    for run, got in (('cold', cold), ('warm', warm)):
        for f, r in zip(('beta', 'standard_error', 'p_value'), ref):
            assert got[f].shape == (n_parts * rows_per_part,)
            assert np.isfinite(got[f]).all(), f'{run} {f} not finite'
            worst[f] = max(worst.get(f, 0.0), max_rel_err(got[f], r))
    log(f'  max relative error vs f64 oracle: {worst} (limit {REL_TOL})')
    for f, r in zip(('beta', 'standard_error', 'p_value'), ref):
        err = np.abs(warm[f] - r)
        i = int(np.argmax(err / np.abs(r)))
        log(f'    {f}: max abs error {err.max():.3e}; the worst relative '
            f'error sits at |{f}| = {abs(r[i]):.3e}')
    bad = {f: e for f, e in worst.items() if not e <= REL_TOL}
    assert not bad, f'exceeds {REL_TOL}: {bad}'
    assert np.array_equal(cold['beta'], warm['beta']), 'cold != warm'
    return worst


# ---------------------------------------------------------------------------
# Phase B: breadth on a Balding-Nichols cohort
# ---------------------------------------------------------------------------

class PhaseB:
    """One check per method, each against its own reference. `G` is the
    host (variants × samples) n_alt_alleles matrix of the cohort."""

    CHECKS = ('variant_qc', 'sample_qc', 'logistic_wald', 'hwe_normalized_pca',
              'genetic_relatedness_matrix', 'identity_by_descent', 'ld_prune',
              'order_by', 'aggregate_entries', 'write_read')

    def __init__(self, n_samples=1000, n_variants=8192, n_wald=512):
        import hail_tpu as hl
        from hail_tpu.expr.functions import to_expr
        from hail_tpu.methods.statgen import _entry_expr_to_blocks
        self.hl = hl
        mt = hl.balding_nichols_model(3, n_samples, n_variants)
        mt = mt.annotate_cols(y=hl.rand_bool(0.4), c1=hl.rand_norm())
        self.mt = mt.persist()
        G, M = _entry_expr_to_blocks(to_expr(self.mt.GT).n_alt_alleles())
        assert not np.asarray(M).any()
        self.G = np.asarray(G, np.float64)
        cols = self.mt.cols().collect()
        self.y = np.asarray([c.y for c in cols], np.float64)
        self.c1 = np.asarray([c.c1 for c in cols], np.float64)
        self.n_wald = n_wald

    def normalized(self):
        """HWE-normalized Z over polymorphic variants, and their count."""
        p = self.G.mean(axis=1) / 2
        ok = (p > 0) & (p < 1)
        Z = (self.G[ok] - 2 * p[ok, None]) / np.sqrt(2 * p[ok] * (1 - p[ok]))[:, None]
        return Z, int(ok.sum())

    def variant_qc(self):
        # integer counts: exact
        hl, G = self.hl, self.G
        rows = hl.variant_qc(self.mt).rows().collect()
        n = G.shape[1]
        ac = np.asarray([r.variant_qc.AC[1] for r in rows])
        n_het = np.asarray([r.variant_qc.n_het for r in rows])
        an = np.asarray([r.variant_qc.AN for r in rows])
        af = np.asarray([r.variant_qc.AF[1] for r in rows])
        assert np.array_equal(ac, G.sum(axis=1).astype(np.int64))
        assert np.array_equal(n_het, (G == 1).sum(axis=1))
        assert np.array_equal(an, np.full(G.shape[0], 2 * n))
        assert np.array_equal(af, G.sum(axis=1) / (2 * n))

    def sample_qc(self):
        # integer counts: exact
        hl, G = self.hl, self.G
        cols = hl.sample_qc(self.mt).cols().collect()
        for f, want in (('n_hom_ref', (G == 0).sum(axis=0)),
                        ('n_het', (G == 1).sum(axis=0)),
                        ('n_hom_var', (G == 2).sum(axis=0)),
                        ('n_called', np.full(G.shape[1], G.shape[0]))):
            got = np.asarray([getattr(c.sample_qc, f) for c in cols])
            assert np.array_equal(got, want), f
        assert all(c.sample_qc.call_rate == 1.0 for c in cols)

    def logistic_wald(self):
        # device Newton (Cholesky solves) against the host-faithful port
        # (stats/glmfit.py, LAPACK LU): both stop at |Δb| < 1e-8, so they
        # agree to well inside that; 1e-6 relative leaves room for the
        # last Newton step the two may take on either side of the bar.
        hl = self.hl
        from hail_tpu.stats import glmfit
        mt = self.mt
        res = hl.logistic_regression_rows('wald', y=mt.y, x=mt.GT.n_alt_alleles(),
                                          covariates=[1.0, mt.c1])
        rows = res.select('beta', 'standard_error', 'p_value').collect()
        cov = np.stack([np.ones_like(self.y), self.c1], axis=1)
        null = glmfit.logreg_fit(cov, self.y, None, 25, 1e-8)
        idx = np.linspace(0, self.G.shape[0] - 1, self.n_wald).astype(int)
        worst = 0.0
        for i in idx:
            X = np.concatenate([cov, self.G[i][:, None]], axis=1)
            want = glmfit.wald_test(X, glmfit.logreg_fit(X, self.y, null, 25, 1e-8))
            for f in ('beta', 'standard_error', 'p_value'):
                got = rows[i][f]
                if want[f] is None:
                    assert got is None, (i, f, got)
                    continue
                worst = max(worst, abs(got - want[f]) / abs(want[f]))
        log(f'  logistic wald: max relative error {worst:.3e} over {len(idx)} '
            'variants (limit 1e-6)')
        assert worst <= 1e-6

    def hwe_normalized_pca(self):
        # both f64 (host SVD under the method, LAPACK eigh here)
        ev, _, _ = self.hl.hwe_normalized_pca(self.mt.GT, k=10)
        Z, m = self.normalized()
        want = np.linalg.eigh(Z.T @ Z / m)[0][::-1][:10]
        err = max_rel_err(np.asarray(ev), want)
        log(f'  pca eigenvalues: max relative error {err:.3e} (limit 1e-9)')
        assert err <= 1e-9

    def genetic_relatedness_matrix(self):
        # f64 throughout, sums in another order: 1e-10 absolute on entries O(1)
        K = self.hl.genetic_relatedness_matrix(self.mt.GT).to_numpy()
        Z, m = self.normalized()
        err = float(np.max(np.abs(K - Z.T @ Z / m)))
        log(f'  GRM: max abs error {err:.3e} (limit 1e-10)')
        assert err <= 1e-10

    def identity_by_descent(self):
        # IBS counts are integers from an exact int8 GEMM: exact equality
        # with the f64 indicator products (exact below 2^53)
        G = self.G
        t = self.hl.identity_by_descent(self.mt)
        rows = t.select('ibs0', 'ibs1', 'ibs2').collect()
        p = G.sum(axis=1) / (2 * G.shape[1])
        keep = (p > 0) & (p < 1)
        R, H, A = ((G[keep] == v).astype(np.float64) for v in (0, 1, 2))
        ibs0 = R.T @ A + A.T @ R
        ibs1 = H.T @ (R + A) + (R + A).T @ H
        ibs2 = float(keep.sum()) - ibs0 - ibs1
        iu = np.triu_indices(G.shape[1], 1)
        for f, want in (('ibs0', ibs0), ('ibs1', ibs1), ('ibs2', ibs2)):
            got = np.asarray([r[f] for r in rows], np.float64)
            assert np.array_equal(got, want[iu]), f

    def ld_prune(self, r2=0.05, window=1000):
        # no independent pruner to compare with: assert the invariants —
        # something survives, and no two kept variants within the window
        # have r² above the threshold
        hl = self.hl
        kept = hl.ld_prune(self.mt.GT, r2=r2, bp_window_size=window).collect()
        pos_all = np.asarray([r.locus.position for r in self.mt.rows().collect()])
        pos = np.asarray([r.locus.position for r in kept])
        assert 0 < len(pos) <= self.G.shape[0], len(pos)
        idx = np.searchsorted(pos_all, pos)
        Gk = self.G[idx]
        Zk = Gk - Gk.mean(axis=1, keepdims=True)
        norm = np.sqrt((Zk * Zk).sum(axis=1))
        Zk = Zk / np.where(norm > 0, norm, 1)[:, None]
        C2 = (Zk @ Zk.T) ** 2
        near = np.abs(pos[:, None] - pos[None, :]) <= window
        np.fill_diagonal(near, False)
        log(f'  ld_prune kept {len(pos)} of {self.G.shape[0]}; '
            f'max r² among kept pairs in window {C2[near].max(initial=0):.4f}')
        assert (C2[near] <= r2 + 1e-9).all()

    def order_by(self):
        # a stable sort on a tied float key: the exact permutation
        hl = self.hl
        t = hl.variant_qc(self.mt).rows()
        t = t.select(af=t.variant_qc.AF[1], pos=t.locus.position)
        got = np.asarray([r.pos for r in t.order_by(t.af).collect()])
        af = self.G.sum(axis=1) / (2 * self.G.shape[1])
        pos_all = np.asarray([r.locus.position for r in self.mt.rows().collect()])
        assert np.array_equal(got, pos_all[np.argsort(af, kind='stable')]), \
            'order differs from a stable argsort'

    def aggregate_entries(self):
        # device entry-agg tier against the host tier and numpy: integers
        hl, mt = self.hl, self.mt
        expr = hl.agg.sum(mt.GT.n_alt_alleles() * 2 + 1)
        dev = mt.aggregate_entries(expr)
        os.environ['HAIL_TPU_NO_DEVICE_AGG'] = '1'
        try:
            host = mt.aggregate_entries(expr)
        finally:
            del os.environ['HAIL_TPU_NO_DEVICE_AGG']
        assert dev == host == int((self.G * 2 + 1).sum()), (dev, host)

    def write_read(self):
        # the round trip returns the same entries, bit for bit
        hl = self.hl
        from hail_tpu.expr.functions import to_expr
        from hail_tpu.methods.statgen import _entry_expr_to_blocks
        with tempfile.TemporaryDirectory() as d:
            self.mt.write(os.path.join(d, 'bn.mt'))
            back = hl.read_matrix_table(os.path.join(d, 'bn.mt'))
            assert back.count() == self.mt.count()
            G, _ = _entry_expr_to_blocks(to_expr(back.GT).n_alt_alleles())
            assert np.array_equal(np.asarray(G, np.float64), self.G)


# ---------------------------------------------------------------------------
# Phase C: gpu-marked tests
# ---------------------------------------------------------------------------

def phase_c():
    import pytest

    class Count:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == 'call' and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1

    os.environ['HAIL_TPU_TEST_ON_CHIP'] = '1'
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(['-q', '-m', 'gpu', '-p', 'no:cacheprovider',
                      os.path.join(here, 'tests', 'test_gpu.py')],
                     plugins=[Count()])
    log(f'  gpu tests: {Count.passed} passed, {Count.failed} failed (rc={rc})')
    assert rc == 0 and Count.failed == 0 and Count.passed >= 2


# ---------------------------------------------------------------------------
# --four: the multi-device paths
# ---------------------------------------------------------------------------

def four_blockmatrix_matmul(n=8192):
    """f64 BlockMatrix matmul sharded over the 2×2 mesh against one device."""
    import jax
    import jax.numpy as jnp
    from hail_tpu.linalg import BlockMatrix
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(n, n)), rng.normal(size=(n, n))
    A, B = BlockMatrix.from_numpy(a), BlockMatrix.from_numpy(b)
    t0 = time.perf_counter()
    got = (A @ B).to_numpy()
    timed(f'BlockMatrix f64 matmul {n}^2 on the mesh (incl. compile)',
          time.perf_counter() - t0)
    d0 = jax.devices()[0]
    want = np.asarray(jax.jit(jnp.matmul)(jax.device_put(a, d0),
                                          jax.device_put(b, d0)))
    err = float(np.max(np.abs(got - want)))
    log(f'  sharded vs one device: max abs diff {err:.3e} (limit 1e-9; '
        f'entries ~{np.sqrt(n):.0f})')
    assert err <= 1e-9


def four_grm(n_samples=4096, n_variants=8192):
    import hail_tpu as hl
    from benchmarks.gwas_data import gwas_matrix_table
    data = gwas_matrix_table(n_samples, 1, n_variants, 0, miss_rate=0.0, seed=3)
    t0 = time.perf_counter()
    K = hl.genetic_relatedness_matrix(data.mt.GT).to_numpy()
    timed(f'genetic_relatedness_matrix {n_samples} samples (incl. compile)',
          time.perf_counter() - t0)
    G = data.nalt[0].astype(np.float64)
    p = G.mean(axis=1) / 2
    ok = (p > 0) & (p < 1)
    Z = (G[ok] - 2 * p[ok, None]) / np.sqrt(2 * p[ok] * (1 - p[ok]))[:, None]
    err = float(np.max(np.abs(K - Z.T @ Z / ok.sum())))
    log(f'  GRM vs numpy f64: max abs error {err:.3e} (limit 1e-10)')
    assert err <= 1e-10


def four_order_by(n=4_000_000):
    """Table.order_by on a numeric key: the all_to_all range sort."""
    import hail_tpu as hl
    from hail_tpu.ops import device_sort
    t = hl.utils.range_table(n, n_partitions=8)
    t = t.annotate(k=hl.rand_unif(0, 1))
    keys = np.asarray(t.k.collect())
    ran = []
    range_sort = device_sort.device_range_sort

    def spy(*args, **kwargs):
        order = range_sort(*args, **kwargs)
        ran.append(order is not None)
        return order

    device_sort.device_range_sort = spy
    try:
        t0 = time.perf_counter()
        got = np.asarray(t.order_by(t.k).idx.collect())
        timed(f'order_by over {n} rows', time.perf_counter() - t0)
    finally:
        device_sort.device_range_sort = range_sort
    assert ran == [True], f'the device range sort did not run: {ran}'
    assert np.array_equal(got, np.argsort(keys, kind='stable'))


def four_dryrun():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(4)


# ---------------------------------------------------------------------------

def run_phases(phases) -> list:
    failed = []
    for name, fn in phases:
        log(f'== {name}')
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:                   # noqa: BLE001 — reported, then exit 1
            traceback.print_exc()
            failed.append(name)
            log(f'FAIL {name}')
        else:
            log(f'PASS {name} {time.perf_counter() - t0:.3f} s [{CARD}]')
    return failed


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the multi-device paths, on four cards')
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != 'gpu':
        print(f'chip_smoke: JAX finds no GPU (backend {jax.default_backend()!r})',
              file=sys.stderr)
        return 2
    devs = jax.devices()
    want = 4 if args.four else 1
    if len(devs) < want:
        print(f'chip_smoke: needs {want} GPUs, JAX finds {len(devs)}',
              file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    lines = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    log('nvidia-smi --query-gpu=name,power.limit:')
    for ln in lines:
        log(ln)
    CARD = lines[0] if lines else 'nvidia-smi gave no card'

    import hail_tpu as hl
    from hail_tpu.context import _compile_cache_dir
    hl.init(global_seed=7, quiet=True)
    cache = os.environ.get('JAX_COMPILATION_CACHE_DIR') or _compile_cache_dir()
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f'compile cache {cache}: {n_cached} entries at start')

    if args.four:
        phases = [('four.blockmatrix_matmul', four_blockmatrix_matmul),
                  ('four.genetic_relatedness_matrix', four_grm),
                  ('four.order_by', four_order_by),
                  ('four.dryrun_multichip', four_dryrun)]
    else:
        state = {}

        def phase_b_setup():
            state['b'] = PhaseB()

        phases = [('A.linear_regression_rows', phase_a),
                  ('B.setup balding_nichols_model(3, 1000, 8192)', phase_b_setup)]
        phases += [(f'B.{c}', (lambda c=c: getattr(state['b'], c)()))
                   for c in PhaseB.CHECKS]
        phases.append(('C.gpu tests', phase_c))
    failed = run_phases(phases)
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    log(f'compile cache {cache}: {n_cached} entries at end')
    if failed:
        log(f'FAILED: {", ".join(failed)}')
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': devs[0].platform, 'kind': devs[0].device_kind,
        'count': len(devs)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
