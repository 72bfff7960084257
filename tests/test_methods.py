import math

import numpy as np
import pytest
import scipy.stats as st

import hail_tpu as hl
from hail_tpu import types as ht


@pytest.fixture(scope='module')
def bn():
    # pin the model seed: the session's ambient seed state depends on test
    # ordering, and downstream assertions (e.g. ld_score > 0.5 needing
    # polymorphic variants) are data-dependent
    hl.reset_global_randomness()
    mt = hl.balding_nichols_model(2, 60, 80)
    mt = mt.annotate_cols(pheno=hl.rand_norm(seed=11), cov1=hl.rand_norm(seed=12))
    return mt.persist()


def test_linreg_parity(bn):
    import hail_tpu.methods.statgen as sg
    res = hl.linear_regression_rows(y=bn.pheno, x=bn.GT.n_alt_alleles(),
                                    covariates=[1.0, bn.cov1]).collect()
    G, M = sg._entry_expr_to_blocks(bn.GT.n_alt_alleles())
    cols = bn.cols().collect()
    y = np.array([r.pheno for r in cols])
    c1 = np.array([r.cov1 for r in cols])
    n = len(y)
    for vi in [0, 7, 33]:
        X = np.stack([np.ones(n), c1, G[vi]], 1)
        beta = np.linalg.lstsq(X, y, rcond=None)[0]
        rss = float(((y - X @ beta) ** 2).sum())
        dof = n - 3
        se = math.sqrt(np.linalg.inv(X.T @ X)[2, 2] * rss / dof)
        p = 2 * st.t.sf(abs(beta[2] / se), dof)
        assert abs(beta[2] - res[vi].beta) < 1e-8
        assert abs(se - res[vi].standard_error) < 1e-8
        assert abs(p - res[vi].p_value) < 1e-8


def test_linreg_multi_pheno(bn):
    res = hl.linear_regression_rows(y=[bn.pheno, bn.cov1], x=bn.GT.n_alt_alleles(),
                                    covariates=[1.0]).collect()
    assert len(res[0].beta) == 2
    assert len(res[0].p_value) == 2


def test_logreg_wald_parity(bn):
    # fit one variant manually with IRLS in numpy and compare
    import hail_tpu.methods.statgen as sg
    y01 = bn.pop == 1
    res = hl.logistic_regression_rows('wald', y=y01, x=bn.GT.n_alt_alleles(),
                                      covariates=[1.0]).collect()
    G, M = sg._entry_expr_to_blocks(bn.GT.n_alt_alleles())
    cols = bn.cols().collect()
    y = np.array([1.0 if r.pop == 1 else 0.0 for r in cols])
    # pick two variants where the manual IRLS is well-conditioned (not
    # monomorphic / quasi-separated) — the bn draws are data-dependent
    candidates = [vi for vi in range(len(G))
                  if 0.2 < np.mean(G[vi]) / 2 < 0.8][:2]
    assert len(candidates) == 2
    for vi in candidates:
        X = np.stack([np.ones(len(y)), G[vi]], 1)
        beta = np.zeros(2)
        for _ in range(50):
            mu = 1 / (1 + np.exp(-X @ beta))
            W = mu * (1 - mu)
            H = (X * W[:, None]).T @ X
            delta = np.linalg.solve(H, X.T @ (y - mu))
            beta += delta
            if np.abs(delta).max() < 1e-10:
                break
        se = math.sqrt(np.linalg.inv(H)[1, 1])
        assert abs(beta[1] - res[vi].beta) < 1e-6
        assert abs(se - res[vi].standard_error) < 1e-6


def test_logreg_lrt_score_firth(bn):
    y01 = bn.pop == 1
    x = bn.GT.n_alt_alleles()
    lrt = hl.logistic_regression_rows('lrt', y=y01, x=x, covariates=[1.0]).collect()
    sc = hl.logistic_regression_rows('score', y=y01, x=x, covariates=[1.0]).collect()
    fi = hl.logistic_regression_rows('firth', y=y01, x=x, covariates=[1.0]).collect()
    checked = 0
    for vi in range(len(lrt)):
        if checked >= 5:
            break
        if lrt[vi].chi_sq_stat is None:
            # non-converged fits surface missing stats (reference semantics)
            continue
        checked += 1
        assert lrt[vi].chi_sq_stat >= -1e-9
        assert 0 <= lrt[vi].p_value <= 1
        assert 0 <= sc[vi].p_value <= 1
        assert 0 <= fi[vi].p_value <= 1
        # score, lrt should roughly agree for moderate effects
        if lrt[vi].chi_sq_stat < 5:
            assert abs(lrt[vi].chi_sq_stat - sc[vi].chi_sq_stat) < 2.0


def test_poisson_regression(bn):
    cnt = hl.int32(bn.GT.n_alt_alleles())
    mt = bn.annotate_cols(ycnt=hl.rand_pois(2.0, seed=5))
    res = hl.poisson_regression_rows('wald', y=mt.ycnt, x=mt.GT.n_alt_alleles(),
                                     covariates=[1.0]).collect()
    assert all(0 <= r.p_value <= 1 for r in res[:5] if r.p_value is not None)


def test_pca(bn):
    ev, scores, loadings = hl.hwe_normalized_pca(bn.GT, k=3, compute_loadings=True)
    assert len(ev) == 3
    assert ev[0] >= ev[1] >= ev[2] > 0
    sc = scores.collect()
    assert len(sc) == 60
    assert len(sc[0].scores) == 3
    ld = loadings.collect()
    assert len(ld[0].loadings) == 3
    # PC1 should separate the two populations
    pops = [r.pop for r in bn.cols().collect()]
    pc1 = np.array([r.scores[0] for r in sc])
    m0 = pc1[np.array(pops) == 0].mean()
    m1 = pc1[np.array(pops) == 1].mean()
    assert abs(m0 - m1) > pc1.std() * 0.5


def test_pca_exact_parity(bn):
    import hail_tpu.methods.statgen as sg
    G, M = sg._entry_expr_to_blocks(bn.GT.n_alt_alleles())
    ev, scores, _ = hl.pca(bn.GT.n_alt_alleles(), k=2)
    u, s, vt = np.linalg.svd(G, full_matrices=False)
    assert np.allclose(sorted(ev, reverse=True), (s[:2] ** 2), rtol=1e-6)


def test_king(bn):
    k = hl.king(bn.GT)
    ents = k.entries().collect()
    # self-kinship should be ~0.5
    selfs = [e.phi for e in ents if e.sample_idx == e.sample_idx_1]
    assert all(abs(p - 0.5) < 1e-6 for p in selfs)


def test_pc_relate(bn):
    rel = hl.pc_relate(bn.GT, min_individual_maf=0.01, k=2, statistics='kin')
    rows = rel.collect()
    assert len(rows) == 60 * 59 / 2
    kins = np.array([r.kin for r in rows])
    assert np.abs(np.median(kins)) < 0.1  # unrelated samples


def test_ibd(bn):
    t = hl.identity_by_descent(bn)
    rows = t.take(5)
    for r in rows:
        assert 0 <= r.ibd.PI_HAT <= 1
        assert abs(r.ibd.Z0 + r.ibd.Z1 + r.ibd.Z2 - 1) < 1e-9


def test_grm_rrm(bn):
    grm = hl.genetic_relatedness_matrix(bn.GT)
    assert grm.shape == (60, 60)
    arr = grm.to_numpy()
    assert np.allclose(arr, arr.T)
    rrm = hl.realized_relationship_matrix(bn.GT)
    arr2 = rrm.to_numpy()
    # diagonal of RRM should average ~1
    assert abs(np.diag(arr2).mean() - 1.0) < 0.2


def test_row_correlation(bn):
    corr = hl.row_correlation(bn.GT.n_alt_alleles())
    arr = corr.to_numpy()
    assert np.allclose(np.diag(arr), 1.0, atol=1e-9)
    assert np.all(arr <= 1.0 + 1e-9)


def test_ld_prune(bn):
    kept = hl.ld_prune(bn.GT, r2=0.2)
    assert 0 < kept.count() <= 80


def test_split_multi_hts():
    mt = hl.import_vcf('/root/reference/hail/hail/test/resources/sample.vcf', n_partitions=2)
    n_bi = mt.filter_rows(hl.len(mt.alleles) == 2).count_rows()
    sp = hl.split_multi_hts(mt)
    assert sp.count_rows() >= mt.count_rows()
    rows = sp.rows().collect()
    assert all(len(r.alleles) == 2 for r in rows)
    assert all(r.a_index >= 1 for r in rows)
    ents = sp.entries().take(10)
    for e in ents:
        if e.GT is not None:
            assert all(a in (0, 1) for a in e.GT.alleles)


def test_impute_sex(bn):
    # balding nichols has no X variants; just check it runs on an X-augmented set
    mt = hl.balding_nichols_model(1, 10, 5)
    t = hl.impute_sex(mt.GT)
    assert t.count() == 0 or t.count() == 10


def test_maximal_independent_set():
    t = hl.parallelize([hl.Struct(i=1, j=2), hl.Struct(i=2, j=3)],
                       ht.tstruct(i=ht.tint32, j=ht.tint32))
    mis = hl.maximal_independent_set(t.i, t.j)
    nodes = {r.node for r in mis.collect()}
    assert 2 not in nodes
    assert nodes == {1, 3}


def test_skat(bn):
    mt = bn.annotate_rows(gene=hl.if_else(bn.locus.position < 40, 'gene1', 'gene2'),
                          weight=1.0)
    res = hl.skat(mt.gene, mt.weight, mt.pheno, mt.GT.n_alt_alleles(),
                  covariates=[1.0]).collect()
    assert len(res) == 2
    for r in res:
        assert r.p_value is None or 0 <= r.p_value <= 1.001


def test_lambda_gc(bn):
    res = hl.linear_regression_rows(y=bn.pheno, x=bn.GT.n_alt_alleles(), covariates=[1.0])
    lgc = hl.lambda_gc(res.p_value)
    assert 0.3 < lgc < 3.0


def test_balding_nichols_globals():
    mt = hl.balding_nichols_model(3, 10, 20)
    g = hl.eval(mt.globals.bn)
    assert g.n_populations == 3
    assert mt.aggregate_entries(hl.agg.count_where(hl.is_defined(mt.GT))) == 200


def test_linear_mixed_model(bn):
    model, Z = hl.linear_mixed_model(bn.pheno, [1.0], z_t=bn.GT.n_alt_alleles())
    model.fit()
    assert model.fitted
    assert 0 <= model.h_sq <= 1
    res = hl.linear_mixed_regression_rows(bn.GT.n_alt_alleles(), model)
    rows = res.collect()
    assert len(rows) == 80
    assert all(0 <= r.p_value <= 1 for r in rows if not np.isnan(r.p_value))


def test_ld_score(bn):
    t = hl.experimental.ld_score(bn.GT.n_alt_alleles(), bn.locus, radius=50)
    rows = t.collect()
    assert len(rows) == 80
    # a variant's LD score includes itself (adjusted r2 of 1 with itself)
    assert all(r.ld_score > 0.5 for r in rows)


def test_vep_gated(bn):
    with pytest.raises(ValueError, match='requires a configuration'):
        hl.vep(bn)


def test_filter_alleles_hts_docs_example():
    # reference statgen.py filter_alleles_hts documented downcode/subset
    # behavior on the 3-allele example
    mt = hl.utils.range_matrix_table(1, 1)
    mt = mt.key_rows_by(locus=hl.locus('1', 100), alleles=hl.literal(['A', 'T', 'C']))
    mt = mt.annotate_entries(GT=hl.call(1, 2), AD=hl.literal([0, 50, 35]),
                             DP=85, GQ=10,
                             PL=hl.literal([1000, 1000, 10, 1000, 0, 20]))
    e = hl.filter_alleles_hts(mt, lambda a, i: i == 1).entries().collect()[0]
    assert str(e.GT) == '0/1' and e.AD == [35, 50]
    assert e.PL == [20, 0, 10] and e.GQ == 10 and e.DP == 85
    e2 = hl.filter_alleles_hts(mt, lambda a, i: i == 2, subset=True).entries().collect()[0]
    assert str(e2.GT) == '1/1' and e2.AD == [0, 35]
    assert e2.PL == [980, 980, 0] and e2.GQ == 99
    r = hl.filter_alleles(mt, lambda a, i: i == 1).rows().collect()[0]
    assert r.old_alleles == ['A', 'T', 'C']
    assert r.new_to_old == [0, 1] and r.old_to_new == [0, 1, None]
    assert hl.filter_alleles(mt, lambda a, i: False).count_rows() == 0


def test_summarize_variants_struct():
    mt = hl.import_vcf('/root/reference/hail/hail/test/resources/mendel.vcf')
    s = hl.summarize_variants(mt, show=False)
    assert s.n_variants == mt.count_rows()
    assert s.allele_counts.get(2, 0) == mt.count_rows()
    assert 'SNP' in s.allele_types


def test_namespace_parity_with_reference():
    # every name in the reference's top-level __all__ resolves here
    import re
    src = open('/root/reference/hail/python/hail/__init__.py').read()
    names = re.findall(r"'([^']+)'", re.search(r'__all__ = \[(.*?)\]', src, re.S).group(1))
    missing = [n for n in names if not hasattr(hl, n)]
    assert missing == [], missing
    msrc = open('/root/reference/hail/python/hail/methods/__init__.py').read()
    mnames = re.findall(r"'([^']+)'", re.search(r'__all__ = \[(.*?)\]', msrc, re.S).group(1))
    mmissing = [n for n in mnames if not hasattr(hl, n)]
    assert mmissing == [], mmissing
    fsrc = open('/root/reference/hail/python/hail/expr/functions.py').read()
    fnames = set(re.findall(r'^def ([a-z][a-z0-9_]*)\(', fsrc, re.M))
    fmissing = [n for n in sorted(fnames)
                if n not in ('ndarray_broadcasting',) and not hasattr(hl, n)
                and not hasattr(hl.expr.functions, n) and not hasattr(hl.expr.functions, n + '_')]
    assert fmissing == [], fmissing


def test_experimental_extras():
    # loop (tail recursion), tidyr, time, EM, filtering AF
    assert hl.eval(hl.experimental.loop(
        lambda recur, x, acc: hl.if_else(x == 0, acc, recur(x - 1, acc + x)),
        'int32', 5, 0)) == 15
    t = hl.Table.parallelize([{'s': 'a', 'x': 1, 'y': 2}, {'s': 'b', 'x': 3, 'y': 4}],
                             hl.dtype('struct{s:str,x:int32,y:int32}'))
    long = hl.experimental.gather(t, 'key', 'val', 'x', 'y')
    assert long.count() == 4
    assert hl.experimental.spread(long, 'key', 'val').count() == 2
    assert hl.eval(hl.experimental.strftime(
        '%Y.%m.%d', 1562569201, 'America/New_York')) == '2019.07.08'
    em = hl.eval(hl.experimental.haplotype_freq_em([20, 10, 5, 10, 10, 5, 5, 5, 5]))
    assert abs(sum(em) - 150.0) < 1e-6
    faf = hl.eval(hl.experimental.filtering_allele_frequency(25, 8000, 0.95))
    assert 0 < faf < 25 / 8000


def test_explode_and_phase_trio_matrix():
    res = '/root/reference/hail/hail/test/resources/'
    ped = hl.Pedigree.read(res + 'mendel.fam')
    mt = hl.import_vcf(res + 'mendel.vcf')
    tm = hl.trio_matrix(mt, ped, complete_trios=True)
    ex = hl.experimental.explode_trio_matrix(tm)
    assert ex.count_cols() == 3 * tm.count_cols()
    assert 'GT' in ex.entry
    ph = hl.experimental.phase_trio_matrix_by_transmission(tm)
    phased = [str(e.proband_entry.get('PBT_GT')) for e in ph.entries().collect()
              if e.proband_entry and e.proband_entry.get('PBT_GT') is not None]
    assert phased and all('|' in p for p in phased)


def test_weighted_linear_regression():
    # reference test_weighted_linear_regression: weights == sqrt(w)-prescaled
    res = '/root/reference/hail/hail/test/resources/'
    cov = hl.import_table(res + 'regressionLinear.cov', key='Sample',
                          types={'Cov1': hl.tfloat64, 'Cov2': hl.tfloat64})
    ph = hl.import_table(res + 'regressionLinear.pheno', key='Sample',
                         missing='0', types={'Pheno': hl.tfloat64})
    mt = hl.import_vcf(res + 'regressionLinear.vcf')
    mt = mt.add_col_index()
    mt = mt.annotate_cols(y=hl.coalesce(ph[mt.s].Pheno, 1.0))
    mt = mt.annotate_entries(x=hl.coalesce(hl.float64(mt.GT.n_alt_alleles()), 1.0))
    covs = [1.0, cov[mt.s].Cov1, cov[mt.s].Cov2]
    b1 = hl._linear_regression_rows_nd(y=mt.y, x=mt.x, covariates=covs,
                                       weights=mt.col_idx).beta.collect()
    b2 = hl._linear_regression_rows_nd(
        y=mt.y * hl.sqrt(hl.float64(mt.col_idx)),
        x=mt.x * hl.sqrt(hl.float64(mt.col_idx)),
        covariates=[c * hl.sqrt(hl.float64(mt.col_idx)) for c in covs]).beta.collect()

    def eqn(a, b):
        if a is None or b is None:
            return a is None and b is None
        return (math.isnan(a) and math.isnan(b)) or abs(a - b) < 1e-9
    assert all(eqn(a, b) for a, b in zip(b1, b2))
    # agrees with the weighted aggregator
    hta = mt.annotate_rows(lr=hl.agg.linreg(
        mt.y, [1, mt.x, cov[mt.s].Cov1, cov[mt.s].Cov2], weight=mt.col_idx)).rows()
    b3 = [r.lr.beta[1] if r.lr is not None else None for r in hta.collect()]

    def eqn_missing_is_nan(a, b):
        if b is None:
            return a is None or math.isnan(a)
        return eqn(a, b)
    assert all(eqn_missing_is_nan(a, b) for a, b in zip(b1, b3))
    # chained groups nest outputs
    htm = hl._linear_regression_rows_nd(y=[[mt.y], [hl.abs(mt.y)]], x=mt.x,
                                        covariates=covs,
                                        weights=[mt.col_idx, mt.col_idx + 5])
    r0 = htm.collect()[0]
    assert len(r0.beta) == 2 and len(r0.beta[0]) == 1


def test_ld_prune_reference_semantics():
    res = '/root/reference/hail/hail/test/resources/'
    ds = hl.import_vcf(res + 'ldprune2.vcf')
    assert hl.ld_prune(ds.GT).count() == 1  # identical variants prune to one
    ds2 = hl.balding_nichols_model(1, 10, 10, n_partitions=3)
    pt = hl.ld_prune(ds2.GT, r2=0.0, bp_window_size=0)
    exp = ds2.filter_rows(hl.agg.collect_as_set(ds2.GT).size() > 1,
                          keep=True).count_rows()
    assert pt.count() == exp


def test_de_novo_reference_model():
    # Samocha-model posterior: verified against the closed-form formula
    rows = []
    for i, (kpl, dpl, mpl) in enumerate([
            ([90, 0, 90], [0, 60, 90], [0, 60, 90]),   # strong de novo
            ([50, 0, 50], [0, 3, 30], [0, 60, 90])]):  # ambiguous father
        for s, gt, pl, ad in [('kid', hl.Call([0, 1]), kpl, [10, 10]),
                              ('dad', hl.Call([0, 0]), dpl, [20, 0]),
                              ('mom', hl.Call([0, 0]), mpl, [20, 0])]:
            rows.append({'locus': hl.Locus('1', 100 + i), 'alleles': ['A', 'T'],
                         's': s, 'GT': gt, 'AD': ad, 'DP': sum(ad), 'GQ': 50,
                         'PL': pl})
    ht_ = hl.Table.parallelize(rows, hl.dtype(
        'struct{locus: locus<GRCh37>, alleles: array<str>, s: str, GT: call, '
        'AD: array<int32>, DP: int32, GQ: int32, PL: array<int32>}'))
    mt = ht_.to_matrix_table(['locus', 'alleles'], ['s'])
    ped = hl.Pedigree([hl.Trio('kid', fam_id='f1', pat_id='dad',
                               mat_id='mom', is_female=False)])
    r = hl.de_novo(mt, ped, pop_frequency_prior=0.001).collect()
    assert len(r) == 1  # ambiguous-father site filtered by min_p
    x = r[0]
    assert x.locus.position == 100 and x.confidence == 'HIGH'
    # closed-form: prior site freq = max((1-1)/6, 0.001, 3.3e-6) = 0.001
    import math
    dnp = 1 / 3e7
    p_het = 1 - (1 - 0.001) ** 4
    e6 = 10 ** -6.0
    norm_p = 1 / (1 + 2 * e6)      # parent pp normalization
    num = norm_p * norm_p * dnp
    den = num + 2 * (e6 * norm_p) * norm_p * p_het
    assert x.p_de_novo == pytest.approx(num / den, rel=1e-3)
    # full output schema
    assert x.proband_entry.GT is not None and x.prior == pytest.approx(0.001)
