"""Seeded GWAS data at real width, shared by `bench.py` and `chip_smoke.py`.

`hl.balding_nichols_model` draws entries on the host one variant at a time,
which is too slow at biobank sample counts; this generator draws whole
partitions with vectorised numpy and builds the MatrixTable from packed-call
GT columns directly, the form `hl.import_vcf` produces.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class GwasData(NamedTuple):
    mt: object                   # hail_tpu MatrixTable: rows locus/alleles,
                                 # cols s/pheno/c0..c{k-1}, entries GT
    nalt: List[np.ndarray]       # per partition (rows, samples) int8 in {0,1,2}
    missing: List[np.ndarray]    # per partition (rows, samples) bool
    pheno: np.ndarray            # (samples,) f64
    covariates: np.ndarray       # (samples, k) f64, without the intercept


def gwas_matrix_table(n_samples: int, n_parts: int, rows_per_part: int,
                      n_covariates: int = 3, miss_rate: float = 0.02,
                      seed: int = 0) -> GwasData:
    """Uniform {0,1,2} genotypes with `miss_rate` missing GT, one normal
    phenotype `pheno` and `n_covariates` normal covariates `c0..`."""
    from hail_tpu import types as ht
    from hail_tpu.genetics.call import pack_diploid
    from hail_tpu.genetics.reference_genome import default_reference
    from hail_tpu.ir.columns import (Batch, LocusColumn, ObjectColumn,
                                     PrimitiveColumn)
    from hail_tpu.matrixtable import MatrixBatch, MatrixStage, MatrixTable

    rng = np.random.default_rng(seed)
    rg = default_reference()
    R = rows_per_part
    nalts, misses, mbs = [], [], []
    for p in range(n_parts):
        nalt = rng.integers(0, 3, (R, n_samples), dtype=np.int8)
        miss = rng.random((R, n_samples), dtype=np.float32) < miss_rate
        gt = pack_diploid(nalt == 2, nalt >= 1)
        pos = np.arange(p * R, (p + 1) * R, dtype=np.int32) + 10_000
        alleles = np.empty(R, dtype=object)
        alleles[:] = [['A', 'T']] * R
        rows = Batch({
            'locus': LocusColumn(ht.tlocus(rg), np.zeros(R, np.int32), pos),
            'alleles': ObjectColumn(ht.tarray(ht.tstr), alleles),
        }, R)
        mbs.append(MatrixBatch(rows, {'GT': PrimitiveColumn(ht.tcall, gt, miss)}))
        nalts.append(nalt)
        misses.append(miss)
    pheno = rng.normal(size=n_samples)
    covs = rng.normal(size=(n_samples, n_covariates))
    col_fields = {
        's': ObjectColumn(ht.tstr, np.asarray(
            [f's{i}' for i in range(n_samples)], object)),
        'pheno': PrimitiveColumn(ht.tfloat64, pheno),
    }
    col_t = {'s': ht.tstr, 'pheno': ht.tfloat64}
    for ci in range(n_covariates):
        col_fields[f'c{ci}'] = PrimitiveColumn(ht.tfloat64, covs[:, ci].copy())
        col_t[f'c{ci}'] = ht.tfloat64
    row_t = ht.tstruct(locus=ht.tlocus(rg), alleles=ht.tarray(ht.tstr))
    mt = MatrixTable(MatrixStage.from_batches(
        Batch({}, 1), Batch(col_fields, n_samples), ['locus', 'alleles'],
        ['s'], row_t, ht.tstruct(**col_t), ht.tstruct(GT=ht.tcall), mbs))
    return GwasData(mt, nalts, misses, pheno, covs)
