"""IBS counts (ops/ibs.py) against the f64 indicator-product oracle."""

import numpy as np
import pytest


def _oracle(het, hom_ref, hom_var, called):
    R, H, A, C = (x.astype(np.float64) for x in (hom_ref, het, hom_var, called))
    ibs0 = R.T @ A + A.T @ R
    ibs1 = H.T @ (R + A) + (R + A).T @ H
    return ibs0, ibs1, C.T @ C - ibs0 - ibs1


@pytest.mark.parametrize('m,n,miss', [(1, 1, 0.0), (7, 5, 0.3),
                                      (33, 130, 0.1), (257, 17, 0.0)])
def test_ibs_counts_match_oracle(m, n, miss):
    from hail_tpu.ops.ibs import ibs_counts
    rng = np.random.default_rng(m * 1000 + n)
    codes = rng.integers(0, 3, (m, n))
    codes[rng.random((m, n)) < miss] = 3                # missing call
    ind = (codes == 1, codes == 0, codes == 2, codes != 3)
    got = ibs_counts(*ind)
    for g, w in zip(got, _oracle(*ind)):
        assert g.shape == (n, n) and g.dtype == np.int32
        assert np.array_equal(g, w)


def test_ibd_propagates_kernel_errors(monkeypatch):
    """A device failure in the IBS kernel reaches the caller."""
    import hail_tpu as hl
    from hail_tpu.ops import ibs

    def broken(*args):
        raise RuntimeError('injected IBS kernel failure')

    monkeypatch.setattr(ibs, '_ibs_dot', broken)
    mt = hl.balding_nichols_model(2, 8, 16)
    with pytest.raises(RuntimeError, match='injected IBS kernel failure'):
        hl.identity_by_descent(mt)
