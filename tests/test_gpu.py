"""Tests that need the card (marker `gpu`; the `gpu` fixture skips
elsewhere). On the card:

    HAIL_TPU_TEST_ON_CHIP=1 python -m pytest -m gpu tests/
"""

import numpy as np
import pytest


@pytest.mark.gpu
def test_s8_gemm_bit_exact_at_phase_a_shapes(gpu):
    """The exact linreg path's int8×int8→int32 product at the headline
    shapes: one 8,192-row block of 10,000 samples against 5 columns × 7
    digit planes, equal to int64 numpy bit for bit."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    G = rng.integers(0, 3, (8192, 10_000), dtype=np.int8)
    W = rng.integers(-127, 128, (10_000, 35), dtype=np.int8)
    prod = jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    got = np.asarray(prod(jax.device_put(G, gpu), jax.device_put(W, gpu)))
    assert got.dtype == np.int32
    assert np.array_equal(got, G.astype(np.int64) @ W.astype(np.int64))


@pytest.mark.gpu
def test_ibs_dot_matches_f64_oracle(gpu):
    """`_ibs_dot`'s three int8 GEMMs against f64 indicator products, with
    missing calls and a sample count that is no multiple of 16."""
    from hail_tpu.ops.ibs import ibs_counts
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (8192, 1003))        # 3 = missing
    het, hr, hv, cl = codes == 1, codes == 0, codes == 2, codes != 3
    ibs0, ibs1, ibs2 = ibs_counts(het, hr, hv, cl)
    R, H, A, C = (x.astype(np.float64) for x in (hr, het, hv, cl))
    want0 = R.T @ A + A.T @ R
    want1 = H.T @ (R + A) + (R + A).T @ H
    assert np.array_equal(ibs0, want0)
    assert np.array_equal(ibs1, want1)
    assert np.array_equal(ibs2, C.T @ C - want0 - want1)
