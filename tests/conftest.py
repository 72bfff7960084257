"""Test harness: force the CPU backend with 8 virtual devices.

Mirrors the reference's Spark local[2] test harness
(`hail/python/test/hail/helpers.py:17-42`): tests exercise real partitioning
and mesh sharding without an accelerator. On a machine with a GPU,
HAIL_TPU_TEST_ON_CHIP=1 leaves JAX on its default backend so that the
`gpu`-marked tests (the `gpu` fixture) run on the card:

    HAIL_TPU_TEST_ON_CHIP=1 python -m pytest -m gpu tests/
"""

import os

ON_CHIP = os.environ.get('HAIL_TPU_TEST_ON_CHIP') == '1'
if not ON_CHIP:
    os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                               + ' --xla_force_host_platform_device_count=8')

import jax

if not ON_CHIP:
    jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips where JAX has none (CPU test runs)."""
    if jax.default_backend() != 'gpu':
        pytest.skip('needs an NVIDIA GPU: run HAIL_TPU_TEST_ON_CHIP=1 '
                    'python -m pytest -m gpu tests/ on the card')
    return jax.devices()[0]


@pytest.fixture(scope='session', autouse=True)
def hl_session():
    import hail_tpu as hl
    hl.init(global_seed=0)
    yield
    hl.stop()


@pytest.fixture
def hl():
    import hail_tpu as hl
    return hl


SAMPLE_VCF = '/root/reference/hail/hail/test/resources/sample.vcf'


@pytest.fixture(scope='session')
def sample_mt():
    import hail_tpu as hl
    if not os.path.exists(SAMPLE_VCF):
        pytest.skip('reference sample.vcf fixture not available')
    return hl.import_vcf(SAMPLE_VCF, n_partitions=3).persist()
