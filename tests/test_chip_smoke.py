"""chip_smoke.py: refuses to run without a GPU, and its reference
comparisons hold at tiny size on the CPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert 'no GPU' in r.stderr


def test_phase_a_tiny():
    worst = chip_smoke.phase_a(n_samples=60, n_parts=2, rows_per_part=24)
    assert set(worst) == {'beta', 'standard_error', 'p_value'}


@pytest.fixture(scope='module')
def phase_b():
    return chip_smoke.PhaseB(n_samples=40, n_variants=96, n_wald=12)


@pytest.mark.parametrize('check', chip_smoke.PhaseB.CHECKS)
def test_phase_b_tiny(phase_b, check):
    getattr(phase_b, check)()
