"""Where `hl.init` puts JAX's persistent compilation cache."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_in_checkout_when_env_unset(monkeypatch):
    import jax
    from hail_tpu import context
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    want = os.path.join(REPO, '.jax_cache')
    assert context._compile_cache_dir() == want
    before = jax.config.jax_compilation_cache_dir
    try:
        context._setup_compile_cache()
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update('jax_compilation_cache_dir', before)


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    import jax
    from hail_tpu import context
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    assert context._compile_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    context._setup_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_env_dir_receives_the_cache(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there."""
    code = (
        "import jax, jax.numpy as jnp, hail_tpu as hl\n"
        "hl.init(quiet=True)\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "print(float(jax.jit(lambda x: jnp.sin(x) * 3.0)(1.0)))\n")
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / 'cc'))
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.listdir(tmp_path / 'cc')
