"""slam2d_tpu.device: the compile-cache location, describe() and the GPU
guard, on the CPU backend."""

import jax
import pytest

from slam2d_tpu import device


def test_cache_dir_unset_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    checkout = device.os.path.dirname(
        device.os.path.dirname(device.os.path.abspath(device.__file__))
    )
    first = device.compile_cache_dir()
    assert first == device.os.path.join(checkout, ".jax_cache")
    assert device.compile_cache_dir() == first      # same path every call


def test_cache_dir_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(device.CACHE_ENV, str(tmp_path / "cc"))
    prev = jax.config.jax_compilation_cache_dir
    assert device.setup_compile_cache() == str(tmp_path / "cc")
    # the code sets no directory of its own when the variable is set
    assert jax.config.jax_compilation_cache_dir == prev


def test_setup_compile_cache_unset_points_jax_at_checkout(monkeypatch):
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        path = device.setup_compile_cache()
        assert path == device.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == path
        assert device.os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_require_gpu_raises_on_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="cpu"):
        device.require_gpu()


def test_describe_cpu():
    info = device.describe()
    assert info["platform"] == "cpu"
    assert info["count"] == len(jax.devices())
    assert "cards" not in info
