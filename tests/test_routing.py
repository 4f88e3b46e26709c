"""Kernel routing (ops/routing.py) and the compile-cache rule
(utils/jaxcache.py): decided by platform and shapes, never by
environment selectors."""

import os

import pytest

from airs_compression_tpu.ops import routing


@pytest.mark.parametrize("platform,want", [("gpu", "triton"),
                                           ("cpu", "xla"),
                                           ("metal", "xla")])
def test_decode_path(platform, want):
    assert routing.decode_path(platform) == want


@pytest.mark.parametrize("platform,n,want", [
    ("gpu", 8192, "triton"),
    ("gpu", 8, "triton"),
    ("gpu", 1024 + 4, "xla"),     # not whole 16-byte stripes
    ("gpu", 4, "xla"),
    ("cpu", 8192, "host"),
    ("cpu", 7, "host"),
])
def test_checksum_path(platform, n, want):
    assert routing.checksum_path(platform, n) == want


@pytest.mark.parametrize("platform,want", [("gpu", "device"),
                                           ("cpu", "host")])
def test_assemble_path(platform, want):
    assert routing.assemble_path(platform) == want


def test_platform_is_jax_default_backend():
    import jax

    assert routing.platform() == jax.default_backend() == "cpu"


def test_device_decode_calls_the_routed_kernel(monkeypatch):
    """decode_blocks_device takes the routed path: with the router
    pointing at the kernel it calls the Triton entry point."""
    import jax.numpy as jnp

    from airs_compression_tpu.ops import decode, pallas_decode
    from airs_compression_tpu.ops.encode import PassConfig

    seen = []
    monkeypatch.setattr(routing, "decode_path", lambda p: "triton")
    monkeypatch.setattr(pallas_decode, "decode_blocks_triton",
                        lambda *a, **k: seen.append(a) or ("s", "e"))
    cfg = PassConfig(1, 1, 4, 67, False, 0, False, True)
    words = jnp.zeros((3, 16), jnp.uint32)
    out = decode.decode_blocks_device.__wrapped__(
        cfg, words, jnp.zeros((3, 8), jnp.int32), 8)
    assert out == ("s", "e") and len(seen) == 1


def test_cache_dir_env_wins(monkeypatch, tmp_path):
    import jax

    from airs_compression_tpu.utils import jaxcache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # not touched


def test_cache_dir_default_is_inside_checkout(monkeypatch):
    import jax

    from airs_compression_tpu.utils import jaxcache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = jaxcache.configure_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
