"""Engine choices that the code makes from what it observes: the
compilation-cache directory and the Gaussian form per cloud."""

import os

import pytest

from pcr_tpu.engine import tpu_backend as tb


@pytest.fixture
def fresh_cache(monkeypatch):
    import jax
    monkeypatch.setattr(tb, "_CACHE_READY", False)
    before = jax.config.jax_compilation_cache_dir
    yield jax
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_env_is_left_to_jax(fresh_cache, monkeypatch,
                                           tmp_path):
    jax = fresh_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    assert tb.compilation_cache_dir() is None
    tb.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == "sentinel"


def test_cache_dir_defaults_inside_checkout(fresh_cache, monkeypatch):
    jax = fresh_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert tb.compilation_cache_dir() == want
    tb.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


CACHED = 8 << 20           # a 1000 x 1000 two-field state
UNCACHED = 512 << 20       # an 8000 x 8000 two-field state


@pytest.mark.parametrize("rotated,r,sigma,width,state,want", [
    (False, 3, 1.0, 1000, CACHED, "window"),      # product cutoff bites
    (True, 12, 4.0, 1000, CACHED, "window"),       # no row/column factors
    (False, [3, 12], [1.0, 4.0], 1000, CACHED, "window"),  # one bites
    (False, 6, 2.0, 1000, CACHED, "window"),       # small footprint
    (False, 12, 4.0, 1000, CACHED, "separable"),
    (False, 48, 16.0, 1000, CACHED, "separable"),  # large footprint
    (False, 9, 3.0, 8000, UNCACHED, "window"),     # wide grid: rows cost W
    (False, 24, 8.0, 8000, UNCACHED, "separable"),  # atomics miss the cache
    (False, 24, 8.0, 8000, CACHED, "window"),
    (False, [], [], 1000, CACHED, "window"),       # no valid points: r = 0
], ids=["small_sigma", "rotated", "per_point", "sigma2", "sigma4",
        "large_sigma", "wide_grid", "wide_uncached", "wide_cached",
        "empty"])
def test_gauss_form(rotated, r, sigma, width, state, want):
    assert tb.gauss_form(rotated, r, sigma, sigma, width, state) == want
