"""Tests that need an NVIDIA GPU (marker `gpu`).

Run them on the card with `python -m pytest -m gpu tests/`; elsewhere the
`gpu_device` fixture skips them. They check what only the card can show:
that the engine runs there, that the separable Gaussian product is not
computed in TF32, and that Max/Min/Count match the oracle exactly.
"""

import copy

import numpy as np
import pytest

import pcr_tpu as pcr
from conftest import make_cloud, make_grid_config

pytestmark = pytest.mark.gpu
RT = pcr.ReductionType


def _bands(gc, specs, cloud, mode, **kw):
    cfg = pcr.PipelineConfig(grid=gc, reductions=copy.deepcopy(specs),
                             exec_mode=mode, **kw)
    p = pcr.Pipeline.create(cfg)
    p.ingest(cloud)
    p.finalize()
    return p, [p.result().band_array(i) for i in range(len(specs))]


def test_engine_runs_on_the_gpu(gpu_device):
    gc = make_grid_config(w=64.0, h=64.0)
    spec = pcr.ReductionSpec(value_channel="v", type=RT.Sum)
    p, _ = _bands(gc, [spec], make_cloud(1000, w=64.0, h=64.0),
                  pcr.ExecutionMode.GPU, gpu_require_strict=True)
    assert p._engine.device.platform == "gpu"
    assert {d.platform for st in p._engine._states for a in st
            for d in a.devices()} == {"gpu"}


def _tf32(a):
    """Round float32 to TF32 (10 explicit mantissa bits, nearest-even)."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~np.uint64(0x1FFF)
    return b.astype(np.uint32).view(np.float32)


def test_separable_gaussian_product_is_not_tf32(gpu_device, monkeypatch):
    """The separable splat's soft one-hot product is one whose TF32 error
    exceeds the 1e-5 bar; on the card it must still meet the bar against
    the oracle, so it cannot be running in TF32."""
    import jax
    import jax.numpy as jnp
    from pcr_tpu.engine import tpu_backend as tb

    rng = np.random.default_rng(0)
    wy = np.exp(-0.5 * rng.uniform(0, 3, (4096, 128)) ** 2).astype(np.float32)
    wx = (np.exp(-0.5 * rng.uniform(0, 3, (4096, 256)) ** 2)
          * rng.uniform(0, 100, (4096, 1))).astype(np.float32)
    exact = wy.T.astype(np.float64) @ wx.astype(np.float64)
    tf32 = _tf32(wy).T.astype(np.float64) @ _tf32(wx).astype(np.float64)
    rel = lambda r: float(np.abs(r - exact).max() / np.abs(exact).max())
    assert rel(tf32) > 1e-5          # TF32 would break the bar
    dot = jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32))
    got = np.asarray(dot(jax.device_put(wy, gpu_device),
                         jax.device_put(wx, gpu_device)))
    assert rel(got) < 1e-6

    # the engine's separable splat holds the bar against the oracle
    monkeypatch.setattr(tb, "gauss_form", lambda *a: "separable")
    gc = make_grid_config(w=256.0, h=256.0)
    spec = pcr.gaussian_splat_spec("v", default_sigma=4.0)
    spec.type = RT.Sum
    cloud = make_cloud(20000, w=256.0, h=256.0)
    p, got_b = _bands(gc, [spec], cloud, pcr.ExecutionMode.GPU,
                      gpu_require_strict=True)
    assert any(k[0] == "gauss_sorted" for k in p._engine._jits)
    _, want = _bands(gc, [spec], cloud, pcr.ExecutionMode.CPU)
    a, b = want[0], got_b[0]
    assert (np.isnan(a) == np.isnan(b)).all()
    m = ~np.isnan(a)
    assert float((np.abs(a[m] - b[m]) - 1e-5 * (1 + np.abs(a[m]))).max()) \
        <= 0.0


def test_max_min_count_exact(gpu_device):
    gc = make_grid_config(w=512.0, h=512.0)
    specs = [pcr.ReductionSpec(value_channel="v", type=t)
             for t in (RT.Max, RT.Min, RT.Count)]
    cloud = make_cloud(1_000_000, w=512.0, h=512.0)
    _, got = _bands(gc, specs, cloud, pcr.ExecutionMode.GPU,
                    gpu_require_strict=True)
    _, want = _bands(gc, specs, cloud, pcr.ExecutionMode.CPU)
    for g, w in zip(got, want):
        assert np.array_equal(g, w, equal_nan=True)
