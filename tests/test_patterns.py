"""Pattern tests — generators with analytically known rasters, run through
both backends (the rebuild of the reference's visual pattern validation,
scripts/patterns/generate_glyph_patterns.py + test_generators.py)."""

import numpy as np
import pytest

import pcr_tpu as pcr
from pcr_tpu.testing import generators as gen

RT = pcr.ReductionType
MODES = [pcr.ExecutionMode.CPU, pcr.ExecutionMode.GPU]


def run(gc, cloud, rtype, mode, channel="value"):
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [pcr.ReductionSpec(value_channel=channel, type=rtype)]
    cfg.exec_mode = mode
    p = pcr.Pipeline.create(cfg)
    p.ingest(cloud)
    p.finalize()
    return p.result().band_array(0)


@pytest.mark.parametrize("mode", MODES)
class TestExactPatterns:
    def test_uniform_grid(self, mode):
        gc = gen.make_grid_config(40, 30)
        cloud, exp = gen.generate_uniform_grid(gc, points_per_cell=3,
                                               value=2.5)
        for rtype, key in [(RT.Sum, "sum"), (RT.Average, "average"),
                           (RT.Count, "count"), (RT.Max, "max"),
                           (RT.Min, "min")]:
            band = run(gc, cloud, rtype, mode)
            np.testing.assert_allclose(band, exp[key], atol=1e-5)

    def test_checkerboard(self, mode):
        gc = gen.make_grid_config(64, 64)
        cloud, exp = gen.generate_checkerboard(gc, square=8, lo=1.0, hi=9.0)
        band = run(gc, cloud, RT.Average, mode)
        np.testing.assert_allclose(band, exp, atol=1e-5)

    def test_stripes(self, mode):
        gc = gen.make_grid_config(50, 50)
        cloud, exp = gen.generate_stripes(gc, period=5)
        band = run(gc, cloud, RT.Average, mode)
        np.testing.assert_allclose(band, exp, atol=1e-6)

    def test_gradient(self, mode):
        gc = gen.make_grid_config(80, 20)
        cloud, exp = gen.generate_gradient(gc, "x")
        band = run(gc, cloud, RT.Max, mode)
        np.testing.assert_allclose(band, exp, atol=1e-6)

    def test_bullseye(self, mode):
        gc = gen.make_grid_config(60, 60)
        cloud, exp = gen.generate_bullseye(gc)
        band = run(gc, cloud, RT.Average, mode)
        np.testing.assert_allclose(band, exp, atol=1e-6)

    def test_planar_surface(self, mode):
        gc = gen.make_grid_config(30, 30)
        cloud, exp_avg = gen.generate_planar_surface(gc)
        band = run(gc, cloud, RT.Average, mode)
        np.testing.assert_allclose(band, exp_avg, atol=1e-4)

    def test_edge_cases(self, mode):
        gc = gen.make_grid_config(10, 10)
        cloud, exp = gen.generate_edge_cases(gc)
        band = run(gc, cloud, RT.Count, mode)
        m = np.isfinite(exp)
        np.testing.assert_allclose(band[m], exp[m], atol=0)
        assert np.count_nonzero(np.isfinite(band)) >= m.sum()

    def test_text(self, mode):
        gc = gen.make_grid_config(40, 15)
        cloud, exp = gen.generate_text(gc, "GPU", value_text=7.0,
                                       value_background=1.0)
        band = run(gc, cloud, RT.Average, mode)
        np.testing.assert_allclose(band, exp, atol=1e-6)
        assert (exp == 7.0).any() and (exp == 1.0).any()

    @pytest.mark.parametrize("shape", ["circle", "square", "triangle"])
    def test_shapes(self, mode, shape):
        gc = gen.make_grid_config(32, 32)
        cloud, exp = gen.generate_shapes(gc, shape, value_inside=5.0,
                                         value_outside=-1.0)
        band = run(gc, cloud, RT.Max, mode)
        np.testing.assert_allclose(band, exp, atol=1e-6)
        assert (exp == 5.0).any() and (exp == -1.0).any()


def test_gaussian_cluster_structure():
    """Gaussian splats fill gaps: coverage with sigma=2 splats strictly
    exceeds point coverage, and cluster centers have data."""
    gc = gen.make_grid_config(100, 100)
    cloud, centers = gen.generate_gaussian_clusters(gc, n_clusters=3,
                                                    points_per_cluster=300)
    point_band = run(gc, cloud, RT.Average, pcr.ExecutionMode.CPU)
    spec = pcr.gaussian_splat_spec("value", default_sigma=2.0,
                                   max_radius_cells=8.0)
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [spec]
    cfg.exec_mode = pcr.ExecutionMode.CPU
    p = pcr.Pipeline.create(cfg)
    p.ingest(cloud)
    p.finalize()
    gauss_band = p.result().band_array(0)
    assert (np.isfinite(gauss_band).sum()
            > np.isfinite(point_band).sum() * 1.5)
    for cx, cy in centers:
        col, row = int(cx), int(cy)
        assert np.isfinite(gauss_band[row, col])
