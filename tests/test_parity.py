"""CPU-oracle ↔ JAX-engine parity tests.

This is the rebuild of the reference's CPU/GPU parity mechanism
(scripts/patterns/compare_cpu_gpu_patterns.py:28-95, tolerance 1e-4);
this build targets the tighter 1e-5 bar (BASELINE.json north_star).
The JAX engine runs on CPU devices here (conftest sets JAX_PLATFORMS=cpu
with PCR_FORCE_JAX=1) — the same XLA programs the GPU runs.
"""

import math

import numpy as np
import pytest

import pcr_tpu as pcr
from conftest import make_grid_config

RT = pcr.ReductionType
PARITY_ATOL = 1e-5


def run_mode(mode, specs, clouds, gc, **cfg_kw):
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [_clone_spec(s) for s in specs]
    cfg.exec_mode = mode
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    p = pcr.Pipeline.create(cfg)
    for c in clouds:
        p.ingest(c)
    p.finalize()
    return [p.result().band_array(i).copy() for i in range(len(specs))]


def _clone_spec(s):
    import copy
    return copy.deepcopy(s)


def assert_parity(specs, clouds, gc, atol=PARITY_ATOL, rtol=PARITY_ATOL,
                  mode=pcr.ExecutionMode.GPU):
    """Parity bar: |cpu - device| <= atol + rtol * |cpu| per cell.

    The reference's own CPU/GPU comparator uses 1e-4 absolute
    (compare_cpu_gpu_patterns.py:28-41); this bar is tighter (1e-5) with a
    relative term for cells whose magnitude makes 1e-5 absolute stricter
    than float32 itself (eps = 1.2e-7 relative)."""
    a = run_mode(pcr.ExecutionMode.CPU, specs, clouds, gc)
    b = run_mode(mode, specs, clouds, gc)
    assert_bands_close(a, b, atol, rtol)


def assert_bands_close(a, b, atol=PARITY_ATOL, rtol=PARITY_ATOL):
    for i, (x, y) in enumerate(zip(a, b)):
        nan_mismatch = int((np.isnan(x) != np.isnan(y)).sum())
        assert nan_mismatch == 0, f"spec {i}: {nan_mismatch} NaN mismatches"
        m = ~np.isnan(x)
        if m.any():
            excess = np.abs(x[m] - y[m]) - (atol + rtol * np.abs(x[m]))
            d = float(excess.max())
            assert d <= 0, f"spec {i}: parity excess {d}"


def oob_cloud(n=3000, seed=0, w=200.0, h=150.0):
    """Points over a margin around the grid: some fall outside (invalid)."""
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(-5, w + 5, n))
    c.set_y_array(rng.uniform(-5, h + 5, n))
    for name, arr in [("v", rng.normal(0, 1, n)),
                      ("w", rng.uniform(0.1, 2.0, n)),
                      ("sig", rng.uniform(0.5, 2.5, n)),
                      ("dir", rng.uniform(0, 6.28, n)),
                      ("hl", rng.uniform(0.5, 6.0, n))]:
        c.add_channel(name, pcr.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


def glyph_cloud(n=15000, seed=0, w=100.0, h=100.0):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, w, n))
    c.set_y_array(rng.uniform(0, h, n))
    for name, arr in [
        ("v", rng.normal(0, 1, n)),
        ("w", rng.uniform(0.1, 2.0, n)),
        ("ts", rng.uniform(0, 100, n)),
        ("sig", rng.uniform(0.5, 3.0, n)),
        ("rot", rng.uniform(0, np.pi, n)),
        ("dir", rng.uniform(0, 2 * np.pi, n)),
        ("hl", rng.uniform(0.5, 6.0, n)),
    ]:
        c.add_channel(name, pcr.DataType.Float32)
        c.set_channel_array_f32(name, arr.astype(np.float32))
    return c


class TestPointParity:
    def test_all_reductions(self):
        gc = make_grid_config(w=100.0, h=100.0)
        cloud = glyph_cloud()
        specs = [
            pcr.ReductionSpec(value_channel="v", type=RT.Sum),
            pcr.ReductionSpec(value_channel="v", type=RT.Average),
            pcr.ReductionSpec(value_channel="v", type=RT.Max),
            pcr.ReductionSpec(value_channel="v", type=RT.Min),
            pcr.ReductionSpec(value_channel="v", type=RT.Count),
            pcr.ReductionSpec(value_channel="v", type=RT.WeightedAverage,
                              weight_channel="w"),
            pcr.ReductionSpec(value_channel="v", type=RT.MostRecent,
                              timestamp_channel="ts"),
        ]
        assert_parity(specs, [cloud], gc)

    def test_multi_cloud(self):
        gc = make_grid_config(w=100.0, h=100.0)
        clouds = [glyph_cloud(seed=s) for s in range(3)]
        specs = [pcr.ReductionSpec(value_channel="v", type=RT.Average)]
        assert_parity(specs, clouds, gc)

    def test_chunking_boundary(self):
        """Cross the first chunk bucket (8192) to exercise padding."""
        gc = make_grid_config(w=100.0, h=100.0)
        cloud = glyph_cloud(n=8193)
        specs = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
        assert_parity(specs, [cloud], gc)


    @pytest.mark.parametrize("rtype", [RT.Sum, RT.Average, RT.Count,
                                       RT.WeightedAverage])
    def test_single_reduction_with_invalid_points(self, rtype):
        gc = make_grid_config(w=200.0, h=150.0)
        spec = pcr.ReductionSpec(value_channel="v", type=rtype)
        if rtype == RT.WeightedAverage:
            spec.weight_channel = "w"
        assert_parity([spec], [oob_cloud()], gc)

    def test_multi_ingest_count_accumulates(self):
        gc = make_grid_config(w=200.0, h=150.0)
        cfg = pcr.PipelineConfig(
            grid=gc, exec_mode=pcr.ExecutionMode.GPU,
            reductions=[pcr.ReductionSpec(value_channel="v",
                                          type=RT.Count)])
        p = pcr.Pipeline.create(cfg)
        p.ingest(oob_cloud(seed=1))
        p.ingest(oob_cloud(seed=2))
        p.finalize()
        total = np.nansum(p.result().band_array(0))
        assert total == p.stats().points_processed

class TestGaussianParity:
    def test_default_sigma(self):
        gc = make_grid_config(w=100.0, h=100.0)
        spec = pcr.gaussian_splat_spec("v", default_sigma=2.0,
                                       max_radius_cells=8.0)
        assert_parity([spec], [glyph_cloud()], gc)

    def test_per_point_sigma(self):
        gc = make_grid_config(w=100.0, h=100.0)
        spec = pcr.gaussian_splat_spec("v", sigma_x_channel="sig",
                                       sigma_y_channel="sig",
                                       max_radius_cells=12.0)
        assert_parity([spec], [glyph_cloud()], gc)

    def test_rotated_anisotropic(self):
        gc = make_grid_config(w=100.0, h=100.0)
        spec = pcr.gaussian_splat_spec("v", default_sigma_x=3.0,
                                       default_sigma_y=1.0,
                                       rotation_channel="rot",
                                       max_radius_cells=10.0)
        assert_parity([spec], [glyph_cloud(n=4000)], gc)

    def test_gaussian_sum_and_count(self):
        gc = make_grid_config(w=100.0, h=100.0)
        s1 = pcr.gaussian_splat_spec("v", default_sigma=1.5,
                                     max_radius_cells=6.0)
        s1.type = RT.Sum
        s2 = pcr.gaussian_splat_spec("v", default_sigma=1.5,
                                     max_radius_cells=6.0)
        s2.type = RT.Count
        s3 = pcr.gaussian_splat_spec("v", default_sigma=1.5,
                                     max_radius_cells=6.0)
        s3.type = RT.Average
        assert_parity([s1, s2, s3], [glyph_cloud()], gc)

    def test_non_square_cells(self):
        gc = make_grid_config(w=100.0, h=100.0, cell=0.5)
        spec = pcr.gaussian_splat_spec("v", default_sigma=1.0,
                                       max_radius_cells=8.0)
        assert_parity([spec], [glyph_cloud(n=5000)], gc)


    def test_per_point_sigma_with_invalid_points(self):
        gc = make_grid_config(w=200.0, h=150.0)
        spec = pcr.gaussian_splat_spec("v", sigma_x_channel="sig",
                                       sigma_y_channel="sig",
                                       max_radius_cells=6.0)
        assert_parity([spec], [oob_cloud()], gc)

    @pytest.mark.parametrize("sigma", [1.0, 1.3])
    def test_small_sigma_takes_window_form(self, sigma):
        """Small uniform sigmas bite the reference's product cutoff, so
        they take the exact window form; NaN footprint and values hold the
        parity bar."""
        from pcr_tpu.engine.tpu_backend import (gauss_form,
                                                gauss_product_cutoff_bites)
        r = math.ceil(3.0 * sigma)
        assert gauss_product_cutoff_bites(r, sigma, sigma)
        assert gauss_form(False, [r], [sigma], [sigma], 200,
                          4 * 200 * 200) == "window"
        gc = make_grid_config(w=200.0, h=150.0)
        spec = pcr.gaussian_splat_spec("v", default_sigma=float(sigma),
                                       max_radius_cells=8.0)
        assert_parity([spec], [oob_cloud()], gc)

    def test_small_sigma_nan_footprint_exact(self):
        """A point whose window corner falls below the product cutoff:
        the device path must reproduce the oracle's NaN footprint EXACTLY."""
        gc = make_grid_config(w=64.0, h=64.0)
        spec = pcr.gaussian_splat_spec("v", default_sigma=1.0,
                                       max_radius_cells=8.0)
        # sub-cell offsets near 1.0 maximize the corner distance: the
        # (-3,-3) corner's product weight dips under 1e-6 while both axis
        # factors pass
        c = pcr.PointCloud.create(4)
        c.set_x_array(np.array([32.99, 10.97, 50.01, 20.5]))
        c.set_y_array(np.array([32.99, 40.98, 12.02, 20.5]))
        c.add_channel("v", pcr.DataType.Float32)
        c.set_channel_array_f32("v", np.ones(4, np.float32))
        assert_parity([spec], [c], gc)

    @pytest.mark.parametrize("sigma", [0.5, 1.0])
    @pytest.mark.parametrize("mode", [pcr.ExecutionMode.GPU,
                                      pcr.ExecutionMode.Hybrid])
    def test_small_sigma_product_cutoff(self, sigma, mode):
        """The reference drops cells where the PRODUCT weight
        exp(-(qx^2+qy^2)/2) < 1e-6, which per-axis separable masks cannot
        express — at sigma <~ 1.7 the square 3-sigma window pokes outside
        the cutoff ellipse. Checks the NaN footprint exactly and values to
        the parity bar, staged and host-sourced."""
        gc = make_grid_config(w=120.0, h=100.0)
        n = 4000
        rng = np.random.default_rng(11)
        c = pcr.PointCloud.create(n)
        c.set_x_array(rng.uniform(0, 120, n))
        c.set_y_array(rng.uniform(0, 100, n))
        c.add_channel("v", pcr.DataType.Float32)
        c.set_channel_array_f32("v", rng.uniform(1, 2, n).astype(np.float32))
        spec = pcr.gaussian_splat_spec("v", default_sigma=sigma)
        assert_parity([spec], [c], gc, mode=mode)

    @pytest.mark.parametrize("rtype", ["avg", "sum"])
    @pytest.mark.parametrize("name,kw", [
        ("rot_aniso", dict(default_sigma_x=3.0, default_sigma_y=1.2,
                           default_rotation=0.7)),
        ("rot_small", dict(default_sigma_x=0.8, default_sigma_y=0.6,
                           default_rotation=1.1)),
        ("rot_steep", dict(default_sigma_x=4.0, default_sigma_y=1.0,
                           default_rotation=-0.4)),
    ], ids=["rot_aniso", "rot_small", "rot_steep"])
    def test_rotated_window_staged(self, name, kw, rtype):
        """Rotated splats over points straddling the grid edges, staged on
        the device (window clipping must match the oracle)."""
        gc = make_grid_config(w=96.0, h=96.0)
        rng = np.random.default_rng(7)
        n = 1200
        c = pcr.PointCloud.create(n)
        c.set_x_array(rng.uniform(-3, 99, n))
        c.set_y_array(rng.uniform(-3, 99, n))
        c.add_channel("v", pcr.DataType.Float32)
        c.set_channel_array_f32("v", rng.uniform(0, 1, n).astype(np.float32))
        spec = pcr.gaussian_splat_spec("v", **kw)
        if rtype == "sum":
            spec.type = RT.Sum
        want = run_mode(pcr.ExecutionMode.CPU, [spec], [c], gc)
        cfg = pcr.PipelineConfig(grid=gc, reductions=[_clone_spec(spec)],
                                 exec_mode=pcr.ExecutionMode.GPU,
                                 gpu_require_strict=True)
        p = pcr.Pipeline.create(cfg)
        p.ingest(p.stage(c))
        p.finalize()
        assert any(k[0] == "gauss_window" for k in p._engine._jits)
        assert_bands_close(want, [p.result().band_array(0)])

class TestLineParity:
    def test_fixed_direction(self):
        gc = make_grid_config(w=100.0, h=100.0)
        spec = pcr.line_splat_spec("v", default_direction=0.7,
                                   default_half_length=4.0,
                                   max_radius_cells=8.0)
        assert_parity([spec], [glyph_cloud()], gc)

    def test_per_point_channels(self):
        gc = make_grid_config(w=100.0, h=100.0)
        spec = pcr.line_splat_spec("v", direction_channel="dir",
                                   half_length_channel="hl",
                                   max_radius_cells=8.0)
        assert_parity([spec], [glyph_cloud()], gc)


    def test_fixed_direction_with_invalid_points(self):
        gc = make_grid_config(w=200.0, h=150.0)
        spec = pcr.line_splat_spec("v", default_direction=0.7,
                                   default_half_length=5.0,
                                   max_radius_cells=8.0)
        assert_parity([spec], [oob_cloud()], gc)

class TestTiledParity:
    def test_glyph_clipping_small_tiles(self):
        gc = make_grid_config(w=100.0, h=100.0, tile=32)
        sg = pcr.gaussian_splat_spec("v", default_sigma=2.0,
                                     max_radius_cells=8.0)
        sl = pcr.line_splat_spec("v", direction_channel="dir",
                                 half_length_channel="hl",
                                 max_radius_cells=8.0)
        assert_parity([sg, sl], [glyph_cloud()], gc)


    def test_gaussian_clipping_tiles_64(self):
        gc = make_grid_config(w=200.0, h=150.0, tile=64)
        spec = pcr.gaussian_splat_spec("v", default_sigma=2.0,
                                       max_radius_cells=6.0)
        assert_parity([spec], [oob_cloud()], gc)

    def test_line_per_point_tiles_64(self):
        gc = make_grid_config(w=200.0, h=150.0, tile=64)
        spec = pcr.line_splat_spec("v", direction_channel="dir",
                                   half_length_channel="hl",
                                   max_radius_cells=8.0)
        assert_parity([spec], [oob_cloud()], gc)

    def test_rotated_multitile_clip(self):
        gc = make_grid_config(w=96.0, h=96.0, tile=48)
        spec = pcr.gaussian_splat_spec("v", default_sigma_x=2.5,
                                       default_sigma_y=1.0,
                                       default_rotation=0.5)
        assert_parity([spec], [oob_cloud(n=800, seed=11, w=96.0, h=96.0)],
                      gc)

class TestFilterParity:
    def test_filtered_ingest(self):
        gc = make_grid_config(w=100.0, h=100.0)
        cloud = glyph_cloud()
        specs = [pcr.ReductionSpec(value_channel="v", type=RT.Average)]
        for mode_kw in ({},):
            cfg_a = dict(filter=pcr.FilterSpec().add(
                "w", pcr.CompareOp.Greater, 1.0))
            a = run_mode(pcr.ExecutionMode.CPU, specs, [cloud], gc, **cfg_a)
            b = run_mode(pcr.ExecutionMode.GPU, specs, [cloud], gc, **cfg_a)
            m = ~np.isnan(a[0])
            assert (np.isnan(a[0]) == np.isnan(b[0])).all()
            assert np.abs(a[0][m] - b[0][m]).max() <= PARITY_ATOL


class TestLargeExtentParity:
    """SURVEY §7 'hard parts' — f64 host coordinates vs f32 device
    offsets at LiDAR-scale ABSOLUTE coordinates: a
    UTM-scale frame (offsets >= 3.8e5 m east / 4.3e6 m north, the DC
    EPSG:32110-like magnitude; f32 alone resolves only ~0.03 m at 3.8e5
    and ~0.5 m at 4.3e6, so any device math on absolute f32 coordinates
    would shear cells). The engine must subtract the grid origin in f64
    on the host and carry f32 offsets; the 1e-5 parity bar catches any
    absolute-coordinate leak."""

    OX, OY = 389_000.0, 4_306_000.0   # ~DC easting/northing magnitudes

    def _grid(self, tile=4096):
        bbox = pcr.BBox()
        bbox.min_x, bbox.min_y = self.OX, self.OY
        bbox.max_x, bbox.max_y = self.OX + 1000.0, self.OY + 1000.0
        gc = pcr.GridConfig()
        gc.bounds = bbox
        gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
        gc.tile_width = gc.tile_height = tile
        gc.crs = pcr.CRS.from_epsg(32110)
        gc.compute_dimensions()
        return gc

    def _cloud(self, n=20000, seed=6):
        rng = np.random.default_rng(seed)
        c = pcr.PointCloud.create(n)
        # concentrate mass near cell boundaries too: f32 absolute coords
        # would flip these across cells
        x = self.OX + rng.uniform(0, 1000.0, n)
        x[: n // 4] = self.OX + np.round(x[: n // 4] - self.OX) \
            + rng.uniform(-1e-3, 1e-3, n // 4)
        c.set_x_array(x)
        c.set_y_array(self.OY + rng.uniform(0, 1000.0, n))
        for name, arr in [
            ("v", rng.normal(0, 1, n)),
            ("dir", rng.uniform(0, 2 * np.pi, n)),
            ("hl", rng.uniform(0.5, 6.0, n)),
        ]:
            c.add_channel(name, pcr.DataType.Float32)
            c.set_channel_array_f32(name, arr.astype(np.float32))
        return c

    def test_point_families_at_utm_offsets(self):
        gc = self._grid()
        specs = [
            pcr.ReductionSpec(value_channel="v", type=RT.Sum),
            pcr.ReductionSpec(value_channel="v", type=RT.Average),
            pcr.ReductionSpec(value_channel="v", type=RT.Max),
        ]
        assert_parity(specs, [self._cloud()], gc)

    def test_glyphs_at_utm_offsets(self):
        gc = self._grid()
        specs = [
            pcr.gaussian_splat_spec("v", default_sigma=2.0,
                                    max_radius_cells=8.0),
            pcr.gaussian_splat_spec("v", default_sigma_x=2.0,
                                    default_sigma_y=0.8,
                                    default_rotation=0.6,
                                    max_radius_cells=7.0),
            pcr.line_splat_spec("v", direction_channel="dir",
                                half_length_channel="hl",
                                max_radius_cells=8.0),
        ]
        assert_parity(specs, [self._cloud()], gc)

    def test_tiled_at_utm_offsets(self):
        gc = self._grid(tile=256)
        assert gc.total_tiles() > 1
        specs = [pcr.gaussian_splat_spec("v", default_sigma=2.0,
                                         max_radius_cells=8.0)]
        assert_parity(specs, [self._cloud()], gc)



class TestHybridParity:
    """Host-sourced (Hybrid) ingest runs the same staged programs as GPU
    mode, sliced across worker threads; it holds the same parity bar."""

    @staticmethod
    def _cloud(n, extent, seed=3, channels=("value",)):
        rng = np.random.default_rng(seed)
        c = pcr.PointCloud.create(n)
        c.set_x_array(rng.uniform(0, extent, n))
        c.set_y_array(rng.uniform(0, extent, n))
        for ch, lo, hi in [("value", 0, 1), ("sigma", 0.5, 2.5),
                           ("direction", 0, np.pi)]:
            if ch in channels:
                c.add_channel(ch, pcr.DataType.Float32)
                c.set_channel_array_f32(
                    ch, rng.uniform(lo, hi, n).astype(np.float32))
        return c

    @pytest.mark.parametrize("name,spec,channels", [
        ("uniform", pcr.gaussian_splat_spec("value", default_sigma=2.0),
         ("value",)),
        ("perpoint", pcr.gaussian_splat_spec("value",
                                             sigma_x_channel="sigma"),
         ("value", "sigma")),
        ("rot", pcr.gaussian_splat_spec("value", default_sigma_x=3.0,
                                        default_sigma_y=1.2,
                                        default_rotation=0.7),
         ("value",)),
    ], ids=["uniform", "perpoint", "rot"])
    def test_gaussian(self, name, spec, channels):
        gc = make_grid_config(w=128.0, h=128.0)
        assert_parity([spec], [self._cloud(2000, 128.0, channels=channels)],
                      gc, mode=pcr.ExecutionMode.Hybrid)

    def test_line_matches_staged_and_oracle(self):
        gc = make_grid_config(w=128.0, h=128.0)
        cloud = self._cloud(2000, 128.0, channels=("value", "direction"))
        spec = pcr.line_splat_spec("value", default_half_length=5.0,
                                   direction_channel="direction")
        cfg = pcr.PipelineConfig(grid=gc, reductions=[_clone_spec(spec)],
                                 exec_mode=pcr.ExecutionMode.GPU)
        p = pcr.Pipeline.create(cfg)
        p.ingest(p.stage(cloud))
        p.finalize()
        staged = p.result().band_array(0)
        hyb = run_mode(pcr.ExecutionMode.Hybrid, [spec], [cloud], gc)
        assert np.array_equal(staged, hyb[0], equal_nan=True)
        assert_parity([spec], [cloud], gc, mode=pcr.ExecutionMode.Hybrid)

    def test_gaussian_multi_tile_clip(self):
        gc = make_grid_config(w=160.0, h=160.0, tile=64)
        spec = pcr.gaussian_splat_spec("value", default_sigma=2.0)
        assert_parity([spec], [self._cloud(1500, 160.0)], gc,
                      mode=pcr.ExecutionMode.Hybrid)

    def test_line_multi_tile_clip(self):
        gc = make_grid_config(w=160.0, h=160.0, tile=64)
        spec = pcr.line_splat_spec("value", default_half_length=6.0,
                                   direction_channel="direction")
        assert_parity([spec], [self._cloud(1500, 160.0,
                                           channels=("value",
                                                     "direction"))],
                      gc, mode=pcr.ExecutionMode.Hybrid)

    def test_repeat_ingest_stable_keys(self):
        """Repeated hybrid ingests of same-bucket clouds reuse compiled
        programs; two ingests double the Sum."""
        gc = make_grid_config(w=128.0, h=128.0)
        spec = pcr.gaussian_splat_spec("value", default_sigma=1.5)
        spec.type = RT.Sum
        cloud = self._cloud(1000, 128.0)
        cfg = pcr.PipelineConfig(grid=gc, reductions=[spec],
                                 exec_mode=pcr.ExecutionMode.Hybrid)
        p = pcr.Pipeline.create(cfg)
        p.ingest(cloud)
        keys_after_first = set(p._engine._jits.keys())
        p.ingest(cloud)
        assert set(p._engine._jits.keys()) == keys_after_first
        p.finalize()
        once = run_mode(pcr.ExecutionMode.Hybrid, [spec], [cloud], gc)[0]
        twice = p.result().band_array(0)
        assert np.allclose(np.nan_to_num(twice), 2 * np.nan_to_num(once),
                           rtol=1e-6, atol=1e-6)

    def test_commit_programs_keyed_per_chunk(self):
        """Multi-chunk ingests compile the bucket ladder (per-chunk keys)
        plus finalize programs keyed independently of the chunk history."""
        gc = make_grid_config(w=128.0, h=128.0)
        cfg = pcr.PipelineConfig(
            grid=gc, exec_mode=pcr.ExecutionMode.Hybrid, chunk_size=300,
            reductions=[pcr.ReductionSpec(value_channel="value",
                                          type=RT.Average)])
        p = pcr.Pipeline.create(cfg)
        p.ingest(self._cloud(1000, 128.0))    # 1000 points -> 4 chunks
        p.finalize()
        for key in p._engine._jits:
            head = key[0] if isinstance(key, tuple) else key
            assert head != "multi", f"multiset-keyed commit program: {key}"
            if head in ("finstrips", "finpack"):
                assert not any(isinstance(part, tuple) for part in key), (
                    f"finalize program keyed by chunk history: {key}")
