"""Multi-chip Pipeline lifecycle tests on the 8-device virtual CPU mesh.

The full user-facing Pipeline lifecycle
(create → ingest → resume → finalize → GeoTIFF) must run sharded over a
('dp', 'sp') mesh and match the CPU oracle — all three glyphs and the
sum/max/argmax reduction families. Mirrors the reference lifecycle of
src/engine/pipeline.cpp:31-1403 with sharded state.
"""

import os

import numpy as np
import pytest

import pcr_tpu as pcr
from pcr_tpu.engine.pipeline import (
    ExecutionMode, Pipeline, PipelineConfig, ReductionSpec,
)
from pcr_tpu.parallel.engine import ShardedTpuEngine
from conftest import make_grid_config, make_cloud

RT = pcr.ReductionType
GT = pcr.GlyphType


def run_pipeline(cfg, clouds):
    p = Pipeline.create(cfg)
    for c in clouds:
        p.ingest(c)
    p.finalize()
    return p.result()


def mesh_config(gc, reductions, sp=2, **kw):
    return PipelineConfig(
        grid=gc, reductions=reductions, exec_mode=ExecutionMode.GPU,
        mesh_devices=8, mesh_sp=sp, **kw)


def cpu_config(gc, reductions, **kw):
    return PipelineConfig(grid=gc, reductions=reductions,
                          exec_mode=ExecutionMode.CPU, **kw)


def assert_bands_match(got, want, nbands, atol=1e-5):
    for b in range(nbands):
        np.testing.assert_allclose(
            got.band_array(b), want.band_array(b), atol=atol,
            equal_nan=True, err_msg=f"band {b}")


def point_specs():
    return [
        ReductionSpec(value_channel="v", type=RT.Average),
        ReductionSpec(value_channel="v", type=RT.Max),
        ReductionSpec(value_channel="v", type=RT.MostRecent,
                      timestamp_channel="t"),
    ]


def test_sharded_pipeline_uses_sharded_engine():
    gc = make_grid_config()
    p = Pipeline.create(mesh_config(gc, point_specs()))
    assert isinstance(p._engine, ShardedTpuEngine)
    assert p._engine.mesh.shape == {"dp": 4, "sp": 2}


def test_point_glyph_all_families_match_cpu():
    gc = make_grid_config()
    clouds = [make_cloud(5000, seed=s, channels=("v", "t")) for s in (0, 1)]
    want = run_pipeline(cpu_config(gc, point_specs()), clouds)
    got = run_pipeline(mesh_config(gc, point_specs()), clouds)
    assert_bands_match(got, want, 3)


def test_gaussian_glyph_matches_cpu():
    gc = make_grid_config()
    spec = pcr.gaussian_splat_spec("v", default_sigma=1.5,
                                   max_radius_cells=6.0)
    clouds = [make_cloud(3000, seed=2)]
    want = run_pipeline(cpu_config(gc, [spec]), clouds)
    got = run_pipeline(mesh_config(gc, [spec]), clouds)
    assert_bands_match(got, want, 1, atol=2e-5)


def test_gaussian_rotated_matches_cpu():
    gc = make_grid_config()
    spec = pcr.gaussian_splat_spec("v", default_sigma_x=2.0,
                                   default_sigma_y=0.8,
                                   default_rotation=0.6,
                                   max_radius_cells=7.0)
    clouds = [make_cloud(1500, seed=3)]
    want = run_pipeline(cpu_config(gc, [spec]), clouds)
    got = run_pipeline(mesh_config(gc, [spec]), clouds)
    assert_bands_match(got, want, 1, atol=2e-5)


def test_gaussian_window_per_point_sigma_matches_cpu():
    """Per-point sigmas on a mesh: the whole cloud takes one Gaussian form
    (the window form, since small sigmas bite the product cutoff) and
    every shard compiles the same program (common rmax floor), even where
    a shard's own points alone would pick the separable form."""
    gc = make_grid_config()
    spec = pcr.gaussian_splat_spec("v", sigma_x_channel="s",
                                   sigma_y_channel="s",
                                   max_radius_cells=7.0)
    c = make_cloud(1500, seed=3)
    rng = np.random.default_rng(3)
    # small sigmas only in the top rows: the other shards see sigma >= 2
    sig = np.where(c.y_array() > 80.0, rng.uniform(0.5, 1.0, 1500),
                   rng.uniform(2.0, 2.5, 1500)).astype(np.float32)
    c.add_channel("s", pcr.DataType.Float32)
    c.set_channel_array_f32("s", sig)
    want = run_pipeline(cpu_config(gc, [spec]), [c])
    got = run_pipeline(mesh_config(gc, [spec]), [c])
    assert_bands_match(got, want, 1, atol=2e-5)


def test_line_glyph_matches_cpu():
    gc = make_grid_config()
    spec = pcr.line_splat_spec("v", direction_channel="d",
                               default_half_length=4.0,
                               max_radius_cells=8.0)
    spec.type = RT.Sum
    clouds = [make_cloud(2000, seed=4, channels=("v", "d"))]
    want = run_pipeline(cpu_config(gc, [spec]), clouds)
    got = run_pipeline(mesh_config(gc, [spec]), clouds)
    assert_bands_match(got, want, 1)


def test_multi_tile_home_clip_matches_cpu():
    """Glyph footprints clip to the owner's home tile on the mesh too."""
    gc = make_grid_config(tile=32)
    assert gc.total_tiles() > 1
    gspec = pcr.gaussian_splat_spec("v", default_sigma=2.0,
                                    max_radius_cells=8.0)
    lspec = pcr.line_splat_spec("v", default_direction=0.7,
                                default_half_length=5.0)
    clouds = [make_cloud(2500, seed=5)]
    want = run_pipeline(cpu_config(gc, [gspec, lspec]), clouds)
    got = run_pipeline(mesh_config(gc, [gspec, lspec]), clouds)
    assert_bands_match(got, want, 2, atol=2e-5)


def test_multi_tile_point_families_match_cpu():
    """Multi-tile grids on a mesh: Max/MostRecent/Average point families
    run the partitioned per-shard engines and match the CPU oracle."""
    gc = make_grid_config(tile=32)
    assert gc.total_tiles() > 1
    clouds = [make_cloud(5000, seed=20, channels=("v", "t")) for _ in (0,)]
    want = run_pipeline(cpu_config(gc, point_specs()), clouds)
    got = run_pipeline(mesh_config(gc, point_specs()), clouds)
    assert_bands_match(got, want, 3)


def test_multi_tile_uses_partitioned_engine():
    from pcr_tpu.parallel.engine import PartitionedTpuEngine
    gc = make_grid_config(tile=32)
    p = Pipeline.create(mesh_config(gc, point_specs()))
    assert isinstance(p._engine, PartitionedTpuEngine)
    # per-shard work scales with the shard's points, not the total:
    # routing a bottom-rows-only cloud stages nothing on top shards
    eng = p._engine
    assert eng.nshards > 1
    c = make_cloud(500, seed=21, channels=("v", "t"))
    staged = eng.prepare_point(
        0, np.zeros(4, np.int64) + (gc.height - 1) * gc.width,
        np.ones(4, bool), np.ones(4, np.float32))
    assert {s for s, _ in staged} == {eng.nshards - 1}


def test_multi_tile_glyph_forms_match_cpu():
    """Partitioned engines with both Gaussian forms and lines: every
    update's home-tile clip computes tile rows in the global frame via the
    shard view's row_offset."""
    gc = make_grid_config(tile=32)
    specs = [
        pcr.gaussian_splat_spec("v", default_sigma=2.0,
                                max_radius_cells=8.0),
        pcr.gaussian_splat_spec("v", default_sigma_x=2.0,
                                default_sigma_y=0.8,
                                default_rotation=0.6,
                                max_radius_cells=7.0),
        pcr.line_splat_spec("v", default_direction=0.7,
                            default_half_length=5.0),
    ]
    clouds = [make_cloud(1500, seed=22)]
    want = run_pipeline(cpu_config(gc, specs), clouds)
    got = run_pipeline(mesh_config(gc, specs), clouds)
    assert_bands_match(got, want, 3, atol=2e-5)


def test_memory_budget_with_mesh_raises_typed_error():
    """gpu_memory_budget + mesh is a typed error, not a warn-and-ignore:
    state is already 1/N-sharded per device."""
    gc = make_grid_config()
    cfg = mesh_config(gc, point_specs())
    cfg.gpu_memory_budget = 1 << 20
    with pytest.raises(pcr.PcrError) as ei:
        Pipeline.create(cfg)
    assert ei.value.status.code == pcr.StatusCode.InvalidArgument
    assert "mesh" in str(ei.value)


def test_multi_tile_staged_ingest_matches_cpu():
    """stage() → repeated ingest through the partitioned engine."""
    gc = make_grid_config(tile=32)
    specs = [ReductionSpec(value_channel="v", type=RT.Sum)]
    cloud = make_cloud(3000, seed=25)
    want_once = run_pipeline(cpu_config(gc, specs), [cloud])
    p = Pipeline.create(mesh_config(gc, specs))
    staged = p.stage(cloud)
    p.ingest(staged)
    p.ingest(staged)          # staged chunks are reusable
    p.finalize()
    got = p.result().band_array(0)
    want = want_once.band_array(0) * 2.0
    m = ~np.isnan(want)
    assert (np.isnan(got) == np.isnan(want)).all()
    np.testing.assert_allclose(got[m], want[m], atol=2e-5)


def test_more_devices_than_rows():
    """Tiny grid, 8 devices: shard count clamps to the row count."""
    gc = make_grid_config(w=64.0, h=5.0, tile=2)
    assert gc.total_tiles() > 1
    specs = [ReductionSpec(value_channel="v", type=RT.Average)]
    clouds = [make_cloud(500, seed=26, w=64.0, h=5.0)]
    want = run_pipeline(cpu_config(gc, specs), clouds)
    got = run_pipeline(mesh_config(gc, specs), clouds)
    assert_bands_match(got, want, 1)


def test_multi_tile_resume_roundtrip(tmp_path):
    """Checkpoint/resume through the partitioned engine."""
    gc = make_grid_config(tile=32)
    specs = [ReductionSpec(value_channel="v", type=RT.Max)]
    c1 = make_cloud(2000, seed=23)
    c2 = make_cloud(2000, seed=24)
    want = run_pipeline(cpu_config(gc, specs), [c1, c2])
    state_dir = str(tmp_path / "state")
    p1 = Pipeline.create(mesh_config(gc, specs, state_dir=state_dir))
    p1.ingest(c1)
    p1.finalize()
    p2 = Pipeline.create(mesh_config(gc, specs, state_dir=state_dir,
                                     resume=True))
    p2.ingest(c2)
    p2.finalize()
    assert_bands_match(p2.result(), want, 1)


def test_odd_grid_height_pads_rows():
    """H not divisible by sp: the engine row-pads and slices on fetch."""
    gc = make_grid_config(w=64.0, h=37.0)
    specs = [ReductionSpec(value_channel="v", type=RT.Sum)]
    clouds = [make_cloud(2000, seed=6, w=64.0, h=37.0)]
    want = run_pipeline(cpu_config(gc, specs), clouds)
    got = run_pipeline(mesh_config(gc, specs, sp=4), clouds)
    assert_bands_match(got, want, 1)


def test_collective_free_sp_only_mesh_matches_cpu():
    """dp=1, sp=8: pure spatial sharding — the host-routed fast path with
    no psum at all. Every glyph family through the full pipeline."""
    gc = make_grid_config()
    specs = [
        ReductionSpec(value_channel="v", type=RT.Average),
        pcr.gaussian_splat_spec("v", default_sigma=1.5,
                                max_radius_cells=6.0),
        pcr.line_splat_spec("v", default_direction=0.7,
                            default_half_length=4.0,
                            max_radius_cells=8.0),
    ]
    clouds = [make_cloud(4000, seed=11)]
    want = run_pipeline(cpu_config(gc, specs), clouds)
    got = run_pipeline(mesh_config(gc, specs, sp=8), clouds)
    assert_bands_match(got, want, 3, atol=2e-5)


def test_median_on_mesh_matches_cpu():
    """Median (scatter_kind='collect') on a sharded pipeline: the collect
    stream runs host-side (un-sharded by design) while sharded specs in
    the same pipeline use the mesh — both must match the CPU oracle."""
    gc = make_grid_config()
    specs = [
        ReductionSpec(value_channel="v", type=RT.Median),
        ReductionSpec(value_channel="v", type=RT.Average),
    ]
    clouds = [make_cloud(3000, seed=12), make_cloud(1000, seed=13)]
    want = run_pipeline(cpu_config(gc, specs), clouds)
    got = run_pipeline(mesh_config(gc, specs), clouds)
    assert_bands_match(got, want, 2)


def test_staged_ingest_matches_cpu():
    """Device-resident (stage → ingest) flow over the mesh."""
    gc = make_grid_config()
    specs = [ReductionSpec(value_channel="v", type=RT.Average)]
    cloud = make_cloud(4000, seed=7)
    want = run_pipeline(cpu_config(gc, specs), [cloud])
    p = Pipeline.create(mesh_config(gc, specs))
    staged = p.stage(cloud)
    p.ingest(staged)
    p.finalize()
    assert_bands_match(p.result(), want, 1)


def test_resume_and_geotiff_roundtrip(tmp_path):
    """Full lifecycle: ingest → checkpoint → new sharded pipeline resumes →
    finalize → GeoTIFF equals the single-shot CPU run."""
    gc = make_grid_config()
    specs = [ReductionSpec(value_channel="v", type=RT.Average),
             ReductionSpec(value_channel="v", type=RT.Max)]
    c1 = make_cloud(3000, seed=8)
    c2 = make_cloud(3000, seed=9)
    want = run_pipeline(cpu_config(gc, specs), [c1, c2])

    state_dir = str(tmp_path / "state")
    out_tif = str(tmp_path / "out.tif")
    p1 = Pipeline.create(mesh_config(gc, specs, state_dir=state_dir))
    p1.ingest(c1)
    p1.finalize()           # flushes PCRT tile state

    p2 = Pipeline.create(mesh_config(gc, specs, state_dir=state_dir,
                                     resume=True, output_path=out_tif))
    p2.ingest(c2)
    p2.finalize()
    assert_bands_match(p2.result(), want, 2)

    assert os.path.exists(out_tif)
    from pcr_tpu.io.geotiff import read_geotiff_band, read_geotiff_info
    info = read_geotiff_info(out_tif)
    band0 = read_geotiff_band(out_tif, 0)
    np.testing.assert_allclose(band0, want.band_array(0), atol=1e-5,
                               equal_nan=True)


def test_progress_and_stats_on_mesh():
    gc = make_grid_config()
    specs = [ReductionSpec(value_channel="v", type=RT.Sum)]
    seen = []
    p = Pipeline.create(mesh_config(gc, specs))
    p.set_progress_callback(lambda info: (seen.append(info), True)[1])
    p.ingest(make_cloud(1000, seed=10))
    assert seen and seen[0].points_processed == 1000


def test_rotated_shard_boundary_straddler():
    """Rotated Gaussians whose home tile starts at/after a shard's end
    (straddlers routed for their footprint overlap) must paint nothing on
    that shard: the window form's home-tile clip drops every cell there.
    Geometry: tile rows coinciding with shard boundaries, centers within
    r below the boundary."""
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, 64.0, 1024.0
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.tile_width = gc.tile_height = 32
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()
    assert gc.total_tiles() > 1

    rng = np.random.default_rng(31)
    n = 400
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, 64, n))
    # concentrate centers just below shard boundaries (global rows
    # 128*k +- 4) so footprints straddle into the shard above
    k = rng.integers(1, 8, n)
    rows = k * 128 + rng.uniform(0.2, 4.0, n)
    c.set_y_array(1024.0 - rows)
    c.add_channel("v", pcr.DataType.Float32)
    c.set_channel_array_f32("v", rng.normal(0, 1, n).astype(np.float32))

    spec = pcr.gaussian_splat_spec("v", default_sigma_x=1.2,
                                   default_sigma_y=0.7,
                                   default_rotation=0.5,
                                   max_radius_cells=4.0)
    want = run_pipeline(cpu_config(gc, [spec]), [c])
    got = run_pipeline(mesh_config(gc, [spec]), [c])
    assert_bands_match(got, want, 1, atol=2e-5)
