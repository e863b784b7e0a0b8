"""Out-of-core accelerator path (OutOfCoreTpuEngine).

With a small gpu_memory_budget the accelerator
pipeline must keep full state off-device and stage row bands, producing
results that match the resident engine exactly (banding preserves both the
per-cell contribution sets and their accumulation order).
"""

import numpy as np
import pytest

import pcr_tpu as pcr
from pcr_tpu.engine.out_of_core import OutOfCoreTpuEngine, pick_band_rows
from pcr_tpu.engine.pipeline import (
    ExecutionMode, Pipeline, PipelineConfig, ReductionSpec,
)
from conftest import make_grid_config, make_cloud

RT = pcr.ReductionType


def pipe_cfg(gc, reductions, budget=0, mode=ExecutionMode.GPU, **kw):
    return PipelineConfig(grid=gc, reductions=reductions, exec_mode=mode,
                          gpu_memory_budget=budget, **kw)


def run(cfg, clouds):
    p = Pipeline.create(cfg)
    for c in clouds:
        p.ingest(c)
    p.finalize()
    return p


def test_budget_engages_banding():
    gc = make_grid_config(w=512.0, h=512.0, tile=128)
    specs = [ReductionSpec(value_channel="v", type=RT.Average)]
    p = Pipeline.create(pipe_cfg(gc, specs, budget=1 << 20))
    assert isinstance(p._engine, OutOfCoreTpuEngine)
    assert p._engine.band_rows % gc.tile_height == 0
    # ample budget -> resident engine
    p2 = Pipeline.create(pipe_cfg(gc, specs, budget=1 << 30))
    assert not isinstance(p2._engine, OutOfCoreTpuEngine)


@pytest.mark.parametrize("rtype", [RT.Average, RT.Sum, RT.Max, RT.MostRecent])
def test_point_banded_matches_resident_exactly(rtype):
    gc = make_grid_config(w=512.0, h=512.0, tile=128)
    specs = [ReductionSpec(value_channel="v", type=rtype,
                           timestamp_channel="t")]
    clouds = [make_cloud(8000, seed=s, w=512.0, h=512.0,
                         channels=("v", "t")) for s in (0, 1)]
    res = run(pipe_cfg(gc, specs), clouds).result()
    ooc = run(pipe_cfg(gc, specs, budget=1 << 20), clouds).result()
    np.testing.assert_array_equal(ooc.band_array(0), res.band_array(0))


def test_gaussian_banded_matches_resident_exactly():
    gc = make_grid_config(w=512.0, h=512.0, tile=128)
    spec = pcr.gaussian_splat_spec("v", default_sigma=2.0,
                                   max_radius_cells=8.0)
    clouds = [make_cloud(4000, seed=2, w=512.0, h=512.0)]
    res = run(pipe_cfg(gc, [spec]), clouds).result()
    ooc = run(pipe_cfg(gc, [spec], budget=1 << 20), clouds).result()
    # per-band sub-chunk padding shifts block boundaries, reassociating a
    # handful of float adds — bounded well under the 1e-5 parity bar
    np.testing.assert_allclose(ooc.band_array(0), res.band_array(0),
                               atol=1e-6, equal_nan=True)


def test_gaussian_rotated_banded_matches_resident():
    gc = make_grid_config(w=256.0, h=256.0, tile=64)
    spec = pcr.gaussian_splat_spec("v", default_sigma_x=2.5,
                                   default_sigma_y=1.0,
                                   default_rotation=0.8,
                                   max_radius_cells=8.0)
    clouds = [make_cloud(1500, seed=3, w=256.0, h=256.0)]
    res = run(pipe_cfg(gc, [spec]), clouds).result()
    ooc = run(pipe_cfg(gc, [spec], budget=1 << 18), clouds).result()
    np.testing.assert_allclose(ooc.band_array(0), res.band_array(0),
                               atol=1e-6, equal_nan=True)


def test_line_banded_matches_resident_exactly():
    gc = make_grid_config(w=512.0, h=512.0, tile=128)
    spec = pcr.line_splat_spec("v", direction_channel="d",
                               default_half_length=6.0,
                               max_radius_cells=10.0)
    spec.type = RT.Sum
    clouds = [make_cloud(3000, seed=4, w=512.0, h=512.0,
                         channels=("v", "d"))]
    res = run(pipe_cfg(gc, [spec]), clouds).result()
    ooc = run(pipe_cfg(gc, [spec], budget=1 << 20), clouds).result()
    np.testing.assert_array_equal(ooc.band_array(0), res.band_array(0))


def test_multi_reduction_banded_with_resume(tmp_path):
    """Banded engine through the full lifecycle incl. PCRT checkpoint."""
    gc = make_grid_config(w=512.0, h=512.0, tile=128)
    specs = [ReductionSpec(value_channel="v", type=RT.Average),
             ReductionSpec(value_channel="v", type=RT.Max)]
    c1 = make_cloud(5000, seed=5, w=512.0, h=512.0)
    c2 = make_cloud(5000, seed=6, w=512.0, h=512.0)
    want = run(pipe_cfg(gc, specs), [c1, c2]).result()

    sd = str(tmp_path / "state")
    p1 = run(pipe_cfg(gc, specs, budget=1 << 20, state_dir=sd), [c1])
    p2 = run(pipe_cfg(gc, specs, budget=1 << 20, state_dir=sd,
                      resume=True), [c2])
    got = p2.result()
    for b in range(2):
        np.testing.assert_allclose(got.band_array(b), want.band_array(b),
                                   atol=1e-6, equal_nan=True)


def test_big_grid_small_budget_matches_cpu_oracle():
    """8192^2 grid, small budget, sparse cloud: the banded accelerator
    result equals the CPU oracle."""
    gc = make_grid_config(w=8192.0, h=8192.0, tile=512)
    specs = [ReductionSpec(value_channel="v", type=RT.Average)]
    clouds = [make_cloud(20000, seed=7, w=8192.0, h=8192.0)]
    cpu = run(pipe_cfg(gc, specs, mode=ExecutionMode.CPU), clouds).result()
    ooc_pipe = run(pipe_cfg(gc, specs, budget=32 << 20), clouds)
    assert isinstance(ooc_pipe._engine, OutOfCoreTpuEngine)
    assert ooc_pipe._engine.nbands > 1
    np.testing.assert_allclose(ooc_pipe.result().band_array(0),
                               cpu.band_array(0), atol=1e-5,
                               equal_nan=True)


def test_chunk_size_honored():
    """config.chunk_size slices device ingest (declared-unused in the
    reference, pipeline.h:67; read here)."""
    gc = make_grid_config()
    specs = [ReductionSpec(value_channel="v", type=RT.Average)]
    cloud = make_cloud(10000, seed=8)
    want = run(pipe_cfg(gc, specs), [cloud]).result()
    got = run(pipe_cfg(gc, specs, chunk_size=3000), [cloud]).result()
    np.testing.assert_allclose(got.band_array(0), want.band_array(0),
                               atol=1e-6, equal_nan=True)


# -- untiled (single-tile) grids ----------------------------------------------
# An over-budget grid whose default 4096^2 tile covers it entirely used to
# slip through banding and run fully resident (or raise an untyped error).
# Untiled grids now band on raw GAUSS_ROW_BLOCK-aligned rows, duplicating
# each glyph entry into every band its footprint touches (reference
# analogue: tile_manager.cpp:183-414).

def untiled_grid(n=600.0):
    gc = make_grid_config(w=n, h=n)
    gc.tile_width = gc.tile_height = 8192   # single tile covers the grid
    gc.compute_dimensions()
    assert gc.total_tiles() == 1
    return gc


def test_untiled_budget_engages_banding():
    gc = untiled_grid()
    specs = [ReductionSpec(value_channel="v", type=RT.Average)]
    p = Pipeline.create(pipe_cfg(gc, specs, budget=1 << 20))
    assert isinstance(p._engine, OutOfCoreTpuEngine)
    assert p._engine.untiled
    assert p._engine.nbands > 1


def test_untiled_point_banded_matches_resident_exactly():
    gc = untiled_grid()
    specs = [ReductionSpec(value_channel="v", type=RT.Average)]
    clouds = [make_cloud(8000, seed=s, w=600.0, h=600.0,
                         channels=("v",)) for s in (0, 1)]
    res = run(pipe_cfg(gc, specs), clouds).result()
    ooc = run(pipe_cfg(gc, specs, budget=1 << 20), clouds).result()
    np.testing.assert_array_equal(ooc.band_array(0), res.band_array(0))


def test_untiled_gaussian_cross_band_footprints_match_resident():
    """Gaussian footprints (sigma=4 -> r=12) span band boundaries on an
    untiled grid; the duplicated entries must reproduce the resident
    result exactly."""
    gc = untiled_grid()
    spec = pcr.gaussian_splat_spec("v", default_sigma=4.0)
    clouds = [make_cloud(4000, seed=7, w=600.0, h=600.0, channels=("v",))]
    res = run(pipe_cfg(gc, [spec]), clouds).result()
    ooc = run(pipe_cfg(gc, [spec], budget=1 << 20), clouds).result()
    np.testing.assert_array_equal(ooc.band_array(0), res.band_array(0))


def test_untiled_line_cross_band_matches_resident():
    gc = untiled_grid()
    spec = pcr.line_splat_spec("v", default_half_length=10.0,
                               direction_channel="d")
    clouds = [make_cloud(4000, seed=9, w=600.0, h=600.0,
                         channels=("v", "d"))]
    res = run(pipe_cfg(gc, [spec]), clouds).result()
    ooc = run(pipe_cfg(gc, [spec], budget=1 << 20), clouds).result()
    np.testing.assert_array_equal(ooc.band_array(0), res.band_array(0))
