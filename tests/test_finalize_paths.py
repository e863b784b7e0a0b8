"""Round-trip-minimal finalize paths (pipeline._finalize_packed /
_finalize_streamed with state).

Contract: regardless of which transfer strategy finalize picks (one
packed transfer for small grids, adaptive strips for large; raw state
planes + host finalize when state_dir is set), the result band, the
GeoTIFF output, and the PCRT checkpoint must match the CPU oracle and
support resume. Lowering pipeline.PACK_MAX_BYTES forces the strip path
at test sizes.
"""

import os

import numpy as np
import pytest

import pcr_tpu as pcr
from pcr_tpu.engine import pipeline as pipeline_mod
from pcr_tpu.io.geotiff import read_geotiff_band
from conftest import make_grid_config, make_cloud

RT = pcr.ReductionType


def _run(gc, spec, clouds, mode, state_dir="", out="", resume=False):
    cfg = pcr.PipelineConfig(grid=gc, reductions=[spec], exec_mode=mode,
                             state_dir=state_dir, output_path=out,
                             resume=resume)
    p = pcr.Pipeline.create(cfg)
    for c in clouds:
        p.ingest(c)
    p.finalize()
    return p


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "strips"])
@pytest.mark.parametrize("with_state", [True, False],
                         ids=["state", "nostate"])
def test_finalize_path_matches_oracle(tmp_path, monkeypatch, packed,
                                      with_state):
    if not packed:
        # force strips
        monkeypatch.setattr(pipeline_mod, "PACK_MAX_BYTES", 10000)
    gc = make_grid_config(w=150.0, h=120.0)
    gc.tile_width = gc.tile_height = 64
    gc.compute_dimensions()
    spec = pcr.ReductionSpec(value_channel="v", type=RT.Average,
                             output_band_name="out")
    # cluster points left so some tiles stay untouched (NaN semantics)
    clouds = [make_cloud(5000, seed=s, w=90.0, h=120.0, channels=("v",))
              for s in (0, 1)]
    sd = str(tmp_path / "st") if with_state else ""
    out = str(tmp_path / "a.tif")
    p = _run(gc, spec, clouds, pcr.ExecutionMode.GPU, sd, out)
    jax_band = p.result().band_array(0)

    ref = _run(gc, spec, clouds, pcr.ExecutionMode.CPU).result()
    ref_band = ref.band_array(0)
    assert np.array_equal(np.isnan(jax_band), np.isnan(ref_band))
    tol = 0.0 if with_state else 1e-5   # host finalize == oracle bit-exact
    assert np.nanmax(np.abs(jax_band - ref_band)) <= tol

    tif = read_geotiff_band(out, 0)
    assert np.allclose(tif, jax_band, equal_nan=True)

    if with_state:
        # resume from the PCRT checkpoint alone reproduces the band
        p2 = _run(gc, spec, [], pcr.ExecutionMode.GPU, sd,
                  str(tmp_path / "b.tif"), resume=True)
        assert np.allclose(p2.result().band_array(0), jax_band,
                           equal_nan=True)


def test_streamed_state_multi_reduction(tmp_path, monkeypatch):
    """Two reductions with different state widths through the strip+state
    path: per-spec strip heights differ, checkpoints land per-spec."""
    monkeypatch.setattr(pipeline_mod, "PACK_MAX_BYTES", 10000)
    gc = make_grid_config(w=100.0, h=100.0)
    specs = [pcr.ReductionSpec(value_channel="v", type=RT.Average,
                               output_band_name="avg"),
             pcr.ReductionSpec(value_channel="v", type=RT.Max,
                               output_band_name="mx")]
    clouds = [make_cloud(4000, seed=3, w=100.0, h=100.0, channels=("v",))]
    cfg = pcr.PipelineConfig(grid=gc, reductions=specs,
                             exec_mode=pcr.ExecutionMode.GPU,
                             state_dir=str(tmp_path / "st"),
                             output_path=str(tmp_path / "o.tif"))
    p = pcr.Pipeline.create(cfg)
    p.ingest(clouds[0])
    p.finalize()
    ref = pcr.PipelineConfig(grid=gc, reductions=specs,
                             exec_mode=pcr.ExecutionMode.CPU)
    q = pcr.Pipeline.create(ref)
    q.ingest(clouds[0])
    q.finalize()
    for b in range(2):
        np.testing.assert_array_equal(p.result().band_array(b),
                                      q.result().band_array(b))
    assert os.path.isdir(str(tmp_path / "st"))


def test_gauss_corr_residue_flush():
    """Sub-cutoff Gaussian weight-sum residues (+-1e-12-scale float mass
    that no legitimate >=1e-6 deposit can leave) must finalize to the
    empty-cell NaN, while legit >=1e-6 deposits are untouched. Covers finalize_band, the strips/packed programs (via
    pipeline finalize), and fetch_state (PCRT checkpoints)."""
    gc = make_grid_config(w=16.0, h=16.0)
    spec = pcr.gaussian_splat_spec("v", default_sigma=1.0)
    cfg = pcr.PipelineConfig(grid=gc, reductions=[spec],
                             exec_mode=pcr.ExecutionMode.GPU)
    p = pcr.Pipeline.create(cfg)
    f0 = np.zeros((16, 16), np.float32)
    f1 = np.zeros((16, 16), np.float32)
    f1[2, 3] = 1e-12          # positive residue -> painted 0.0 w/o flush
    f0[2, 3] = -3e-13
    f1[5, 5] = 1e-6           # exactly the cutoff: legit, must survive
    f0[5, 5] = 2e-6
    f1[8, 8] = 0.5
    f0[8, 8] = 1.0
    p._engine.load_state(0, [f0, f1])
    p._touched_tiles.add((0, 0))
    p.finalize()
    band = p.result().band_array(0)
    assert np.isnan(band[2, 3])
    assert band[5, 5] == np.float32(2e-6) / np.float32(1e-6)
    assert band[8, 8] == np.float32(1.0) / np.float32(0.5)
    # checkpoint path flushes too
    st = p._engine.fetch_state(0)
    assert st[1][2, 3] == 0.0 and st[0][2, 3] == 0.0
    assert st[1][8, 8] == np.float32(0.5)
