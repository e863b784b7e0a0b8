"""Device-located clouds auto-stage on ingest.

The reference's GPU-Device harness moves the cloud to the device once and
ingests it repeatedly (scripts/benchmark_cpu_gpu.py:49-66, PointCloud::to
in src/core/point_cloud.cpp:216-258); every ingest after the first is pure
device compute. Mirror: a cloud whose location() is Device is staged once
per Pipeline and cached by identity, so repeated ingests skip the transfer.
"""

import numpy as np

import pcr_tpu as pcr
from conftest import make_cloud, make_grid_config

RT = pcr.ReductionType


def _pipeline(gc, mode):
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
    cfg.exec_mode = mode
    return pcr.Pipeline.create(cfg)


def test_device_cloud_matches_host_cloud():
    gc = make_grid_config(w=100.0, h=100.0)
    cloud = make_cloud(2000, seed=7, w=100.0, h=100.0)

    host = _pipeline(gc, pcr.ExecutionMode.TPU)
    host.ingest(cloud)
    host.finalize()

    dev = _pipeline(gc, pcr.ExecutionMode.TPU)
    dcloud = cloud.to_device()
    assert dcloud.location() == pcr.MemoryLocation.Device
    dev.ingest(dcloud)
    dev.finalize()

    np.testing.assert_array_equal(host.result().band_array(0),
                                  dev.result().band_array(0))


def test_device_cloud_staged_once():
    gc = make_grid_config(w=100.0, h=100.0)
    p = _pipeline(gc, pcr.ExecutionMode.TPU)
    dcloud = make_cloud(1000, seed=3, w=100.0, h=100.0).to_device()
    p.ingest(dcloud)
    assert len(p._device_cloud_cache) == 1
    staged = p._device_cloud_cache[id(dcloud)][1]
    p.ingest(dcloud)                       # second ingest reuses the cache
    assert p._device_cloud_cache[id(dcloud)][1] is staged
    p.finalize()

    # oracle: same cloud ingested twice on the CPU path
    o = _pipeline(gc, pcr.ExecutionMode.CPU)
    host = dcloud.to_host()
    o.ingest(host)
    o.ingest(host)
    o.finalize()
    np.testing.assert_allclose(p.result().band_array(0),
                               o.result().band_array(0), rtol=1e-6)


def test_device_cloud_cpu_mode_still_works():
    # CPU backend has no staging; a Device-located cloud still rasterizes.
    gc = make_grid_config(w=50.0, h=50.0)
    p = _pipeline(gc, pcr.ExecutionMode.CPU)
    p.ingest(make_cloud(500, seed=1, w=50.0, h=50.0).to_device())
    p.finalize()
    assert np.nansum(p.result().band_array(0)) != 0.0
