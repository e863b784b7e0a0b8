"""Error handling & fallback ladder tests
(reference: tests/cpp/test_error_handling.cpp:43-301)."""

import numpy as np
import pytest

import pcr_tpu as pcr
from conftest import make_grid_config

RT = pcr.ReductionType


class TestDeviceProbes:
    def test_probes_run(self):
        # On the test harness JAX runs on CPU, so no accelerator device.
        assert pcr.tpu_is_compiled() in (True, False)
        assert pcr.tpu_device_count() >= 0
        assert isinstance(pcr.tpu_device_name(), str)


class TestDeviceCheck:
    def test_cpu_backend_reports_no_accelerator(self, monkeypatch):
        """The device check is a plain jax.devices() query: on the CPU
        backend it reports no accelerator, and GPU mode takes the
        documented CPU fallback with a GPU-worded warning (reference
        ladder: pipeline.cpp:113-214)."""
        monkeypatch.delenv("PCR_FORCE_JAX", raising=False)
        assert not pcr.tpu_device_available()
        assert pcr.tpu_device_count() == 0
        cfg = pcr.PipelineConfig(
            grid=make_grid_config(w=10.0, h=10.0),
            reductions=[pcr.ReductionSpec(value_channel="v", type=RT.Sum)],
            exec_mode=pcr.ExecutionMode.GPU)
        with pytest.warns(UserWarning, match="no GPU device available"):
            p = pcr.Pipeline.create(cfg)
        assert p._backend == "cpu"


class TestFallbackLadder:
    def test_gpu_mode_without_device_falls_back(self, monkeypatch):
        monkeypatch.delenv("PCR_FORCE_JAX", raising=False)
        gc = make_grid_config(w=10.0, h=10.0)
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
        cfg.exec_mode = pcr.ExecutionMode.GPU
        cfg.gpu_fallback_to_cpu = True
        with pytest.warns(UserWarning, match="falling back"):
            p = pcr.Pipeline.create(cfg)
        # still produces correct results on CPU
        c = pcr.PointCloud.create(1)
        c.set_x_array(np.array([5.0]))
        c.set_y_array(np.array([5.0]))
        c.add_channel("v", pcr.DataType.Float32)
        c.set_channel_array_f32("v", np.array([2.0], np.float32))
        p.ingest(c)
        p.finalize()
        # (5.0, 5.0) → col 5, row floor((5-10)/-1) = 5
        assert p.result().band_array(0)[5, 5] == 2.0

    def test_strict_mode_fails(self, monkeypatch):
        monkeypatch.delenv("PCR_FORCE_JAX", raising=False)
        gc = make_grid_config(w=10.0, h=10.0)
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
        cfg.exec_mode = pcr.ExecutionMode.GPU
        cfg.gpu_require_strict = True
        with pytest.raises(pcr.PcrError) as ei:
            pcr.Pipeline.create(cfg)
        assert ei.value.status.code == pcr.StatusCode.CudaError

    def test_no_fallback_no_strict_fails(self, monkeypatch):
        monkeypatch.delenv("PCR_FORCE_JAX", raising=False)
        gc = make_grid_config(w=10.0, h=10.0)
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
        cfg.exec_mode = pcr.ExecutionMode.GPU
        cfg.gpu_fallback_to_cpu = False
        with pytest.raises(pcr.PcrError):
            pcr.Pipeline.create(cfg)

    def test_auto_mode_without_device_uses_cpu(self, monkeypatch):
        monkeypatch.delenv("PCR_FORCE_JAX", raising=False)
        gc = make_grid_config(w=10.0, h=10.0)
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
        cfg.exec_mode = pcr.ExecutionMode.Auto
        p = pcr.Pipeline.create(cfg)   # no warning, silent CPU
        assert p._backend == "cpu"

    def test_hybrid_mode_resolves(self):
        gc = make_grid_config(w=10.0, h=10.0)
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
        cfg.exec_mode = pcr.ExecutionMode.Hybrid
        p = pcr.Pipeline.create(cfg)   # PCR_FORCE_JAX set by conftest
        assert p._backend == "jax"


class TestTypedStatusErrors:
    def test_invalid_grid_config(self):
        cfg = pcr.PipelineConfig()
        cfg.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
        with pytest.raises(pcr.PcrError) as ei:
            pcr.Pipeline.create(cfg)
        assert ei.value.status.code == pcr.StatusCode.InvalidArgument

    def test_crs_error_code(self):
        gc = make_grid_config(w=10.0, h=10.0)
        gc.crs = pcr.CRS()
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [pcr.ReductionSpec(value_channel="v", type=RT.Sum)]
        with pytest.raises(pcr.PcrError) as ei:
            pcr.Pipeline.create(cfg)
        assert ei.value.status.code == pcr.StatusCode.CrsError
