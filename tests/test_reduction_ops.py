"""Reduction op algebra tests
(reference: tests/cpp/test_reduction_ops.cpp:14-397)."""

import math

import numpy as np
import pytest

import pcr_tpu as pcr
from pcr_tpu.ops.reduction import (
    FLT_MAX, get_reduction_info, is_registered, registered_reductions,
)

RT = pcr.ReductionType


def fold(info, values, **kw):
    s = tuple(info.op.identity)
    for i, v in enumerate(values):
        kwargs = {k: (a[i] if hasattr(a, "__len__") else a)
                  for k, a in kw.items()}
        s = info.op.combine(s, v, **kwargs)
    return s


class TestOpAlgebra:
    def test_sum(self):
        info = get_reduction_info(RT.Sum)
        assert info.op.identity == (0.0,)
        s = fold(info, [1.0, 2.0, 3.5])
        assert s == (6.5,)
        assert info.op.finalize(s) == 6.5
        assert info.op.finalize(info.op.identity) == 0.0   # empty sum is 0

    def test_max_empty_nan(self):
        info = get_reduction_info(RT.Max)
        assert math.isnan(info.op.finalize(info.op.identity))
        s = fold(info, [-5.0, 3.0, 1.0])
        assert info.op.finalize(s) == 3.0

    def test_min_empty_nan(self):
        info = get_reduction_info(RT.Min)
        assert math.isnan(info.op.finalize(info.op.identity))
        s = fold(info, [-5.0, 3.0, 1.0])
        assert info.op.finalize(s) == -5.0

    def test_count_empty_nan(self):
        info = get_reduction_info(RT.Count)
        assert math.isnan(info.op.finalize(info.op.identity))
        s = fold(info, [10.0, 20.0, 30.0])
        assert info.op.finalize(s) == 3.0   # value ignored

    def test_average(self):
        info = get_reduction_info(RT.Average)
        s = fold(info, [2.0, 4.0, 6.0])
        assert s == (12.0, 3.0)
        assert info.op.finalize(s) == 4.0
        assert math.isnan(info.op.finalize(info.op.identity))

    def test_weighted_average(self):
        info = get_reduction_info(RT.WeightedAverage)
        s = fold(info, [10.0, 20.0], weight=np.array([1.0, 3.0]))
        assert s == (70.0, 4.0)
        assert info.op.finalize(s) == pytest.approx(17.5)
        # unweighted combine defaults weight to 1.0 (builtin_ops.h:85-88)
        s = fold(info, [10.0, 20.0])
        assert s == (30.0, 2.0)

    def test_most_recent(self):
        info = get_reduction_info(RT.MostRecent)
        s = fold(info, [1.0, 2.0, 3.0], timestamp=np.array([5.0, 9.0, 7.0]))
        assert info.op.finalize(s) == 2.0
        # strictly-greater: equal timestamp does not replace
        s = info.op.combine(info.op.identity, 1.0, timestamp=5.0)
        s = info.op.combine(s, 99.0, timestamp=5.0)
        assert info.op.finalize(s) == 1.0

    def test_merge_associativity(self):
        rng = np.random.default_rng(3)
        for rt in (RT.Sum, RT.Max, RT.Min, RT.Count, RT.Average,
                   RT.WeightedAverage):
            info = get_reduction_info(rt)
            parts = []
            vals = rng.normal(0, 10, 30)
            for chunk in np.split(vals, 3):
                parts.append(fold(info, chunk))
            merged = parts[0]
            for p in parts[1:]:
                merged = info.op.merge(merged, p)
            whole = fold(info, vals)
            assert np.allclose(merged, whole)

    def test_most_recent_merge_tie_prefers_a(self):
        info = get_reduction_info(RT.MostRecent)
        a = (1.0, 5.0)
        b = (2.0, 5.0)
        assert info.op.merge(a, b) == a   # builtin_ops.h:118-120 (>= keeps a)
        assert info.op.merge(b, a) == b


class TestStateLayout:
    def test_state_floats(self):
        assert get_reduction_info(RT.Sum).state_floats == 1
        assert get_reduction_info(RT.Max).state_floats == 1
        assert get_reduction_info(RT.Average).state_floats == 2
        assert get_reduction_info(RT.WeightedAverage).state_floats == 2
        assert get_reduction_info(RT.MostRecent).state_floats == 2

    def test_init_state_identity(self):
        info = get_reduction_info(RT.Max)
        st = info.init_state((4, 4))
        assert len(st) == 1
        assert (st[0] == np.float32(-FLT_MAX)).all()
        info = get_reduction_info(RT.MostRecent)
        st = info.init_state((2, 2))
        assert np.isnan(st[0]).all()
        assert (st[1] == np.float32(-FLT_MAX)).all()


class TestRegistry:
    def test_registered_set(self):
        regs = registered_reductions()
        for rt in (RT.Sum, RT.Max, RT.Min, RT.Count, RT.Average,
                   RT.WeightedAverage, RT.MostRecent):
            assert rt in regs
        # Median/Percentile are TODO in the reference (registry.cpp:183-185)
        # but implemented here as collect-based order statistics
        assert is_registered(RT.Median)
        assert is_registered(RT.Percentile)
        assert get_reduction_info(RT.Median).scatter_kind == "collect"
        # PriorityMerge is TODO in the reference; implemented here as the
        # same deterministic argmax scatter as MostRecent
        assert is_registered(RT.PriorityMerge)
        assert get_reduction_info(RT.PriorityMerge).scatter_kind == "argmax_ts"
        assert not is_registered(RT.Custom)
        assert get_reduction_info(RT.Custom) is None


class TestFinalizeArrays:
    def test_average_empty_cells_nan(self):
        info = get_reduction_info(RT.Average)
        s = info.init_state((2, 2))
        s[0][0, 0] = 6.0
        s[1][0, 0] = 2.0
        out = info.finalize_arrays(s)
        assert out[0, 0] == 3.0
        assert np.isnan(out[0, 1])

    def test_max_identity_nan(self):
        info = get_reduction_info(RT.Max)
        s = info.init_state((1, 2))
        s[0][0, 0] = 5.0
        out = info.finalize_arrays(s)
        assert out[0, 0] == 5.0
        assert np.isnan(out[0, 1])

    def test_merge_arrays_matches_scalar(self):
        info = get_reduction_info(RT.MostRecent)
        a = [np.array([1.0, 3.0], np.float32), np.array([5.0, 2.0], np.float32)]
        b = [np.array([9.0, 7.0], np.float32), np.array([5.0, 8.0], np.float32)]
        v, t = info.merge_arrays(a, b)
        assert v.tolist() == [1.0, 7.0]   # tie keeps a; higher ts wins
        assert t.tolist() == [5.0, 8.0]


class TestCustomReduction:
    """User-provided ops via register_custom_reduction — the runtime
    analogue of the reference's compile-time template path
    (Accumulator::accumulate<Op>, accumulator.cpp:61-99; the type-erased
    registry returns nullptr for Custom, reduction_registry.h:75)."""

    @staticmethod
    def _register_sum_of_squares():
        from pcr_tpu.ops.reduction import register_custom_reduction
        register_custom_reduction(
            state_floats=2,
            identity=(0.0, 0.0),
            scatter_kind="sum",
            # (sum of v^2, count) -> RMS at finalize
            fields=lambda v, w, t: [v * v, v * 0 + 1.0],
            merge_arrays=lambda a, b: [a[0] + b[0], a[1] + b[1]],
            finalize_arrays=lambda f: (f[0] / f[1]) ** 0.5,
        )

    def test_register_validates(self):
        from pcr_tpu.ops.reduction import register_custom_reduction
        with pytest.raises(ValueError):
            register_custom_reduction(
                state_floats=2, identity=(0.0, 0.0), scatter_kind="max",
                fields=None, merge_arrays=None, finalize_arrays=None)
        with pytest.raises(ValueError):
            register_custom_reduction(
                state_floats=1, identity=(0.0,), scatter_kind="bogus",
                fields=None, merge_arrays=None, finalize_arrays=None)

    def test_custom_rms_all_engines(self):
        """RMS custom op: CPU oracle, JAX engine, and an 8-device mesh
        all agree with the closed-form expectation."""
        from pcr_tpu.ops.reduction import unregister_reduction
        from conftest import make_grid_config
        self._register_sum_of_squares()
        try:
            gc = make_grid_config(w=16.0, h=16.0)
            rng = np.random.default_rng(3)
            n = 4000
            c = pcr.PointCloud.create(n)
            x = rng.uniform(0, 16, n)
            y = rng.uniform(0, 16, n)
            c.set_x_array(x)
            c.set_y_array(y)
            c.add_channel("v", pcr.DataType.Float32)
            vals = rng.normal(0, 2, n).astype(np.float32)
            c.set_channel_array_f32("v", vals)

            def run(**kw):
                cfg = pcr.PipelineConfig(
                    grid=gc,
                    reductions=[pcr.ReductionSpec(value_channel="v",
                                                  type=RT.Custom)],
                    **kw)
                p = pcr.Pipeline.create(cfg)
                p.ingest(c)
                p.finalize()
                return p.result().band_array(0)

            # closed-form oracle
            col = np.clip(np.floor(x), 0, 15).astype(int)
            row = np.clip(np.floor((y - 16.0) / -1.0), 0, 15).astype(int)
            s = np.zeros((16, 16))
            k = np.zeros((16, 16))
            np.add.at(s, (row, col), (vals.astype(np.float64)) ** 2)
            np.add.at(k, (row, col), 1.0)
            want = np.where(k > 0, np.sqrt(s / np.maximum(k, 1)), np.nan)

            for kw in (dict(exec_mode=pcr.ExecutionMode.CPU),
                       dict(exec_mode=pcr.ExecutionMode.GPU),
                       dict(exec_mode=pcr.ExecutionMode.GPU,
                            mesh_devices=8, mesh_sp=2)):
                got = run(**kw)
                assert (np.isnan(got) == np.isnan(want)).all()
                m = ~np.isnan(want)
                np.testing.assert_allclose(got[m], want[m], atol=1e-4)
        finally:
            unregister_reduction(RT.Custom)
        assert pcr.get_reduction_info(RT.Custom) is None

    def test_reregistration_does_not_reuse_compiled_programs(self):
        """Two different custom ops with identical (type, state_floats)
        must not share cached compiled programs (round-5 review: the
        jit-namespace key now carries a per-registration token)."""
        from pcr_tpu.ops.reduction import (
            register_custom_reduction, unregister_reduction)
        from conftest import make_grid_config
        gc = make_grid_config(w=8.0, h=8.0)
        c = pcr.PointCloud.create(4)
        c.set_x_array(np.array([1.5, 1.5, 5.5, 6.5]))
        c.set_y_array(np.array([1.5, 1.5, 5.5, 6.5]))
        c.add_channel("v", pcr.DataType.Float32)
        c.set_channel_array_f32("v", np.array([2, 4, 8, 16], np.float32))

        def run():
            cfg = pcr.PipelineConfig(
                grid=gc,
                reductions=[pcr.ReductionSpec(value_channel="v",
                                              type=RT.Custom)],
                exec_mode=pcr.ExecutionMode.GPU)
            p = pcr.Pipeline.create(cfg)
            p.ingest(c)
            p.finalize()
            return p.result().band_array(0)

        try:
            register_custom_reduction(
                state_floats=1, identity=(0.0,), scatter_kind="sum",
                fields=lambda v, w, t: [v],
                merge_arrays=lambda a, b: [a[0] + b[0]],
                finalize_arrays=lambda f: f[0])
            a = run()
            unregister_reduction(RT.Custom)
            register_custom_reduction(
                state_floats=1, identity=(0.0,), scatter_kind="sum",
                fields=lambda v, w, t: [v * 10.0],
                merge_arrays=lambda a, b: [a[0] + b[0]],
                finalize_arrays=lambda f: f[0] + 100.0)
            b = run()
        finally:
            unregister_reduction(RT.Custom)
        assert a[6, 1] == 6.0          # op A: 2 + 4
        assert b[6, 1] == 160.0        # op B: (2+4)*10 + 100 — not A's
