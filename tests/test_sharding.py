"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

Validates that the shard_map ingest steps (dp over points x sp over grid
rows, with collectives) produce results identical to the single-device
oracle. Runs on 8 virtual CPU devices (conftest sets
xla_force_host_platform_device_count=8)."""

import numpy as np
import pytest

import pcr_tpu as pcr
from pcr_tpu.engine import cpu_backend as cpu
from pcr_tpu.ops.reduction import get_reduction_info
from pcr_tpu.parallel.sharding import (
    make_mesh, replicate_state, shard_points, sharded_gaussian_step,
    sharded_line_step, sharded_point_step,
)
from pcr_tpu.engine import routing
from conftest import make_grid_config

RT = pcr.ReductionType
H = W = 64
N = 4096


def point_data(seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, H, N).astype(np.int32)
    cols = rng.integers(0, W, N).astype(np.int32)
    valid = rng.random(N) > 0.1
    values = rng.normal(0, 1, N).astype(np.float32)
    weights = rng.uniform(0.1, 2.0, N).astype(np.float32)
    ts = rng.uniform(0, 100, N).astype(np.float32)
    return rows, cols, valid, values, weights, ts


def oracle(rtype, rows, cols, valid, values, weights, ts):
    info = get_reduction_info(rtype)
    state = info.init_state((H, W))
    flat = rows[valid].astype(np.int64) * W + cols[valid].astype(np.int64)
    cpu.accumulate_point_cpu(info, state, flat, values[valid],
                             weights[valid], ts[valid])
    return state


@pytest.fixture(scope="module")
def mesh():
    import jax
    assert len(jax.devices()) == 8, "expected 8 virtual devices"
    return make_mesh(dp=4, sp=2)


@pytest.mark.parametrize("rtype", [RT.Sum, RT.Average, RT.Count,
                                   RT.WeightedAverage, RT.Max, RT.Min,
                                   RT.MostRecent])
def test_point_step_matches_oracle(mesh, rtype):
    info = get_reduction_info(rtype)
    rows, cols, valid, values, weights, ts = point_data()
    expected = oracle(rtype, rows, cols, valid, values, weights, ts)

    step = sharded_point_step(info, H, W, mesh)
    states = replicate_state(mesh, info.init_state((H, W)), H, W)
    inputs = shard_points(mesh, rows, cols, valid, values, weights, ts)
    states = step(states, *inputs)
    for f in range(info.state_floats):
        got = np.asarray(states[f])
        if info.scatter_kind == "sum":
            # per-chip accumulation + psum tree reorders float adds
            np.testing.assert_allclose(got, expected[f], atol=1e-5)
        else:
            # max/min/argmax are order-insensitive: bit-exact
            assert np.array_equal(got, expected[f], equal_nan=True), \
                f"{rtype.name} field {f}"


def test_point_step_accumulates_across_steps(mesh):
    info = get_reduction_info(RT.Sum)
    step = sharded_point_step(info, H, W, mesh)
    states = replicate_state(mesh, info.init_state((H, W)), H, W)
    total = np.zeros((H, W), np.float32)
    for seed in range(3):
        rows, cols, valid, values, weights, ts = point_data(seed)
        expected = oracle(RT.Sum, rows, cols, valid, values, weights, ts)
        total += expected[0]
        inputs = shard_points(mesh, rows, cols, valid, values, weights, ts)
        states = step(states, *inputs)
    np.testing.assert_allclose(np.asarray(states[0]), total, atol=1e-5)


def test_gaussian_step_matches_oracle(mesh):
    gc = make_grid_config(w=float(W), h=float(H))
    rng = np.random.default_rng(3)
    n = 2048
    x = rng.uniform(0, W, n)
    y = rng.uniform(0, H, n)
    values = rng.normal(0, 1, n).astype(np.float32)
    spec = pcr.GlyphSpec(type=pcr.GlyphType.Gaussian, default_sigma_x=1.5,
                         default_sigma_y=1.5, max_radius_cells=6.0)
    info = get_reduction_info(RT.WeightedAverage)

    # oracle
    state = info.init_state((H, W))
    col, row, valid = routing.assign(gc, x, y)
    cpu.accumulate_gaussian_cpu(spec, RT.WeightedAverage, gc, state,
                                x, y, values, None, None, None, col, row)

    gp = routing.gaussian_params(spec, gc, x, y, None, None, None)
    step = sharded_gaussian_step(info, H, W, mesh, block=512)
    states = replicate_state(mesh, info.init_state((H, W)), H, W)
    inputs = shard_points(
        mesh, gp.icx, gp.icy, gp.sub_cx, gp.sub_cy, gp.sx, gp.sy, gp.r,
        np.ones(n, bool), values)
    states = step(states, *inputs)
    for f in range(2):
        np.testing.assert_allclose(np.asarray(states[f]), state[f],
                                   atol=2e-5)


def test_line_step_matches_oracle(mesh):
    """Rect-mode line splat over the mesh == CPU oracle (the line glyph
    decomposes into exact Bresenham-run rectangles on the host)."""
    gc = make_grid_config(w=float(W), h=float(H))
    rng = np.random.default_rng(4)
    n = 2048
    x = rng.uniform(0, W, n)
    y = rng.uniform(0, H, n)
    values = rng.normal(0, 1, n).astype(np.float32)
    dirs = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    spec = pcr.GlyphSpec(type=pcr.GlyphType.Line, default_half_length=4.0,
                         max_radius_cells=8.0)
    info = get_reduction_info(RT.Sum)

    state = info.init_state((H, W))
    col, row, valid = routing.assign(gc, x, y)
    cpu.accumulate_line_cpu(spec, RT.Sum, gc, state, x, y, values,
                            dirs, None, col, row)

    lp = routing.line_params(spec, gc, x, y, dirs, None)
    rects = routing.line_rects(lp, gc, valid, col, row)
    m = len(rects.ax)
    pad = (-m) % (512 * 8)     # per-dp-shard length divisible by block
    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])
    step = sharded_line_step(info, H, W, mesh, block=512)
    states = replicate_state(mesh, info.init_state((H, W)), H, W)
    inputs = shard_points(
        mesh, padded(rects.ax, 1), padded(rects.bx, 0),
        padded(rects.ay, 1), padded(rects.by, 0),
        padded(np.ones(m, bool), False),
        padded(values[rects.owner], 0.0))
    states = step(states, *inputs)
    np.testing.assert_allclose(np.asarray(states[0]), state[0], atol=1e-5)


def test_mesh_shapes():
    import jax
    m = make_mesh()
    assert m.shape["dp"] == 8 and m.shape["sp"] == 1
    m = make_mesh(sp=4)
    assert m.shape["dp"] == 2 and m.shape["sp"] == 4
    with pytest.raises(ValueError):
        make_mesh(dp=3)
