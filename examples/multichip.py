#!/usr/bin/env python
"""Multi-chip ingest example — dp (points) x sp (grid rows) mesh sharding.

Runs on a multi-GPU host or, for trying it out anywhere, on virtual CPU
devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py
"""

import numpy as np

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pcr_tpu as pcr  # noqa: E402
from pcr_tpu.engine import routing  # noqa: E402
from pcr_tpu.ops.reduction import get_reduction_info  # noqa: E402
from pcr_tpu.parallel.sharding import (  # noqa: E402
    make_mesh, replicate_state, shard_points, sharded_gaussian_step,
    sharded_point_step,
)


def main():
    import jax

    n_dev = len(jax.devices())
    sp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh = make_mesh(dp=n_dev // sp, sp=sp)
    print(f"mesh: dp={mesh.shape['dp']} x sp={mesh.shape['sp']} "
          f"({n_dev} devices)")

    H = W = 256
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0, 0, float(W), float(H)
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()

    rng = np.random.default_rng(0)
    N = 1 << 16
    x = rng.uniform(0, W, N)
    y = rng.uniform(0, H, N)
    values = rng.uniform(0, 1, N).astype(np.float32)
    col, row, valid = routing.assign(gc, x, y)

    # Point glyph: Average over the mesh
    info = get_reduction_info(pcr.ReductionType.Average)
    step = sharded_point_step(info, H, W, mesh)
    states = replicate_state(mesh, info.init_state((H, W)), H, W)
    inputs = shard_points(mesh, row.astype(np.int32), col.astype(np.int32),
                          valid, values, np.ones(N, np.float32),
                          np.zeros(N, np.float32))
    states = step(states, *inputs)
    cnt = np.asarray(states[1])
    occ = cnt > 0
    band = np.asarray(states[0])[occ] / cnt[occ]
    print(f"point Average: mean={band.mean():.4f} (expect ~0.5), "
          f"count={float(cnt.sum()):.0f}")

    # Gaussian glyph: separable matmul splat over the mesh
    spec = pcr.GlyphSpec(type=pcr.GlyphType.Gaussian, default_sigma_x=2.0,
                         default_sigma_y=2.0, max_radius_cells=6.0)
    gp = routing.gaussian_params(spec, gc, x, y, None, None, None)
    info_g = get_reduction_info(pcr.ReductionType.Sum)
    gstep = sharded_gaussian_step(info_g, H, W, mesh, block=512)
    gstates = replicate_state(mesh, info_g.init_state((H, W)), H, W)
    ginputs = shard_points(mesh, gp.icx, gp.icy, gp.sub_cx, gp.sub_cy,
                           gp.sx, gp.sy, gp.r, valid, values)
    gstates = gstep(gstates, *ginputs)
    print(f"gaussian Sum: total mass={float(np.asarray(gstates[0]).sum()):.1f}")


if __name__ == "__main__":
    main()
