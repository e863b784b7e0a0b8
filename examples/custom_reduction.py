#!/usr/bin/env python
"""User-defined reduction ops at runtime.

The reference ships only a stub here (examples/python/
custom_op_prototype.py is "# TODO: implement"; its Custom enum value is
reachable solely through the C++ compile-time template path,
accumulator.cpp:61-99). This build registers custom ops at runtime from
Python: define the op by its vectorized plan and it runs on the CPU
oracle, the device engine, and multi-device meshes alike.

Example: per-cell RMS (root mean square) of the point values —
state = (sum of v^2, count), finalized as sqrt(sum/count).

    python examples/custom_reduction.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import pcr_tpu as pcr

# --- register the op --------------------------------------------------------
pcr.register_custom_reduction(
    state_floats=2,
    identity=(0.0, 0.0),
    scatter_kind="sum",                       # each field scatter-ADDs
    fields=lambda v, w, t: [v * v, v * 0 + 1.0],
    merge_arrays=lambda a, b: [a[0] + b[0], a[1] + b[1]],
    finalize_arrays=lambda f: (f[0] / f[1]) ** 0.5,
)

# --- grid + cloud ------------------------------------------------------------
bbox = pcr.BBox()
bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, 200.0, 200.0
gc = pcr.GridConfig()
gc.bounds = bbox
gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
gc.crs = pcr.CRS.from_epsg(3857)
gc.compute_dimensions()

rng = np.random.default_rng(0)
n = 200_000
cloud = pcr.PointCloud.create(n)
cloud.set_x_array(rng.uniform(0, 200, n))
cloud.set_y_array(rng.uniform(0, 200, n))
cloud.add_channel("v", pcr.DataType.Float32)
cloud.set_channel_array_f32("v", rng.normal(0, 3, n).astype(np.float32))

# --- run ---------------------------------------------------------------------
cfg = pcr.PipelineConfig(
    grid=gc,
    reductions=[pcr.ReductionSpec(value_channel="v",
                                  type=pcr.ReductionType.Custom,
                                  output_band_name="rms")],
)
pipe = pcr.Pipeline.create(cfg)
pipe.ingest(cloud)
pipe.finalize()
band = pipe.result().band_array(0)

m = ~np.isnan(band)
print(f"RMS band: {m.sum()} populated cells, "
      f"mean RMS {band[m].mean():.3f} (values ~N(0,3) -> expect ~3)")

pcr.unregister_reduction(pcr.ReductionType.Custom)
