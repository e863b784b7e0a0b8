#!/usr/bin/env python
"""Multi-chip weak/strong-scaling benchmark over the dp x sp mesh.

Runs the user-facing sharded Pipeline (PipelineConfig.mesh_devices /
mesh_dp / mesh_sp) at a ladder of device counts and records wall time,
library throughput, and parallel efficiency vs the 1-device run. The
reference is single-device (SURVEY.md section 2.7), so there is no
baseline to compare against — this records the scale-out headroom the
mesh path adds.

On a multi-GPU host the devices are the cards (collectives over NVLink);
anywhere else `--virtual N` runs N virtual CPU devices to exercise the
same code path (numbers then measure the sharding machinery, not
hardware):

    python benchmarks/benchmark_multichip.py --virtual 8 --points 2000000

Writes a CSV with one row per (devices, dp, sp, glyph) config.
"""

import argparse
import csv
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--virtual" in sys.argv:
    # must precede the first JAX backend initialization
    _n = int(sys.argv[sys.argv.index("--virtual") + 1])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={_n}")
    os.environ.setdefault("PCR_FORCE_JAX", "1")

import pcr_tpu as pcr  # noqa: E402


def make_cloud(n, size, rng):
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, size, n))
    c.set_y_array(rng.uniform(0, size, n))
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value", rng.uniform(0, 1, n).astype(np.float32))
    return c


def run_config(gc, cloud, spec, n_dev, dp, sp, repeats, force_mesh=False):
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [spec]
    cfg.exec_mode = pcr.ExecutionMode.GPU
    if n_dev > 1 or force_mesh:
        cfg.mesh_devices = n_dev
        cfg.mesh_dp, cfg.mesh_sp = dp, sp
    pipe = pcr.Pipeline.create(cfg)
    pipe.ingest(cloud)     # warm (compile)
    pipe.finalize()
    best = float("inf")
    for _ in range(repeats):
        p = pcr.Pipeline.create(cfg)
        t0 = time.perf_counter()
        p.ingest(cloud)
        p.finalize()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=2_000_000)
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--glyphs", nargs="+",
                    default=["point", "gauss", "max", "gauss_tiled"],
                    choices=["point", "gauss", "line", "max",
                             "point_tiled", "gauss_tiled", "max_tiled"])
    ap.add_argument("--tile", type=int, default=256,
                    help="tile size for the *_tiled configs (multi-tile "
                         "grids route to the partitioned per-shard "
                         "engines)")
    ap.add_argument("--virtual", type=int, default=0,
                    help="run on this many virtual CPU devices")
    ap.add_argument("--csv", default="")
    args = ap.parse_args()

    import jax
    n_total = len(jax.devices())
    ladder = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_total]
    print(f"{n_total} devices ({jax.devices()[0].platform}); "
          f"ladder {ladder}")

    def make_grid(tile):
        bbox = pcr.BBox()
        bbox.min_x, bbox.min_y = 0.0, 0.0
        bbox.max_x = bbox.max_y = float(args.grid)
        g = pcr.GridConfig()
        g.bounds = bbox
        g.cell_size_x, g.cell_size_y = 1.0, -1.0
        if tile:
            g.tile_width = g.tile_height = tile
        g.crs = pcr.CRS.from_epsg(3857)
        g.compute_dimensions()
        return g

    rng = np.random.default_rng(11)
    cloud = make_cloud(args.points, float(args.grid), rng)
    avg = lambda: pcr.ReductionSpec(value_channel="value",
                                    type=pcr.ReductionType.Average)
    mx = lambda: pcr.ReductionSpec(value_channel="value",
                                   type=pcr.ReductionType.Max)
    # name -> (spec factory, tile size; 0 = untiled). The *_tiled rows
    # exercise the partitioned per-shard engines, `max` the packed
    # flat-scatter fast path with kind-aware dp merge.
    configs = {
        "point": (avg, 0),
        "gauss": (lambda: pcr.gaussian_splat_spec(
            "value", default_sigma=2.0), 0),
        "line": (lambda: pcr.line_splat_spec(
            "value", default_half_length=4.0), 0),
        "max": (mx, 0),
        "point_tiled": (avg, args.tile),
        "max_tiled": (mx, args.tile),
        "gauss_tiled": (lambda: pcr.gaussian_splat_spec(
            "value", default_sigma=2.0), args.tile),
    }

    # Point-family walls are tens of ms at 500k — scheduler noise swings
    # the per-device fraction by tens of points — so the
    # overhead comparison uses a larger cloud for them (glyph configs
    # are compute-bound and already stable at the ladder size).
    ov_points = {"point": 4, "max": 4, "point_tiled": 4, "max_tiled": 4}

    rows = []
    for glyph in args.glyphs:
        spec_fn, tile = configs[glyph]
        gc = make_grid(tile)
        specs = {glyph: spec_fn()}
        ov_n = args.points * ov_points.get(glyph, 1)
        ov_cloud = (cloud if ov_n == args.points
                    else make_cloud(ov_n, float(args.grid),
                                    np.random.default_rng(12)))
        # per-device overhead: the sharded engine on a 1-device mesh vs
        # the single-device TpuEngine, same work — the fraction of
        # single-device throughput each mesh device retains
        w_single = run_config(gc, ov_cloud, specs[glyph], 1, 1, 1,
                              args.repeats)
        w_mesh1 = run_config(gc, ov_cloud, specs[glyph], 1, 1, 1,
                             args.repeats, force_mesh=True)
        frac = w_single / w_mesh1
        rows.append({"glyph": glyph, "devices": 1, "dp": 1, "sp": 1,
                     "wall_s": round(w_mesh1, 3),
                     "mpts_per_s": round(ov_n / w_mesh1 / 1e6, 2),
                     "speedup": "",
                     "parallel_efficiency": "",
                     "per_chip_vs_single": round(frac, 3)})
        print(f"{glyph:6s} per-chip overhead: sharded(1-dev mesh) "
              f"{w_mesh1:.3f}s vs TpuEngine {w_single:.3f}s -> "
              f"{100 * frac:.0f}% of single-chip throughput", flush=True)
        base = None
        for d in ladder:
            sp, dp = d, 1          # spatial-first: the host-routed fast
            dp = d // sp           # path is collective-free at dp=1
            wall = run_config(gc, cloud, specs[glyph], d, dp, sp,
                              args.repeats)
            mpts = args.points / wall / 1e6
            if base is None:
                base = wall
            eff = base / (wall * d)
            rows.append({"glyph": glyph, "devices": d, "dp": dp, "sp": sp,
                         "wall_s": round(wall, 3),
                         "mpts_per_s": round(mpts, 2),
                         "speedup": round(base / wall, 2),
                         "parallel_efficiency": round(eff, 2),
                         "per_chip_vs_single": ""})
            print(f"{glyph:6s} d={d:2d} (dp={dp} sp={sp})  "
                  f"wall {wall:7.3f}s  {mpts:7.2f} Mpts/s  "
                  f"speedup {base / wall:5.2f}  eff {eff:4.2f}", flush=True)

    if args.csv:
        # merge per glyph: re-running a subset replaces only its rows
        # (keyed by glyph name), keeping the rest of the record intact
        merged = []
        if os.path.exists(args.csv):
            with open(args.csv, newline="") as fh:
                ran = {r["glyph"] for r in rows}
                merged = [r for r in csv.DictReader(fh)
                          if r.get("glyph") not in ran]
        merged.extend(rows)
        with open(args.csv, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(merged)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
