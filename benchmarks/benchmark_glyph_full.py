#!/usr/bin/env python
"""
Full glyph benchmark sweep — the rebuild of the reference harness
(scripts/benchmarks/benchmark_glyph_full.py): glyph x footprint x N x mode,
1000x1000 grid, ingest+finalize timed (pipeline created before timing),
best-of-REPEATS, CSV output.

Usage:
    python benchmarks/benchmark_glyph_full.py --points 100000 1000000 \
        --modes cpu gpu --repeats 3 --csv results.csv

Modes: cpu (numpy oracle), gpu (device compute, host-sourced cloud),
gpu-staged (device compute, device-resident cloud — the reference's
"GPU-Device" analogue), hybrid (host routing pipelined with device
accumulation).
"""

import argparse
import csv
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import pcr_tpu as pcr  # noqa: E402


def make_grid(size=1000):
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, float(size), float(size)
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()
    return gc


def make_cloud(n, size, seed=42):
    rng = np.random.default_rng(seed)
    c = pcr.PointCloud.create(n)
    c.set_x_array(rng.uniform(0, size, n))
    c.set_y_array(rng.uniform(0, size, n))
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value", rng.uniform(0, 1, n).astype(np.float32))
    return c


def specs():
    def point():
        s = pcr.ReductionSpec()
        s.value_channel = "value"
        s.type = pcr.ReductionType.Average
        return s

    out = [("point", point())]
    for hl in (1.0, 4.0, 16.0):
        out.append((f"line_hl{hl:g}", pcr.line_splat_spec(
            "value", default_half_length=hl)))
    for s in (1.0, 4.0, 16.0):
        out.append((f"gauss_s{s:g}", pcr.gaussian_splat_spec(
            "value", default_sigma=s)))
    out.append(("gauss_rot_s4", pcr.gaussian_splat_spec(
        "value", default_sigma_x=4.0, default_sigma_y=1.5,
        default_rotation=0.6)))
    return out


MODES = {
    "cpu": (pcr.ExecutionMode.CPU, False),
    "gpu": (pcr.ExecutionMode.GPU, False),
    "gpu-staged": (pcr.ExecutionMode.GPU, True),
    "hybrid": (pcr.ExecutionMode.Hybrid, False),
}


def run_cell(gc, cloud, spec, mode_name, repeats, out_dir):
    exec_mode, staged_mode = MODES[mode_name]
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [spec]
    cfg.exec_mode = exec_mode
    # no state_dir: checkpointing would force the non-streamed finalize
    # (and per-repeat PCRT writes) into the timed window
    cfg.output_path = os.path.join(out_dir, "out.tif")
    pipe = pcr.Pipeline.create(cfg)
    src = pipe.stage(cloud) if staged_mode else cloud
    # warmup (includes compiles on the device modes)
    t0 = time.perf_counter()
    pipe.ingest(src)
    pipe.finalize()
    best = time.perf_counter() - t0
    for _ in range(repeats):
        t0 = time.perf_counter()
        pipe.ingest(src)
        pipe.finalize()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, nargs="+",
                    default=[100_000, 1_000_000, 5_000_000])
    ap.add_argument("--grid", type=int, default=1000)
    ap.add_argument("--modes", nargs="+", default=["gpu-staged"],
                    choices=list(MODES))
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repetitions per cell (best-of reported)")
    ap.add_argument("--glyphs", nargs="+", default=None,
                    help="subset of glyph labels to run")
    ap.add_argument("--csv", default="benchmark_glyph_results.csv")
    args = ap.parse_args()

    gc = make_grid(args.grid)
    rows = []
    bench_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pcr_bench_") as tmp:
        for n in args.points:
            cloud = make_cloud(n, args.grid)
            for label, spec in specs():
                if args.glyphs and label not in args.glyphs:
                    continue
                for mode_name in args.modes:
                    best = run_cell(gc, cloud, spec, mode_name,
                                    args.repeats, tmp)
                    mpts = n / best / 1e6
                    rows.append((label, n, mode_name, round(best, 4),
                                 round(mpts, 2)))
                    print(f"{label:12s} N={n:>9d} {mode_name:10s} "
                          f"best {best:8.3f}s  {mpts:8.2f} Mpts/s",
                          flush=True)

    header = ["glyph", "points", "mode", "best_seconds", "mpts_per_s"]
    # merge keyed by (glyph, points, mode): a partial re-run replaces only
    # its own rows
    merged = []
    if os.path.exists(args.csv):
        ran = {(r[0], str(r[1]), r[2]) for r in rows}
        with open(args.csv, newline="") as f:
            rd = csv.reader(f)
            next(rd, None)
            merged = [r for r in rd
                      if (r[0], r[1], r[2]) not in ran]
    merged.extend([list(map(str, r)) for r in rows])
    merged.sort(key=lambda r: (int(r[1]), header[0] != r[0]))
    with open(args.csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(merged)
    print(f"\nwrote {args.csv}  "
          f"(total {time.perf_counter() - bench_start:.0f}s)")


if __name__ == "__main__":
    main()
