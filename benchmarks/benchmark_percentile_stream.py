#!/usr/bin/env python
"""Streaming Median/Percentile at 100M+ points with FLAT host RSS.

Order statistics would retain ~12 B/point in host RAM without a spill,
breaking the streaming contract. CollectStream spills sorted
runs at PCR_COLLECT_BUDGET and merges per cell range at finalize. This
bench streams a LAS directory through a Median pipeline, sampling host
RSS after every file; the artifact records peak vs budget.

    python benchmarks/benchmark_percentile_stream.py \
        --input /root/lidar100m --budget-mb 256 \
        --json benchmark_results/percentile_stream.json

Done = rss_peak_over_start_mb stays in the same ballpark as the collect
budget + pipeline state, not the ~1.2 GB the unspilled stream would need
at 100M points.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def rss_mb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--budget-mb", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=2_000_000)
    ap.add_argument("--cell", type=float, default=2.0)
    ap.add_argument("--json", default="")
    args = ap.parse_args()
    os.environ["PCR_COLLECT_BUDGET"] = str(args.budget_mb << 20)

    import pcr_tpu as pcr

    files = sorted(glob.glob(os.path.join(args.input, "*.las")))
    if not files:
        sys.exit(f"no LAS files in {args.input}")
    bb = pcr.BBox()
    for p in files:
        info = pcr.read_point_cloud_info(p)
        bb.expand(info.bounds)
    gc = pcr.GridConfig()
    gc.bounds = bb
    gc.cell_size_x, gc.cell_size_y = args.cell, -args.cell
    gc.crs = pcr.CRS.from_epsg(32110)
    gc.compute_dimensions()

    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [pcr.ReductionSpec(value_channel="z",
                                        type=pcr.ReductionType.Median,
                                        output_band_name="zmed")]
    cfg.exec_mode = pcr.ExecutionMode.CPU
    pipe = pcr.Pipeline.create(cfg)

    start_rss = rss_mb()
    peak = start_rss
    samples = []
    buf = pcr.PointCloud.create(args.chunk)
    t0 = time.perf_counter()
    done = 0
    for i, path in enumerate(files):
        reader = pcr.PointCloudReader.open(path)
        while not reader.eof():
            n = reader.read_chunk(buf, args.chunk)
            if n == 0:
                break
            pipe.ingest(buf)
            done += n
        r = rss_mb()
        peak = max(peak, r)
        if i % 20 == 0 or i == len(files) - 1:
            samples.append({"file": i, "pts_m": round(done / 1e6, 1),
                            "rss_mb": round(r, 1)})
            print(f"[{i:3d}/{len(files)}] {done/1e6:7.1f}M pts  "
                  f"rss {r:7.1f} MB  runs {pipe._collect[0].spilled_runs}",
                  flush=True)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.finalize()
    finalize_s = time.perf_counter() - t0
    peak = max(peak, rss_mb())
    band = pipe.result().band_array(0)
    out = {
        "points": done,
        "grid": [gc.width, gc.height],
        "budget_mb": args.budget_mb,
        "rss_start_mb": round(start_rss, 1),
        "rss_peak_mb": round(peak, 1),
        "rss_peak_over_start_mb": round(peak - start_rss, 1),
        "unspilled_stream_would_need_mb": round(done * 12 / 1e6, 1),
        "spilled_runs": pipe._collect[0].spilled_runs,
        "ingest_s": round(ingest_s, 1),
        "finalize_s": round(finalize_s, 1),
        "coverage_pct": round(100.0 * float(np.isfinite(band).mean()), 1),
        "samples": samples,
    }
    print(json.dumps({k: v for k, v in out.items() if k != "samples"},
                     indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
