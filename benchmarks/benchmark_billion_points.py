#!/usr/bin/env python
"""
Billion-point streaming benchmark — rebuild of
scripts/benchmarks/benchmark_billion_points.py:220-310: chunked ingest of an
arbitrarily large synthetic cloud through one Pipeline, with per-chunk
throughput, cumulative stats, and tile-state persistence. Chunks are
generated on the fly (no TB of RAM needed).

Usage:
    python benchmarks/benchmark_billion_points.py --total 1000000000 \
        --chunk 10000000 --grid 4000 --mode gpu
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import pcr_tpu as pcr  # noqa: E402
from pcr_tpu.utils.profiling import PhaseTimer  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--total", type=int, default=1_000_000_000)
    ap.add_argument("--chunk", type=int, default=10_000_000)
    ap.add_argument("--grid", type=int, default=4000)
    ap.add_argument("--mode", default="gpu",
                    choices=["cpu", "gpu", "hybrid"])
    ap.add_argument("--state-dir", default="",
                    help="persist PCRT tile state (checkpointed run); "
                         "empty = no checkpointing")
    ap.add_argument("--json", default="", help="write a stats artifact")
    args = ap.parse_args()

    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y = 0.0, 0.0
    bbox.max_x = bbox.max_y = float(args.grid)
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()

    spec = pcr.ReductionSpec()
    spec.value_channel = "value"
    spec.type = pcr.ReductionType.Average

    tmp = tempfile.mkdtemp(prefix="pcr_billion_")
    cfg = pcr.PipelineConfig()
    cfg.grid = gc
    cfg.reductions = [spec]
    cfg.exec_mode = {"cpu": pcr.ExecutionMode.CPU,
                     "gpu": pcr.ExecutionMode.GPU,
                     "hybrid": pcr.ExecutionMode.Hybrid}[args.mode]
    if args.state_dir:
        cfg.state_dir = args.state_dir
        shutil.rmtree(cfg.state_dir, ignore_errors=True)
    cfg.output_path = os.path.join(tmp, "billion.tif")

    pipe = pcr.Pipeline.create(cfg)
    t0 = time.perf_counter()
    # absorb one-time compile costs (reported separately)
    pipe.warmup(chunk_points=args.chunk)
    warm_s = time.perf_counter() - t0
    print(f"warmup {warm_s:.1f}s", flush=True)
    timer = PhaseTimer()
    rng = np.random.default_rng(7)
    cloud = pcr.PointCloud.create(args.chunk)
    cloud.add_channel("value", pcr.DataType.Float32)

    done = 0
    t_start = time.perf_counter()
    chunk_idx = 0
    while done < args.total:
        n = min(args.chunk, args.total - done)
        with timer.phase("generate"):
            cloud.set_x_array(rng.uniform(0, args.grid, n))
            cloud.set_y_array(rng.uniform(0, args.grid, n))
            cloud.set_channel_array_f32(
                "value", rng.uniform(0, 1, n).astype(np.float32))
            cloud.resize(n)
        with timer.phase("ingest"):
            pipe.ingest(cloud)
        done += n
        chunk_idx += 1
        elapsed = time.perf_counter() - t_start
        ingest_s = timer.seconds("ingest")
        print(f"chunk {chunk_idx:5d}  {done / 1e6:10.1f}M pts  "
              f"ingest {ingest_s:8.1f}s  "
              f"lib {done / max(ingest_s, 1e-9) / 1e6:7.2f} Mpts/s  "
              f"wall {done / elapsed / 1e6:7.2f} Mpts/s", flush=True)

    with timer.phase("finalize"):
        pipe.finalize()
    total = time.perf_counter() - t_start
    print("\n" + timer.report())
    print(f"\ntotal {done / 1e6:.0f}M points in {total:.1f}s wall "
          f"({done / total / 1e6:.2f} Mpts/s); "
          f"library throughput "
          f"{done / timer.seconds('ingest') / 1e6:.2f} Mpts/s")
    print(f"output: {cfg.output_path}")

    if args.json:
        import json
        with open(args.json, "w") as f:
            json.dump({
                "total_points": done, "chunk": args.chunk,
                "grid": [gc.width, gc.height], "mode": args.mode,
                "warmup_s": round(warm_s, 1),
                "wall_s": round(total, 1),
                "wall_mpts_per_s": round(done / total / 1e6, 2),
                "library_mpts_per_s": round(
                    done / timer.seconds("ingest") / 1e6, 2),
                "phases": timer.summary(),
            }, f, indent=2)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
