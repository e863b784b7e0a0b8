#!/usr/bin/env python
"""Prove the persistent compile cache across PROCESSES.

Runs the same Pipeline.warmup in fresh subprocesses against the
billion-point grid shapes (4000x4000, 1 m cells, Average + chunked ingest
buckets), all pointed at one fresh cache directory through
JAX_COMPILATION_CACHE_DIR:

  run 1: cold  — empty cache directory
  run 2: warm  — same shapes, persistent cache populated by run 1
  run 3: warm  — repeat, to separate cache-hit cost from noise

Done = warm-process warmup in seconds, not minutes. Prints one JSON object
(and writes it to --json when given).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

CHILD = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import pcr_tpu as pcr

t_import = time.perf_counter()
bbox = pcr.BBox()
bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, 4000.0, 4000.0
gc = pcr.GridConfig()
gc.bounds = bbox
gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
gc.crs = pcr.CRS.from_epsg(32610)
gc.compute_dimensions()
cfg = pcr.PipelineConfig()
cfg.grid = gc
cfg.reductions = [pcr.ReductionSpec(value_channel="value",
                                    type=pcr.ReductionType.Average)]
cfg.exec_mode = pcr.ExecutionMode.GPU
pipe = pcr.Pipeline.create(cfg)
t0 = time.perf_counter()
pipe.warmup(chunk_points=2_000_000)
warm = time.perf_counter() - t0
print(f"WARMUP_S={{warm:.2f}} SETUP_S={{t0 - t_import:.2f}}")
"""


def run_child(cache):
    t0 = time.time()
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cache)
    r = subprocess.run([sys.executable, "-c", CHILD.format(repo=REPO)],
                       capture_output=True, text=True, timeout=3600,
                       env=env)
    wall = time.time() - t0
    warm = None
    for line in r.stdout.splitlines():
        if line.startswith("WARMUP_S="):
            warm = float(line.split("=")[1].split()[0])
    if warm is None:
        print(r.stdout[-2000:], r.stderr[-2000:], file=sys.stderr)
        raise SystemExit("child failed")
    return warm, wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default="", help="also write the result here")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="pcr_jax_cache_") as cache:
        out = {}
        w, wall = run_child(cache)
        out["cold_warmup_s"] = w
        out["cold_process_wall_s"] = wall
        for i in (1, 2):
            w, wall = run_child(cache)
            out[f"warm{i}_warmup_s"] = w
            out[f"warm{i}_process_wall_s"] = wall
    out["speedup"] = out["cold_warmup_s"] / max(out["warm1_warmup_s"], 1e-9)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
