#!/usr/bin/env python
"""
PCR-TPU benchmark — mirrors the reference harnesses on one NVIDIA GPU.

    python bench.py [--points N] [--repeats K] [--rows ROW ...]

Prints one line per row on stderr and, as the last line of stdout, one JSON
object {"metric": ..., "value": N, "unit": "Mpts/s", "vs_baseline": N,
"details": {...}, "device": {...}, "card": "<name>, <power limit>"}.
Exits non-zero when JAX finds no GPU: every Pipeline runs with
gpu_require_strict=True, so nothing falls back to the CPU.

Primary metric: the reference's GPU-Device mode, mirrored from
scripts/benchmarks/benchmark_cpu_gpu.py — 160x160 grid (1 m cells over a
160 m bbox), EPSG:32610, Average reduction, state_dir AND output_path set,
cloud staged on device before timing, ingest+finalize walled, best-of.
Reference: 54.02 Mpts/s @5M on an RTX 2060 (docs/BENCHMARK_RESULTS.md:37),
with 1M/10M/25M scaling rows (14.95 / 64.06 / 111.70).

Secondary rows: the benchmark_glyph_full.py suite (1000x1000 grid,
README.md:193-201) — point_host replicates its host-sourced definition
(H2D inside the timed region); the Gaussian sigma=1/4/16, rotated, and Line
hl=1/4/16 rows report the device-staged run on the same grid, each against
its reference GPU baseline. Device-staged rows also report the
device-accumulate rate (K ingests, then block_until_ready).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINES = {
    # GPU-Device rows measured by scripts/benchmarks/benchmark_cpu_gpu.py:
    # bbox 0..160 x 0..160 at 1 m cells (160x160 grid), EPSG:32610, Average,
    # state_dir + output_path set, cloud pre-staged on device
    # (docs/BENCHMARK_RESULTS.md:28-42). bench.py mirrors that harness
    # exactly for these rows.
    "point_device": 54.02,      # @5M, BENCHMARK_RESULTS.md:37
    "point_device_1m": 14.95,   # BENCHMARK_RESULTS.md:33
    "point_device_10m": 64.06,  # BENCHMARK_RESULTS.md:40
    "point_device_25m": 111.70, # BENCHMARK_RESULTS.md:42
    # Glyph rows measured by scripts/benchmarks/benchmark_glyph_full.py:
    # 1000x1000 grid, cloud in HOST memory (H2D inside the timed region),
    # README.md:193-201. point_host replicates that harness including the
    # transfer; the other glyph rows time the device-staged cloud on the
    # same grid (upload excluded, result D2H + GeoTIFF included).
    "point_host": 60.26,      # Point @5M GPU, README.md:195
    "point_1k_device": 60.26, # device-staged run of the same row
    "gauss_s1": 47.40,
    "gauss_s4": 21.59,
    "gauss_s16": 2.43,
    # Anisotropic rotated Gaussian: the reference has no rotated benchmark;
    # its window-loop kernel runs rotated at the same speed as unrotated,
    # so its sigma=4 number is the bar (README.md:200).
    "gauss_rot_s4": 21.59,
    "line_hl1": 50.60,
    "line_hl4": 50.41,
    "line_hl16": 46.61,
}

ROW_ORDER = list(BASELINES)


def make_grid(pcr, extent: float, epsg: int):
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y, bbox.max_x, bbox.max_y = 0.0, 0.0, extent, extent
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.crs = pcr.CRS.from_epsg(epsg)
    gc.compute_dimensions()
    return gc


def make_cloud(pcr, n: int, lo: float, hi: float, vmax: float, seed=42):
    rng = np.random.default_rng(seed)
    cloud = pcr.PointCloud.create(n)
    cloud.set_x_array(rng.uniform(lo, hi, n))
    cloud.set_y_array(rng.uniform(lo, hi, n))
    cloud.add_channel("value", pcr.DataType.Float32)
    cloud.set_channel_array_f32(
        "value", rng.uniform(0, vmax, n).astype(np.float32))
    return cloud


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--points", type=int, default=5_000_000)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--rows", nargs="*", default=ROW_ORDER,
                    choices=ROW_ORDER)
    args = ap.parse_args(argv)

    import jax

    import pcr_tpu as pcr
    from chip_smoke import card_info

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX found no GPU (default device: {dev.platform})",
              file=sys.stderr)
        return 1
    card = card_info() or "card not queried"
    n_pts, repeats = args.points, args.repeats
    tmp = tempfile.mkdtemp(prefix="pcr_bench_")
    gc = make_grid(pcr, 1000.0, 3857)
    cloud = make_cloud(pcr, n_pts, 0.0, 1000.0, 1.0)
    results = {}

    def timed_runs(pipe, src):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            pipe.ingest(src)
            pipe.finalize()
            best = min(best, time.perf_counter() - t0)
        return best

    def record(name, n, best, accum=None):
        mpts = n / best / 1e6
        d = {"mpts_per_s": mpts, "baseline": BASELINES[name],
             "vs_baseline": mpts / BASELINES[name]}
        if accum is not None:
            d["device_accumulate_mpts_per_s"] = accum
        results[name] = d
        print(f"# {name:16s} best {best:.4f} s  {mpts:.2f} Mpts/s  "
              f"(baseline {BASELINES[name]:.2f}, "
              f"x{mpts / BASELINES[name]:.2f})"
              + (f"  accum {accum:.2f}" if accum is not None else "")
              + f"  [{card}]", file=sys.stderr, flush=True)

    def create(grid, spec, mode, **kw):
        cfg = pcr.PipelineConfig(grid=grid, reductions=[spec],
                                 exec_mode=mode, gpu_require_strict=True,
                                 **kw)
        return pcr.Pipeline.create(cfg)

    def run(name, spec, host_sourced=False):
        # Host-sourced ingest pipelines routing/packing/upload across
        # chunks (Hybrid); device-staged runs pure GPU mode.
        pipe = create(gc, spec, pcr.ExecutionMode.Hybrid if host_sourced
                      else pcr.ExecutionMode.GPU,
                      output_path=os.path.join(tmp, f"{name}.tif"))
        src = cloud if host_sourced else pipe.stage(cloud)
        pipe.ingest(src)          # compile + warm
        pipe.finalize()
        best = timed_runs(pipe, src)
        accum = None
        if not host_sourced:
            # device-accumulate rate, amortized over K ingests
            K = 5
            t0 = time.perf_counter()
            for _ in range(K):
                pipe.ingest(src)
            pipe._engine.block_until_ready()
            accum = n_pts * K / (time.perf_counter() - t0) / 1e6
            pipe.finalize()
        record(name, n_pts, best, accum)

    def run_device_mirror(name, n):
        """The reference's GPU-Device mode: 160x160 grid (1 m cells over a
        160 m bbox), EPSG:32610, Average on 'value', state_dir +
        output_path set, cloud staged on device before timing
        (benchmark_cpu_gpu.py:46-90; docs/BENCHMARK_RESULTS.md:28-42)."""
        spec = pcr.ReductionSpec(value_channel="value",
                                 type=pcr.ReductionType.Average,
                                 output_band_name="out")
        pipe = create(make_grid(pcr, 160.0, 32610), spec,
                      pcr.ExecutionMode.GPU,
                      output_path=os.path.join(tmp, f"{name}.tif"),
                      state_dir=os.path.join(tmp, f"{name}_state"))
        staged = pipe.stage(make_cloud(pcr, n, 0.5, 159.5, 100.0))
        pipe.ingest(staged)
        pipe.finalize()
        record(name, n, timed_runs(pipe, staged))

    avg = lambda: pcr.ReductionSpec(value_channel="value",
                                    type=pcr.ReductionType.Average)
    gauss = pcr.gaussian_splat_spec
    line = pcr.line_splat_spec
    rows = {
        "point_device": lambda: run_device_mirror("point_device", n_pts),
        "point_device_1m":
            lambda: run_device_mirror("point_device_1m", 1_000_000),
        "point_device_10m":
            lambda: run_device_mirror("point_device_10m", 10_000_000),
        "point_device_25m":
            lambda: run_device_mirror("point_device_25m", 25_000_000),
        "point_host": lambda: run("point_host", avg(), host_sourced=True),
        "point_1k_device": lambda: run("point_1k_device", avg()),
        "gauss_s1": lambda: run(
            "gauss_s1", gauss("value", default_sigma=1.0)),
        "gauss_s4": lambda: run(
            "gauss_s4", gauss("value", default_sigma=4.0)),
        "gauss_s16": lambda: run(
            "gauss_s16", gauss("value", default_sigma=16.0)),
        "gauss_rot_s4": lambda: run(
            "gauss_rot_s4", gauss("value", default_sigma_x=4.0,
                                  default_sigma_y=1.5,
                                  default_rotation=0.6)),
        "line_hl1": lambda: run(
            "line_hl1", line("value", default_half_length=1.0)),
        "line_hl4": lambda: run(
            "line_hl4", line("value", default_half_length=4.0)),
        "line_hl16": lambda: run(
            "line_hl16", line("value", default_half_length=16.0)),
    }
    for name in ROW_ORDER:
        if name in args.rows:
            rows[name]()

    head = results.get("point_device", {}).get("mpts_per_s")
    print(json.dumps({
        "metric": ("Average-reduction ingest+finalize Mpts/s @5M pts, "
                   "GPU-Device harness mirror (160x160 grid, state_dir + "
                   "GeoTIFF output, cloud staged on device; "
                   "benchmark_cpu_gpu.py / BENCHMARK_RESULTS.md:37)"),
        "value": head,
        "unit": "Mpts/s",
        "vs_baseline": (head / BASELINES["point_device"]
                        if head is not None else None),
        "details": results,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
