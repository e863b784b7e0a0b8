#!/usr/bin/env bash
# Run the benchmark suite on an NVIDIA GPU
# (reference: scripts/shell/run_benchmarks.sh).
#
#   scripts/run_benchmarks.sh [OUT_DIR]     # default: a new temporary dir
#
# Env knobs: PCR_BENCH_POINTS (glyph-sweep Ns), PCR_BENCH_REPEATS,
# PCR_BENCH_LIDAR_FILES (synthetic LAS tile count), PCR_SKIP_BENCH=1.
set -euo pipefail
cd "$(dirname "$0")/.."

OUT=${1:-$(mktemp -d)}
mkdir -p "$OUT"

if [ "${PCR_SKIP_BENCH:-0}" != "1" ]; then
  echo "== one-line JSON benchmark (bench.py) =="
  python bench.py | tee "$OUT/bench.json"
fi

echo "== glyph x mode sweep =="
# shellcheck disable=SC2086
python benchmarks/benchmark_glyph_full.py \
    --points ${PCR_BENCH_POINTS:-1000000 5000000} \
    --modes gpu-staged hybrid --repeats "${PCR_BENCH_REPEATS:-2}" \
    --csv "$OUT/glyph_sweep.csv"

echo "== LiDAR streaming mode comparison (synthetic LAS tiles) =="
LIDAR_DIR=$(mktemp -d)
python scripts/data/run_lidar_pipeline.py \
    --input "$LIDAR_DIR" --synthesize "${PCR_BENCH_LIDAR_FILES:-10}" \
    --pts-per-file 1000000 --cell 1.0 --modes cpu gpu hybrid \
    --out "$OUT/lidar.tif" \
    --csv "$OUT/mode_comparison.csv" \
    --stats-json "$OUT/lidar_stats.json"
rm -rf "$LIDAR_DIR"

echo "== multi-device dp x sp scaling (every GPU JAX sees) =="
python benchmarks/benchmark_multichip.py \
    --points "${PCR_BENCH_MESH_POINTS:-2000000}" \
    --glyphs point gauss --csv "$OUT/multichip.csv" \
    | tee "$OUT/multichip.log"
echo "results in $OUT"
