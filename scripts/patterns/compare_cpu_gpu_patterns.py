#!/usr/bin/env python
"""
CPU ↔ GPU numerical parity comparator — rebuild of
scripts/patterns/compare_cpu_gpu_patterns.py:28-95: compares GeoTIFF outputs
cell-by-cell with a tolerance, reporting max_diff / num_different and
PASS/FAIL per pattern.

Run generate_glyph_patterns.py with --mode cpu and --mode gpu into the same
directory first, then:

    python scripts/patterns/compare_cpu_gpu_patterns.py --dir /tmp/pcr_patterns
"""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
from pcr_tpu.io.geotiff import read_geotiff_band  # noqa: E402

# Tolerance: atol + rtol * |cpu| per cell. The reference uses 1e-4 absolute
# (compare_cpu_gpu_patterns.py:28-41); this build targets 1e-5
# (BASELINE.json north_star). Cells sitting exactly on the w >= 1e-6
# cutoff boundary divide by a near-zero accumulated weight (Average),
# which amplifies last-ulp arithmetic differences past any fixed bar —
# up to 0.005% of cells may fall back to the reference's 1e-4 bar, the
# NaN footprint must always match exactly.
ATOL = 1e-5
RTOL = 1e-5
ATOL_BOUNDARY = 1e-4
BOUNDARY_FRAC = 5e-5


def _nan_fringe(a):
    """Cells within one cell of a NaN (or the raster edge): where the
    w >= 1e-6 Average cutoff boundary lives — the only cells whose
    near-zero accumulated weight legitimately amplifies last-ulp
    arithmetic differences past the 1e-5 bar."""
    nanm = np.isnan(a)
    fringe = np.ones_like(nanm)
    fringe[1:-1, 1:-1] = False
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sl = np.roll(np.roll(nanm, dy, 0), dx, 1)
            fringe |= sl
    return fringe


def compare(cpu_path, gpu_path):
    a = read_geotiff_band(cpu_path, 0)
    b = read_geotiff_band(gpu_path, 0)
    if a.shape != b.shape:
        return False, f"shape mismatch {a.shape} vs {b.shape}"
    nan_mismatch = int((np.isnan(a) != np.isnan(b)).sum())
    m = np.isfinite(a) & np.isfinite(b)
    interior_bad = 0
    if m.any():
        diff = np.abs(a - b)
        tol = ATOL + RTOL * np.abs(a)
        bad = m & (diff > tol)
        nbad = int(bad.sum())
        nworse = int((m & (diff > ATOL_BOUNDARY
                           + RTOL * np.abs(a))).sum())
        max_diff = float(diff[m].max())
        allowed = max(1, int(BOUNDARY_FRAC * m.sum()))
        if nbad:
            # the allowance exists ONLY for cutoff-boundary cells:
            # any >tol cell away from the NaN fringe is a real defect
            interior_bad = int((bad & ~_nan_fringe(a)).sum())
    else:
        nbad = nworse = 0
        max_diff, allowed = 0.0, 1
    ok = (nan_mismatch == 0 and nworse == 0 and interior_bad == 0
          and (nbad == 0 or nbad <= allowed))
    return ok, (f"max_diff={max_diff:.2e} num_different={nbad} "
                f"nan_mismatch={nan_mismatch} "
                f"boundary_allowance={allowed} "
                f"interior_bad={interior_bad}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="/tmp/pcr_patterns")
    args = ap.parse_args()

    cpu_files = sorted(glob.glob(os.path.join(args.dir, "*_cpu.tif")))
    if not cpu_files:
        print(f"no *_cpu.tif files in {args.dir}; run "
              f"generate_glyph_patterns.py first", file=sys.stderr)
        sys.exit(2)
    failures = 0
    for cpu_path in cpu_files:
        gpu_path = cpu_path.replace("_cpu.tif", "_gpu.tif")
        name = os.path.basename(cpu_path)[: -len("_cpu.tif")]
        if not os.path.exists(gpu_path):
            print(f"{name:24s} SKIP (no gpu output)")
            continue
        ok, msg = compare(cpu_path, gpu_path)
        failures += (not ok)
        print(f"{name:24s} {'PASS' if ok else 'FAIL'}  {msg}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
