#!/usr/bin/env python
"""Time the two exact Gaussian forms (window and separable) on the device.

    python benchmarks/gauss_forms.py [--points N]

For each (grid width, sigma) case, stages N points once per form and times
`ingest(staged)` + `block_until_ready` (the median of 3 after a compile
run), with `tpu_backend.gauss_form` pinned to each form in turn. Per
point the window form updates (2r+1)^2 cells and the separable form
evaluates (1 + 2r/128) * width cells; the ratio of the two per-cell costs,

    (t_win / win_cells) / (t_sep / sep_cells),

is what `WINDOW_CELL_COST_CACHED` (states that fit in the card's L2 cache,
the 1000-wide cases) and `WINDOW_CELL_COST_UNCACHED` (the 8000-wide case)
encode.

Prints one line per case with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CASES = [(1000, 2.0), (1000, 4.0), (1000, 8.0), (1000, 16.0), (8000, 3.0)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=5_000_000)
    args = ap.parse_args(argv)

    import jax

    import chip_smoke as cs
    import pcr_tpu as pcr
    from pcr_tpu.engine import tpu_backend as tb

    card = cs.card_info() or "card unknown"
    if jax.devices()[0].platform != "gpu":
        print("gauss_forms: needs a GPU", file=sys.stderr)
        return 1
    choose = tb.gauss_form
    for width, sigma in CASES:
        gc = cs.make_grid(width, epsg=3857)
        cloud = cs.make_cloud(args.points, float(width), seed=7, skew=False)
        spec = pcr.gaussian_splat_spec("value", default_sigma=sigma)
        r = int(np.ceil(3 * sigma))
        cells = {"window": (2 * r + 1) ** 2,
                 "separable": (1 + 2 * r / tb.GAUSS_ROW_BLOCK) * width}
        per_cell = {}
        for form in ("window", "separable"):
            tb.gauss_form = lambda *a, f=form: f
            try:
                p = cs.pipeline(gc, [spec])
                staged = p.stage(cloud)
                p.ingest(staged)
                p._engine.block_until_ready()
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    p.ingest(staged)
                    p._engine.block_until_ready()
                    times.append(time.perf_counter() - t0)
                t = float(np.median(times))
            finally:
                tb.gauss_form = choose
            per_cell[form] = t / (args.points * cells[form])
            print(f"width {width} sigma {sigma:g} {form:9s}: "
                  f"{t:.4f} s ({args.points / t / 1e6:.2f} Mpts/s, "
                  f"{per_cell[form] * 1e12:.3f} ps/cell)  [{card}]",
                  flush=True)
            del p, staged
        ratio = per_cell["window"] / per_cell["separable"]
        state = 4 * 2 * width * width
        print(f"width {width} sigma {sigma:g}: window/separable per-cell "
              f"cost {ratio:.3f}; chosen: "
              f"{choose(False, [r], [sigma], [sigma], width, state)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
