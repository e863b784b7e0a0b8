#!/usr/bin/env python
"""Visual demo: rasterize a smiley-face point cloud.

Analogue of the reference's visual demo family
(examples/python/smiley_face.py, smiley_face_large_test.py,
smiley_face_massive.py) collapsed into one script: `--points` and
`--size` scale it from a quick desktop render to a stress test.

Unlike the reference (which splats plain points), the face here
exercises the glyph engine: the outline is a ring of *line* glyphs
tangent to the circle, the eyes are *Gaussian* splats, and the smile is
an arc of line glyphs — so one image shows Point, Line, and Gaussian
paths composited into a single raster via three ReductionSpecs.

    python examples/smiley_face.py                  # 200k pts, 512^2
    python examples/smiley_face.py --points 5000000 --size 2048 --mode gpu
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import pcr  # noqa: E402


def ring(rng, n, cx, cy, radius, jitter):
    a = rng.uniform(0, 2 * np.pi, n)
    r = radius + rng.normal(0, jitter, n)
    return cx + r * np.cos(a), cy + r * np.sin(a), a


def blob(rng, n, cx, cy, spread):
    return (cx + rng.normal(0, spread, n), cy + rng.normal(0, spread, n))


def arc(rng, n, cx, cy, radius, a0, a1, jitter):
    a = rng.uniform(a0, a1, n)
    r = radius + rng.normal(0, jitter, n)
    return cx + r * np.cos(a), cy + r * np.sin(a), a


def build_cloud(n_total, world):
    """Face parts as (x, y, value, direction, half_length, sigma) arrays."""
    rng = np.random.default_rng(7)
    c = world / 2.0
    R = world * 0.38
    n_outline = n_total // 2
    n_eye = n_total // 8
    n_smile = n_total - n_outline - 2 * n_eye

    # outline: line glyphs tangent to the circle (direction = angle + 90 deg)
    ox, oy, oa = ring(rng, n_outline, c, c, R, world * 0.004)
    od = oa + np.pi / 2.0
    ohl = np.full(n_outline, world * 0.01)

    # eyes: gaussian blobs (sigma in world units)
    e_dx, e_dy = R * 0.42, R * 0.35
    lx, ly = blob(rng, n_eye, c - e_dx, c + e_dy, world * 0.01)
    rx, ry = blob(rng, n_eye, c + e_dx, c + e_dy, world * 0.01)

    # smile: lower arc, line glyphs along the tangent
    sx, sy, sa = arc(rng, n_smile, c, c, R * 0.62,
                     np.pi * 1.15, np.pi * 1.85, world * 0.004)
    sd = sa + np.pi / 2.0
    shl = np.full(n_smile, world * 0.008)

    x = np.concatenate([ox, lx, rx, sx])
    y = np.concatenate([oy, ly, ry, sy])
    n = x.size
    value = np.concatenate([np.full(n_outline, 1.0),
                            np.full(2 * n_eye, 3.0),
                            np.full(n_smile, 2.0)]).astype(np.float32)
    direction = np.concatenate([od, np.zeros(2 * n_eye), sd]) \
        .astype(np.float32)
    half_length = np.concatenate([ohl, np.zeros(2 * n_eye), shl]) \
        .astype(np.float32)
    sigma = np.zeros(n, np.float32)
    sigma[n_outline:n_outline + 2 * n_eye] = world * 0.012

    cloud = pcr.PointCloud.create(n)
    cloud.set_x_array(x)
    cloud.set_y_array(y)
    for name, arr in [("value", value), ("direction", direction),
                      ("half_length", half_length), ("sigma", sigma)]:
        cloud.add_channel(name, pcr.DataType.Float32)
        cloud.set_channel_array_f32(name, arr)
    # part masks so each spec only splats its own points
    part = np.zeros(n, np.float32)
    part[n_outline:n_outline + 2 * n_eye] = 1.0
    part[n_outline + 2 * n_eye:] = 2.0
    cloud.add_channel("part", pcr.DataType.Float32)
    cloud.set_channel_array_f32("part", part)
    return cloud


MODES = {"auto": "Auto", "cpu": "CPU", "gpu": "GPU", "hybrid": "Hybrid"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=200_000)
    ap.add_argument("--size", type=int, default=512,
                    help="output raster is SIZE x SIZE")
    ap.add_argument("--mode", default="auto", choices=list(MODES))
    ap.add_argument("--out", default="/tmp/pcr_smiley.tif")
    ap.add_argument("--png", default="/tmp/pcr_smiley.png")
    args = ap.parse_args()

    world = 1000.0
    gc = pcr.GridConfig()
    gc.bounds = pcr.BBox()
    gc.bounds.min_x = gc.bounds.min_y = 0.0
    gc.bounds.max_x = gc.bounds.max_y = world
    gc.cell_size_x = world / args.size
    gc.cell_size_y = -world / args.size
    gc.crs = pcr.CRS.from_epsg(3857)
    gc.compute_dimensions()

    cloud = build_cloud(args.points, world)

    # one filtered pipeline per face part (the Filter is pipeline-level,
    # matching the reference's PipelineConfig.filter): outline + smile go
    # through the Line glyph, eyes through the Gaussian glyph
    parts = [
        ("outline", 0.0, pcr.line_splat_spec(
            "value", direction_channel="direction",
            half_length_channel="half_length", output_band_name="outline")),
        ("eyes", 1.0, pcr.gaussian_splat_spec(
            "value", sigma_x_channel="sigma", sigma_y_channel="sigma",
            output_band_name="eyes")),
        ("smile", 2.0, pcr.line_splat_spec(
            "value", direction_channel="direction",
            half_length_channel="half_length", output_band_name="smile")),
    ]

    face = np.zeros((gc.height, gc.width), np.float32)
    t0 = time.perf_counter()
    for name, code, spec in parts:
        cfg = pcr.PipelineConfig()
        cfg.grid = gc
        cfg.reductions = [spec]
        cfg.filter.add("part", pcr.CompareOp.Equal, code)
        cfg.exec_mode = getattr(pcr.ExecutionMode, MODES[args.mode])
        if name == "outline":
            cfg.output_path = args.out
        pipe = pcr.Pipeline.create(cfg)
        pipe.ingest(cloud)
        pipe.finalize()
        band = pipe.result().band_array(0)
        m = np.isfinite(band)
        face[m] = np.maximum(face[m], band[m])
    dt = time.perf_counter() - t0

    cov = 100.0 * float((face > 0).mean())
    print(f"{cloud.count():,} pts -> {gc.width}x{gc.height} raster "
          f"in {dt:.2f}s ({cloud.count() / dt / 1e6:.2f} Mpts/s, "
          f"mode={args.mode}), face coverage {cov:.1f}%")
    print(f"GeoTIFF: {args.out}")

    try:
        from pcr_tpu.utils.visualization import save_png
        face[face == 0] = np.nan
        # vmin=0 keeps the lowest-valued part (the outline, value 1.0)
        # above the colormap's black end, so it stays visible on the
        # nodata background
        save_png(args.png, face, cmap="magma", vmin=0.0)
        print(f"PNG:     {args.png}")
    except Exception as e:  # PNG render is a nicety, not the demo
        print(f"(png render skipped: {e})")


if __name__ == "__main__":
    main()
