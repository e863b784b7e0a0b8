#!/usr/bin/env python
"""Smoke test of pcr-tpu on an NVIDIA GPU, through the Pipeline entry points.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # four cards: the mesh path only

Each phase runs the user-facing `Pipeline` (create / stage / ingest /
finalize, Hybrid mode, out-of-core, resume) on the device and compares the
bands with the numpy CPU oracle (`ExecutionMode.CPU`): NaN (no-data) masks
identical, Count/Max/Min exact, every other band within atol = rtol = 1e-5.
Phases (one card):

  7. the card-marked tests (`pytest -m gpu tests/`), in a child process
     that runs before this process opens the card;
  1. device: JAX sees a GPU and the engine runs on it;
  2. DC-LiDAR-scale Point: 8000 x 8000 cells at 1 m in 2048-cell tiles,
     50M density-skewed points, Average + Max + Count from one read, PCRT
     state + GeoTIFF output, then a resumed Pipeline ingests 5M more;
  3. glyphs on bench.py's 1000 x 1000 grid: 5M staged points per case,
     timed; the oracle comparison uses a seeded subset;
  4. Hybrid host-sourced ingest of 20M points: Point Average and a
     Gaussian sigma=3 on the phase-2 grid;
  5. out-of-core: a gpu_memory_budget below the phase-2 state bands it;
  6. determinism: the same ingest twice, bit-identical or not (reported,
     never failed).

Every time printed carries the card's name and power limit. The last line
of stdout is one JSON object, printed only when every phase passed; any
failure exits non-zero. Each phase is a function of its sizes, so the CPU
tests run them at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ATOL = RTOL = 1e-5
EXACT_TYPES = ("Count", "Max", "Min")
CARD = "card not queried"


def card_info() -> str | None:
    """`name, power.limit` of every card from nvidia-smi, or None."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else None


def require(ok, msg) -> None:
    """A check that holds under `python -O` too (which strips asserts)."""
    if not ok:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, t0: float) -> float:
    dt = time.perf_counter() - t0
    log(f"  time {label}: {dt:.3f} s  [{CARD}]")
    return dt


# ---------------------------------------------------------------------------
# data and configuration
# ---------------------------------------------------------------------------

def make_grid(width: int, height: int | None = None, tile: int = 4096,
              epsg: int = 32110):
    import pcr_tpu as pcr
    bbox = pcr.BBox()
    bbox.min_x, bbox.min_y = 0.0, 0.0
    bbox.max_x, bbox.max_y = float(width), float(height or width)
    gc = pcr.GridConfig()
    gc.bounds = bbox
    gc.cell_size_x, gc.cell_size_y = 1.0, -1.0
    gc.tile_width = gc.tile_height = tile
    gc.crs = pcr.CRS.from_epsg(epsg)
    gc.compute_dimensions()
    return gc


def make_cloud(n: int, extent: float, seed: int, skew: bool = True,
               channels=()):
    """n points over [0, extent)^2 with an f32 'value' channel. With skew,
    40% of the points fall in 16 urban cores covering 2% of the area —
    about 20x the mean density there. `channels` maps extra channel names
    to (low, high) uniform ranges."""
    import pcr_tpu as pcr
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, extent, n)
    y = rng.uniform(0.0, extent, n)
    if skew and n:
        ncore = int(0.4 * n)
        centers = rng.uniform(0.1 * extent, 0.9 * extent, (16, 2))
        radius = extent * np.sqrt(0.02 / (16 * np.pi))
        k = rng.integers(0, 16, ncore)
        rr = radius * np.sqrt(rng.random(ncore))
        th = rng.uniform(0.0, 2 * np.pi, ncore)
        x[:ncore] = centers[k, 0] + rr * np.cos(th)
        y[:ncore] = centers[k, 1] + rr * np.sin(th)
    c = pcr.PointCloud.create(n)
    c.set_x_array(x)
    c.set_y_array(y)
    c.add_channel("value", pcr.DataType.Float32)
    c.set_channel_array_f32("value",
                            rng.uniform(0, 100, n).astype(np.float32))
    for name, (lo, hi) in dict(channels).items():
        c.add_channel(name, pcr.DataType.Float32)
        c.set_channel_array_f32(name,
                                rng.uniform(lo, hi, n).astype(np.float32))
    return c


def subset(cloud, n: int, seed: int):
    """A seeded n-point subset of a cloud (all channels)."""
    import pcr_tpu as pcr
    total = cloud.count()
    if n >= total:
        return cloud
    idx = np.sort(np.random.default_rng(seed).choice(total, n,
                                                     replace=False))
    c = pcr.PointCloud.create(n)
    c.set_x_array(cloud.x_array()[idx])
    c.set_y_array(cloud.y_array()[idx])
    for name in cloud.channel_names():
        c.add_channel(name, pcr.DataType.Float32)
        c.set_channel_array_f32(name, cloud.channel_array_f32(name)[idx])
    return c


def pipeline(gc, specs, mode=None, **kw):
    import copy

    import pcr_tpu as pcr
    mode = pcr.ExecutionMode.GPU if mode is None else mode
    cfg = pcr.PipelineConfig(grid=gc, reductions=copy.deepcopy(specs),
                             exec_mode=mode, gpu_require_strict=True, **kw)
    return pcr.Pipeline.create(cfg)


def check_device(eng, platform: str) -> None:
    """Assert every device an engine (pipe._engine) holds state on."""
    devs = [eng.device] if hasattr(eng, "device") else (
        [e.device for e in eng.engines] if hasattr(eng, "engines")
        else list(eng.mesh.devices.flat))
    got = {d.platform for d in devs}
    require(got == {platform}, f"engine runs on {got}, expected {platform}")


def oracle(gc, specs, clouds, **kw):
    """Bands of the CPU oracle pipeline after ingesting `clouds`."""
    import pcr_tpu as pcr
    p = pipeline(gc, specs, pcr.ExecutionMode.CPU, **kw)
    for c in clouds:
        p.ingest(c)
    p.finalize()
    return bands(p)


def bands(pipe):
    res = pipe.result()
    return [res.band_array(i) for i in range(len(pipe.config.reductions))]


def compare(label: str, specs, got, want) -> dict:
    """Assert the oracle bar band by band; returns the largest errors."""
    import pcr_tpu as pcr
    worst = {"max_abs": 0.0, "max_rel": 0.0}
    for spec, a, b in zip(specs, got, want):
        name = pcr.ReductionType(spec.type).name
        require(a.shape == b.shape, f"{label}/{name}: shape {a.shape} vs "
                f"{b.shape}")
        na, nb = np.isnan(a), np.isnan(b)
        mism = int((na != nb).sum())
        require(mism == 0, f"{label}/{name}: {mism} NaN-mask mismatches")
        m = ~nb
        diff = np.abs(a[m].astype(np.float64) - b[m].astype(np.float64))
        mag = np.abs(b[m].astype(np.float64))
        max_abs = float(diff.max()) if diff.size else 0.0
        max_rel = float((diff / np.maximum(mag, 1e-30)).max()) \
            if diff.size else 0.0
        log(f"  {label}/{name}: {int(m.sum())} cells, max abs err "
            f"{max_abs:.3e}, max rel err {max_rel:.3e}")
        if name in EXACT_TYPES:
            require(max_abs == 0.0, f"{label}/{name}: not exact ({max_abs})")
        else:
            excess = diff - (ATOL + RTOL * mag)
            require(not diff.size or float(excess.max()) <= 0.0,
                    f"{label}/{name}: {int((excess > 0).sum())} cells beyond "
                    f"atol=rtol={ATOL}")
        worst["max_abs"] = max(worst["max_abs"], max_abs)
        worst["max_rel"] = max(worst["max_rel"], max_rel)
    return worst


def point_specs():
    import pcr_tpu as pcr
    RT = pcr.ReductionType
    return [pcr.ReductionSpec(value_channel="value", type=t,
                              output_band_name=t.name.lower())
            for t in (RT.Average, RT.Max, RT.Count)]


def memory_report(eng, prefix: str) -> None:
    """compiled.memory_analysis() of each Point scatter program."""
    import jax
    import jax.numpy as jnp
    from pcr_tpu.engine import tpu_backend as tb
    for key, fn in list(eng._jits.items()):
        if key[0] != "point":
            continue
        _, info = eng.plans[key[1]]
        buf = jax.ShapeDtypeStruct((tb._point_nseg(info) * key[2],),
                                   jnp.int32)
        ma = fn.lower(eng._states[key[1]], buf).compile().memory_analysis()
        log(f"  {prefix} memory_analysis{key}: args "
            f"{ma.argument_size_in_bytes} B, out {ma.output_size_in_bytes} "
            f"B, temp {ma.temp_size_in_bytes} B")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_gpu_tests() -> dict:
    """7: the card-marked tests, in a child process that owns the card
    while it runs (this process has not opened it yet)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu",
                        "tests/", "-q", "-p", "no:cacheprovider"],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    tail = "\n".join(r.stdout.strip().splitlines()[-15:])
    log(tail)
    timed("pytest -m gpu", t0)
    require(r.returncode == 0, f"pytest -m gpu exited {r.returncode}")
    require(" passed" in r.stdout and " skipped" not in r.stdout,
            "card-marked tests did not all run")
    return {"rc": r.returncode}


def phase_device(platform: str = "gpu") -> dict:
    """1: JAX sees the card; a strict Pipeline's engine runs on it."""
    import jax
    import pcr_tpu as pcr
    from pcr_tpu import native
    d = jax.devices()[0]
    log(f"  jax {jax.__version__}: {len(jax.devices())} x {d.platform} "
        f"{d.device_kind}")
    log(f"  native.available(): {native.available()}")
    require(d.platform == platform, f"default device is {d.platform}")
    p = pipeline(make_grid(64), point_specs())
    check_device(p._engine, platform)
    p.ingest(make_cloud(1000, 64.0, seed=1))
    p.finalize()
    require(np.isfinite(p.result().band_array(0)).any(), "empty raster")
    return {"device_kind": d.device_kind, "count": len(jax.devices())}


def phase_point_dc(n_points: int = 50_000_000, n_resume: int = 5_000_000,
                   width: int = 8000, tile: int = 2048, workdir: str = "",
                   platform: str = "gpu", seed: int = 2) -> dict:
    """2: DC-LiDAR-scale Point gridding, three products from one read,
    PCRT state + GeoTIFF, then resume. Returns the first cloud and its
    oracle bands for phase 5."""
    workdir = workdir or tempfile.mkdtemp(prefix="pcr_smoke_dc_")
    gc = make_grid(width, tile=tile)
    specs = point_specs()
    t0 = time.perf_counter()
    cloud = make_cloud(n_points, float(width), seed)
    more = make_cloud(n_resume, float(width), seed + 1)
    timed(f"generate {n_points} + {n_resume} points", t0)

    dev_state = os.path.join(workdir, "dev_state")
    p = pipeline(gc, specs, state_dir=dev_state,
                 output_path=os.path.join(workdir, "dev.tif"))
    check_device(p._engine, platform)
    t0 = time.perf_counter()
    p.ingest(cloud)
    p._engine.block_until_ready()
    t_ing = timed(f"ingest {n_points} pts (route + stage + update)", t0)
    t0 = time.perf_counter()
    p.finalize()
    t_fin = timed("finalize (PCRT state + GeoTIFF)", t0)
    memory_report(p._engine, "phase2")
    got1 = bands(p)
    del p

    t0 = time.perf_counter()
    cpu_state = os.path.join(workdir, "cpu_state")
    want1 = oracle(gc, specs, [cloud], state_dir=cpu_state)
    timed("oracle ingest+finalize", t0)
    err1 = compare("dc", specs, got1, want1)
    del got1

    t0 = time.perf_counter()
    p2 = pipeline(gc, specs, state_dir=dev_state, resume=True,
                  output_path=os.path.join(workdir, "dev2.tif"))
    p2.ingest(more)
    p2.finalize()
    timed(f"resume + ingest {n_resume} pts + finalize", t0)
    want2 = oracle(gc, specs, [more], state_dir=cpu_state, resume=True)
    err2 = compare("dc_resume", specs, bands(p2), want2)
    log(f"  dc ingest rate: {n_points / t_ing / 1e6:.2f} Mpts/s, "
        f"ingest+finalize {n_points / (t_ing + t_fin) / 1e6:.2f} Mpts/s  "
        f"[{CARD}]")
    return {"cloud": cloud, "oracle": want1, "grid": gc,
            "err": max(err1["max_rel"], err2["max_rel"])}


def glyph_cases():
    """(name, spec, cells one point's footprint covers at most)."""
    import pcr_tpu as pcr
    g = pcr.gaussian_splat_spec
    ln = pcr.line_splat_spec
    win = lambda r: (2 * r + 1) ** 2
    return [
        ("point_avg", pcr.ReductionSpec(value_channel="value",
                                        type=pcr.ReductionType.Average), 1),
        ("gauss_s1", g("value", default_sigma=1.0), win(3)),
        ("gauss_s4", g("value", default_sigma=4.0), win(12)),
        ("gauss_s16", g("value", default_sigma=16.0), win(48)),
        ("gauss_rot_s4", g("value", default_sigma_x=4.0,
                           default_sigma_y=1.5, default_rotation=0.6),
         win(12)),
        ("gauss_perpoint", g("value", sigma_x_channel="sigma",
                             sigma_y_channel="sigma"), win(12)),
        ("line_hl1", ln("value", default_half_length=1.0), 4),
        ("line_hl4", ln("value", default_half_length=4.0), 10),
        ("line_hl16", ln("value", default_half_length=16.0), 34),
    ]


def phase_glyphs(n_points: int = 5_000_000, width: int = 1000,
                 oracle_budget: float = 5e8, max_oracle: int = 1_000_000,
                 platform: str = "gpu", seed: int = 3) -> dict:
    """3: every glyph on bench.py's grid. Timed: 5M points staged on the
    device (pipe.stage), ingest + block_until_ready, then finalize. Oracle:
    a seeded subset whose footprint work stays within `oracle_budget`
    cell evaluations."""
    gc = make_grid(width, epsg=3857)
    cloud = make_cloud(n_points, float(width), seed, skew=False,
                       channels={"sigma": (0.5, 4.0)})
    out = {}
    for name, spec, cells in glyph_cases():
        p = pipeline(gc, [spec])
        check_device(p._engine, platform)
        staged = p.stage(cloud)
        p.ingest(staged)                 # compile + warm
        p.finalize()
        t0 = time.perf_counter()
        p.ingest(staged)
        p._engine.block_until_ready()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        p.finalize()
        t_fin = time.perf_counter() - t0
        forms = sorted({c.key[0] for c in staged.per_spec[0]})
        log(f"  {name}: ingest {t_dev:.4f} s ({n_points / t_dev / 1e6:.2f} "
            f"Mpts/s), finalize {t_fin:.4f} s, programs {forms}  [{CARD}]")
        n_sub = int(min(max_oracle, oracle_budget / cells))
        sub = subset(cloud, n_sub, seed)
        got = pipeline(gc, [spec])
        got.ingest(sub)
        got.finalize()
        err = compare(f"{name}[{n_sub}]", [spec], bands(got),
                      oracle(gc, [spec], [sub]))
        out[name] = {"ingest_s": t_dev, "finalize_s": t_fin, **err}
    return out


def phase_hybrid(n_points: int = 20_000_000, width: int = 8000,
                 tile: int = 2048, n_oracle: int = 500_000,
                 platform: str = "gpu", seed: int = 4) -> dict:
    """4: host-sourced Hybrid ingest, Point Average + Gaussian sigma=3."""
    import pcr_tpu as pcr
    gc = make_grid(width, tile=tile)
    specs = [pcr.ReductionSpec(value_channel="value",
                               type=pcr.ReductionType.Average),
             pcr.gaussian_splat_spec("value", default_sigma=3.0)]
    cloud = make_cloud(n_points, float(width), seed)
    mode = pcr.ExecutionMode.Hybrid
    p = pipeline(gc, specs, mode)
    check_device(p._engine, platform)
    warm = subset(cloud, min(n_points, 1 << 21), seed)
    p.warmup(warm.count())
    t0 = time.perf_counter()
    p.ingest(cloud)
    p._engine.block_until_ready()
    t_ing = timed(f"hybrid ingest {n_points} pts (host-sourced)", t0)
    t0 = time.perf_counter()
    p.finalize()
    timed("hybrid finalize", t0)
    log(f"  hybrid rate: {n_points / t_ing / 1e6:.2f} Mpts/s  [{CARD}]")
    sub = subset(cloud, n_oracle, seed)
    got = pipeline(gc, specs, mode)
    got.ingest(sub)
    got.finalize()
    err = compare(f"hybrid[{n_oracle}]", specs, bands(got),
                  oracle(gc, specs, [sub]))
    return {"ingest_s": t_ing, **err}


def phase_out_of_core(n_points: int = 50_000_000, width: int = 8000,
                      tile: int = 2048, budget: int = 256 << 20,
                      cloud=None, want=None, platform: str = "gpu",
                      seed: int = 2) -> dict:
    """5: a gpu_memory_budget below the state bands the grid
    (OutOfCoreTpuEngine); compared with the oracle."""
    from pcr_tpu.engine.out_of_core import OutOfCoreTpuEngine
    gc = make_grid(width, tile=tile)
    specs = point_specs()
    if cloud is None:
        cloud = make_cloud(n_points, float(width), seed)
    state_bytes = 4 * 4 * gc.width * gc.height
    require(budget < state_bytes, f"budget {budget} >= state {state_bytes}")
    p = pipeline(gc, specs, gpu_memory_budget=budget)
    require(isinstance(p._engine, OutOfCoreTpuEngine), type(p._engine))
    check_device(p._engine._exec, platform)
    log(f"  out-of-core: state {state_bytes} B, budget {budget} B, "
        f"{p._engine.nbands} bands of {p._engine.band_rows} rows")
    t0 = time.perf_counter()
    p.ingest(cloud)
    p.finalize()
    t = timed(f"out-of-core ingest+finalize {cloud.count()} pts", t0)
    if want is None:
        want = oracle(gc, specs, [cloud])
    err = compare("out_of_core", specs, bands(p), want)
    return {"seconds": t, **err}


def phase_determinism(n_point: int = 25_000_000, point_width: int = 160,
                      n_gauss: int = 5_000_000, gauss_width: int = 1000,
                      seed: int = 5) -> dict:
    """6: the same ingest twice — Point Sum with heavy hot-cell contention,
    and Gaussian sigma=4. Reports bit-identity; never fails on it."""
    import pcr_tpu as pcr
    cases = [
        ("point_sum", make_grid(point_width, epsg=32610),
         pcr.ReductionSpec(value_channel="value", type=pcr.ReductionType.Sum),
         make_cloud(n_point, float(point_width), seed, skew=False)),
        ("gauss_s4", make_grid(gauss_width, epsg=3857),
         pcr.gaussian_splat_spec("value", default_sigma=4.0),
         make_cloud(n_gauss, float(gauss_width), seed + 1, skew=False)),
    ]
    out = {}
    for name, gc, spec, cloud in cases:
        runs = []
        for _ in range(2):
            p = pipeline(gc, [spec])
            p.ingest(cloud)
            p.finalize()
            runs.append(bands(p)[0])
        a, b = runs
        same = bool(np.array_equal(a, b, equal_nan=True))
        m = ~np.isnan(a)
        diff = float(np.abs(a[m] - b[m]).max()) if m.any() else 0.0
        log(f"  determinism {name}: bit-identical={same}, max diff "
            f"{diff:.3e}")
        out[name] = {"bit_identical": same, "max_diff": diff}
    return out


def phase_multi_device(n_cards: int = 4, width: int = 8000,
                       n_points: int = 10_000_000, n_gauss: int = 500_000,
                       n_line: int = 1_000_000, tile_multi: int = 2048,
                       platform: str = "gpu", seed: int = 6) -> dict:
    """--cards 4: the mesh path. A single-tile grid on dp x sp = 2 x 2 and
    1 x 4 (ShardedTpuEngine, psum/pmax merges) with Point Average + Max,
    Gaussian sigma=4 and Line hl=4; and the multi-tile phase-2 grid on
    row shards (PartitionedTpuEngine). Each against the oracle."""
    import jax

    import pcr_tpu as pcr
    from pcr_tpu.parallel.engine import (PartitionedTpuEngine,
                                         ShardedTpuEngine)
    devs = jax.devices()[:n_cards]
    require(len(devs) == n_cards, f"{len(jax.devices())} devices")
    RT = pcr.ReductionType
    single = make_grid(width, tile=8192)
    require(single.total_tiles() == 1, "grid is not single-tile")
    pts = make_cloud(n_points, float(width), seed)
    work = [
        ([pcr.ReductionSpec(value_channel="value", type=RT.Average),
          pcr.ReductionSpec(value_channel="value", type=RT.Max)], pts),
        ([pcr.gaussian_splat_spec("value", default_sigma=4.0)],
         subset(pts, n_gauss, seed)),
        ([pcr.line_splat_spec("value", default_half_length=4.0)],
         subset(pts, n_line, seed + 1)),
    ]
    half = max(n_cards // 2, 1)
    layouts = [(half, n_cards // half), (1, n_cards)]
    out = {}
    for specs, cloud in work:
        want = oracle(single, specs, [cloud])
        for dp, sp in layouts:
            p = pipeline(single, specs, mesh_devices=devs, mesh_dp=dp,
                         mesh_sp=sp)
            require(isinstance(p._engine, ShardedTpuEngine), type(p._engine))
            check_device(p._engine, platform)
            t0 = time.perf_counter()
            p.ingest(cloud)
            p._engine.block_until_ready()
            dt = time.perf_counter() - t0
            p.finalize()
            label = f"mesh{dp}x{sp}/{pcr.ReductionType(specs[0].type).name}" \
                f"/{pcr.GlyphType(specs[0].glyph.type).name}"
            log(f"  {label}: ingest {cloud.count()} pts {dt:.3f} s "
                f"(incl. compile)  [{CARD}]")
            out[label] = compare(label, specs, bands(p), want)
    multi = make_grid(width, tile=tile_multi)
    specs = point_specs()
    p = pipeline(multi, specs, mesh_devices=devs)
    require(isinstance(p._engine, PartitionedTpuEngine), type(p._engine))
    check_device(p._engine, platform)
    t0 = time.perf_counter()
    p.ingest(pts)
    p.finalize()
    timed(f"partitioned {n_cards} row shards ingest+finalize "
          f"{n_points} pts (incl. compile)", t0)
    out["partitioned"] = compare("partitioned", specs, bands(p),
                                 oracle(multi, specs, [pts]))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def run_phase(name, fn, failures, *args, **kw):
    log(f"[{name}]")
    t0 = time.perf_counter()
    try:
        res = fn(*args, **kw)
    except Exception:
        failures.append(name)
        log(f"  FAILED {name}:\n{traceback.format_exc()}")
        return None
    timed(f"phase {name}", t0)
    return res


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device path")
    args = ap.parse_args(argv)

    card = card_info()
    if card is None:
        log("chip_smoke: no NVIDIA GPU found (nvidia-smi failed); "
            "this smoke test needs a GPU")
        return 1
    lines = card.splitlines()
    CARD = lines[0] + (f" (x{len(lines)})" if len(lines) > 1 else "")
    log(f"card: {card}")
    try:
        import pcr_tpu  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: the pcr_tpu package is missing ({e}); run this "
            "script from the root of a checkout")
        return 1

    failures: list[str] = []
    if args.cards == 1:
        # before this process opens the card: one process per card
        run_phase("7 gpu tests", phase_gpu_tests, failures)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"chip_smoke: JAX found no GPU (default device: "
            f"{devs[0].platform}); this smoke test needs a GPU")
        return 1
    if len(devs) < args.cards:
        log(f"chip_smoke: --cards {args.cards} but JAX sees {len(devs)}")
        return 1

    workdir = tempfile.mkdtemp(prefix="pcr_smoke_")
    if args.cards == 4:
        run_phase("multi-device", phase_multi_device, failures, n_cards=4)
    else:
        run_phase("1 device", phase_device, failures)
        dc = run_phase("2 dc point", phase_point_dc, failures,
                       workdir=workdir)
        run_phase("3 glyphs", phase_glyphs, failures)
        run_phase("4 hybrid", phase_hybrid, failures)
        if dc is not None:
            run_phase("5 out-of-core", phase_out_of_core, failures,
                      cloud=dc["cloud"], want=dc["oracle"])
        else:
            run_phase("5 out-of-core", phase_out_of_core, failures)
        dc = None
        run_phase("6 determinism", phase_determinism, failures)
    shutil.rmtree(workdir, ignore_errors=True)

    if failures:
        log(f"chip_smoke: FAILED phases: {failures}")
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
