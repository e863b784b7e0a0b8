"""
Device backend — the JAX/XLA accelerated ingest path (ExecutionMode.GPU/Auto).

Every update is plain XLA, which on the GPU lowers `x.at[idx].add(...)` to
atomic scatter-adds — the design of the reference's CUDA kernels
(accumulator_kernels.cu:31-251, glyph_kernels.cu:145-279):

  * **Point glyph**: scatter (`state.at[cells].add/max/min`) on flat cell
    ids.
  * **Gaussian glyph**, two exact forms, chosen per cloud by `gauss_form`:
      - *window*: the reference's footprint loop — one scan step per window
        offset (dx, dy), each a masked scatter-add of every point's weight,
        including the reference's 1e-6 PRODUCT weight cutoff
        (glyph_kernels.cu:160-176). Handles rotation and per-point sigma.
      - *separable*: a rotation-free footprint factorises into row and
        column weight vectors, so a block of B points accumulates as one
        (TH x B) @ (B x W) product of "soft one-hots" after host row-block
        bucketing. Its per-axis 1e-6 masks equal the product cutoff only
        where `gauss_product_cutoff_bites` says the window cannot reach past
        the cutoff ellipse; elsewhere the window form runs.
  * **Line glyph**: vectorized Bresenham — all N lines advance one step per
    iteration (glyph_kernels.cu:252-279 semantics), then one scatter-add.
  * **Max/Min**: scatter-max/min. **MostRecent**: three-scatter argmax (max
    timestamp, then min point-index among ties, then value write), unlike
    the reference's CAS race (accumulator_kernels.cu:139-167).

Float sums reach a cell in an order the device picks: on the GPU atomics
reorder them between runs, so results agree to float tolerance, not bit for
bit (docs/ARCHITECTURE.md, "Determinism").

Coordinates never reach the device in float64: the host computes integer
cells + float32 sub-cell fractions in f64 numpy (routing.py), so the device
works purely in f32/i32.

Each chunk travels as ONE packed int32 buffer of a fixed bucket size;
invalid points are encoded in-band (cell == C for point glyphs, r == -1 for
Gaussians, sentinel endpoints for lines) so no mask array is transferred.
`prepare_*` stages chunks to the device without running compute (the
analogue of the reference's Device-resident clouds, BENCHMARK_RESULTS.md
"GPU-Device" mode); `commit` runs the jitted update.

All update functions are jitted once per (spec signature, chunk bucket) and
donate the state buffers, so ingest is pure device-resident accumulation.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..core.grid_config import GridConfig
from ..core.types import ReductionType
from ..ops.reduction import FLT_MAX, ReductionInfo

__all__ = ["TpuEngine", "bucket_size", "chunk_ranges", "CHUNK_BUCKETS",
           "enable_compilation_cache", "gauss_form", "StagedChunk"]

# Fixed chunk buckets: pad every ingest chunk up to one of these sizes so XLA
# compiles a bounded number of program shapes (reference analogue: the
# billion-point scripts chunk ingest; here chunking also pins static shapes).
# The ladder tops out at 2M points: compile time grows with program size and
# larger chunks don't help once transfers are amortised. Rungs are ~4x apart
# so a padded tail chunk wastes at most ~3x its size in transfer.
CHUNK_BUCKETS = (8_192, 65_536, 262_144, 1_048_576, 2_097_152)

_LINE_SENTINEL = np.int32(-(1 << 20))


def bucket_size(n: int) -> int:
    for b in CHUNK_BUCKETS:
        if n <= b:
            return b
    return CHUNK_BUCKETS[-1]


def chunk_ranges(n: int, cap: int | None = None):
    """Greedy split of n points into bucket-aligned (start, end) ranges:
    full max-size chunks, then one padded tail chunk. `cap` lowers the
    max chunk below the ladder top."""
    out = []
    start = 0
    top = CHUNK_BUCKETS[-1]
    if cap is not None:
        top = max(bucket_size(min(cap, top)), CHUNK_BUCKETS[0])
        if top > cap and top > CHUNK_BUCKETS[0]:
            top = CHUNK_BUCKETS[max(CHUNK_BUCKETS.index(top) - 1, 0)]
    while n - start >= top:
        out.append((start, start + top))
        start += top
    if n - start > 0 or n == 0:
        out.append((start, n))
    return out


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CACHE_READY = False


def compilation_cache_dir() -> str | None:
    """Where the program keeps JAX's persistent compilation cache: None when
    JAX_COMPILATION_CACHE_DIR is set (JAX reads that itself), else a fixed
    path inside the checkout. The path is part of the cache key, so it must
    not move between runs."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(REPO_ROOT, ".jax_cache")


def enable_compilation_cache():
    """Turn on JAX's persistent compilation cache (see
    compilation_cache_dir)."""
    global _CACHE_READY
    if _CACHE_READY:
        return
    import jax
    d = compilation_cache_dir()
    if d is not None:
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _CACHE_READY = True


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def start_d2h(arr) -> None:
    """Kick off an async device→host copy so the caller overlaps D2H with
    host-side work (encode, checkpoint writes)."""
    if hasattr(arr, "copy_to_host_async"):
        arr.copy_to_host_async()


# Jitted update programs shared across engine instances. Every builder is a
# pure function of (ReductionInfo singleton, grid geometry, static ints that
# already live in the chunk keys), so two pipelines with the same config can
# share one traced+compiled callable — without this, every new Pipeline
# re-traces its whole bucket ladder. Keyed by an engine "namespace"
# fingerprint; bounded LRU so long test sessions with hundreds of distinct
# tiny grids don't accumulate executables forever.
_SHARED_JITS: "OrderedDict[tuple, dict]" = OrderedDict()
_SHARED_JITS_CAP = 16


def _shared_jit_namespace(ns_key: tuple) -> dict:
    d = _SHARED_JITS.get(ns_key)
    if d is None:
        d = {}
        _SHARED_JITS[ns_key] = d
        while len(_SHARED_JITS) > _SHARED_JITS_CAP:
            _SHARED_JITS.popitem(last=False)
    else:
        _SHARED_JITS.move_to_end(ns_key)
    return d


# ---------------------------------------------------------------------------
# Update builders. Each consumes ONE packed int32 buffer and returns updated
# state tuples.
# ---------------------------------------------------------------------------


def _build_point_update(info: ReductionInfo, C: int):
    """Point glyph scatter; invalid points arrive as cell == C and drop."""
    jax, jnp = _jax()
    kind = info.scatter_kind

    def update(states, cells, values, weights, timestamps):
        fields = info.fields(values, weights, timestamps)
        if kind == "sum":
            return tuple(
                states[f].at[cells].add(fv.astype(jnp.float32), mode="drop")
                for f, fv in enumerate(fields))
        if kind == "max":
            return (states[0].at[cells].max(
                fields[0].astype(jnp.float32), mode="drop"),)
        if kind == "min":
            return (states[0].at[cells].min(
                fields[0].astype(jnp.float32), mode="drop"),)
        if kind == "argmax_ts":
            return _argmax_ts_update(states, cells, fields[0], fields[1], C)
        raise NotImplementedError(kind)

    return update


def _point_nseg(info: ReductionInfo) -> int:
    return 2 + (1 if info.uses_weight else 0) + (1 if info.uses_timestamp else 0)


def _build_point_update_packed(info: ReductionInfo, C: int, bucket: int):
    """Packed layout: [cells | values | (weights) | (timestamps)]."""
    jax, jnp = _jax()
    base = _build_point_update(info, C)
    nseg = _point_nseg(info)

    def update(states, buf):
        segs = [buf[i * bucket:(i + 1) * bucket] for i in range(nseg)]
        cells = segs[0]
        values = jax.lax.bitcast_convert_type(segs[1], jnp.float32)
        k = 2
        weights = None
        if info.uses_weight:
            weights = jax.lax.bitcast_convert_type(segs[k], jnp.float32)
            k += 1
        timestamps = None
        if info.uses_timestamp:
            timestamps = jax.lax.bitcast_convert_type(segs[k], jnp.float32)
        if weights is None:
            weights = jnp.ones_like(values)
        if timestamps is None:
            timestamps = jnp.full_like(values, -FLT_MAX)
        return base(states, cells, values, weights, timestamps)

    return update


def _argmax_ts_update(states, cells, values, ts, C):
    """Deterministic MostRecent scatter (see module docstring).

    Semantics match builtin_ops.h:114-116: a strictly greater timestamp
    replaces; among equal timestamps within the batch the earliest point
    wins; existing state wins ties against the batch. Invalid points arrive
    as cells == C and are dropped."""
    jax, jnp = _jax()
    cur_v, cur_t = states
    n = cells.shape[0]
    valid = cells < C
    safe = jnp.where(valid, cells, 0)
    ts = jnp.where(valid, ts, -FLT_MAX).astype(jnp.float32)
    values = values.astype(jnp.float32)
    m = jnp.full((C,), -FLT_MAX, jnp.float32).at[cells].max(ts, mode="drop")
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    big = jnp.int32(2**31 - 1)
    is_win = valid & (ts == m[safe]) & (ts > cur_t[safe])
    idx_masked = jnp.where(is_win, idx, big)
    widx = jnp.full((C,), big, jnp.int32).at[cells].min(idx_masked,
                                                        mode="drop")
    final = is_win & (idx == widx[safe])
    target = jnp.where(final, cells, C)
    new_v = cur_v.at[target].set(values, mode="drop")
    new_t = cur_t.at[target].set(ts, mode="drop")
    return (new_v, new_t)


def _build_point_update_grid(info: ReductionInfo, W: int, bucket: int,
                             with_f1: bool):
    """Sum-family Point update for grid-shaped (rows, W) states: packed
    layout [cells | f0 | (f1)], cells unpacked to (row, col) on device
    (native.pack_point_wire builds it in one host pass). Invalid/padding
    entries carry cell == C == H*W, which lands in the state's padding rows
    or is dropped."""
    jax, jnp = _jax()
    nf, _ = _glyph_nf(info)

    def update(states, buf):
        cells = buf[:bucket]
        f0 = jax.lax.bitcast_convert_type(buf[bucket:2 * bucket],
                                          jnp.float32)
        r = cells // W
        c = cells % W
        out0 = states[0].at[r, c].add(f0, mode="drop")
        if nf == 1:
            return (out0,)
        if with_f1:
            f1 = jax.lax.bitcast_convert_type(buf[2 * bucket:3 * bucket],
                                              jnp.float32)
        else:
            # Average: the count field gets 1 per entry; padding entries
            # land in the padding rows (or drop), so no mask is needed.
            f1 = jnp.ones_like(f0)
        return (out0, states[1].at[r, c].add(f1, mode="drop"))

    return update


# Every legitimate Gaussian deposit carries weight >= 1e-6 (the reference's
# product cutoff, glyph_kernels.cu:160); a weight-sum field below half of
# that is float residue, never a touched cell.
GAUSS_WMIN = np.float32(5e-7)


def gauss_state_flush(spec, info, fields, xp):
    """Zero sub-cutoff Gaussian weight sums (and their value sums) so the
    empty-cell NaN footprint is exact. Point/Line specs and Sum states
    pass through: user weight channels may legitimately be tiny, Line
    weights are >= 1, and Sum cells inside touched tiles are 0.0-filled
    rather than NaN (reference per-tile finalize semantics)."""
    from .glyph import GlyphType
    if GlyphType(spec.glyph.type) != GlyphType.Gaussian:
        return fields
    rtype = ReductionType(info.type)
    zero = xp.float32(0.0)
    if rtype in (ReductionType.Average, ReductionType.WeightedAverage):
        keep = fields[1] >= GAUSS_WMIN
        return [xp.where(keep, f, zero) for f in fields]
    if rtype == ReductionType.Count:
        keep = fields[0] >= GAUSS_WMIN
        return [xp.where(keep, fields[0], zero)]
    return fields


def _glyph_nf(info: ReductionInfo):
    rtype = ReductionType(info.type)
    nf = 2 if rtype in (ReductionType.WeightedAverage,
                        ReductionType.Average) else 1
    use_val = rtype != ReductionType.Count
    return nf, use_val


def _device_tile_clip(jnp, cfg: GridConfig, icx, icy):
    """Home-tile clip ranges derived on device from the (unclamped) center
    cell. The home tile is the tile of the *clamped* assigned cell
    (tile_router semantics), so clamp first.

    `cfg` may be a row-offset shard view (parallel.engine._LocalCfg with
    row_offset/global_height): tile rows are then computed in GLOBAL row
    coordinates and the returned rs/re are translated back to the view's
    local rows (possibly negative / beyond the local height — callers
    mask against local row iotas, so out-of-shard ranges clip to
    nothing)."""
    W = cfg.width
    off = getattr(cfg, "row_offset", 0)
    Hg = getattr(cfg, "global_height", cfg.height)
    tw, th = cfg.tile_width, cfg.tile_height
    col = jnp.clip(icx, 0, W - 1)
    grow = jnp.clip(icy + off, 0, Hg - 1)
    cs = (col // tw) * tw
    rs = (grow // th) * th
    ce = jnp.minimum(cs + tw, W)
    re = jnp.minimum(rs + th, Hg)
    return cs, ce, rs - off, re - off


def _build_sorted_matmul_update(info: ReductionInfo, cfg: GridConfig,
                                nsub: int, block: int, TH: int):
    """Separable Gaussian splat over row-block-sorted entries.

    The host buckets entries by TH-row block (halo-duplicating footprints
    that straddle blocks), so each device sub-chunk of `block` entries
    targets ONE row block: its factor product is (TH x B) @ (B x nf*W),
    and the result folds into the state with an in-place dynamic-update-
    slice. The product runs at Precision.HIGHEST: lower precisions admit
    TF32 on the GPU, whose ~1e-3 relative error breaks the 1e-5 bar.

    Packed layout: [icx | icy | sub_cx | sub_cy | sx | sy | r | f0] (each
    nsub x block) plus a (nsub,) row-block-id vector at the end. f0 is the
    per-point field-0 contribution (1.0 for Count, the value otherwise);
    the second field of Average/WeightedAverage is the raw glyph weight.
    Invalid/padding entries carry r == -1.
    """
    jax, jnp = _jax()
    H, W = cfg.height, cfg.width
    nf, _ = _glyph_nf(info)
    multi_tile = cfg.total_tiles() > 1
    nseg = 8
    n = nsub * block

    def update(states, buf):
        seg = lambda i: buf[i * n:(i + 1) * n].reshape(nsub, block)
        f32 = lambda i: jax.lax.bitcast_convert_type(seg(i), jnp.float32)
        icx, icy = seg(0), seg(1)
        sub_cx, sub_cy = f32(2), f32(3)
        sx, sy = f32(4), f32(5)
        r = seg(6)
        f0 = f32(7)
        bids = buf[nseg * n: nseg * n + nsub]

        ws = jax.lax.broadcasted_iota(jnp.float32, (1, W), 1)
        ws_i = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
        th_i = jax.lax.broadcasted_iota(jnp.int32, (1, TH), 1)

        def body(carry, args):
            bicx, bicy, bsub_cx, bsub_cy, bsx, bsy, br, bf0, bid = args
            row0 = bid * TH
            hs_i = th_i + row0
            hs = hs_i.astype(jnp.float32)
            rdy = (hs - bicy[:, None].astype(jnp.float32)) - bsub_cy[:, None]
            qy = rdy / bsy[:, None]
            wy = jnp.exp(-0.5 * qy * qy)
            my = (jnp.abs(hs_i - bicy[:, None]) <= br[:, None])
            my &= (wy >= 1e-6) & (hs_i < H)   # bottom block may overhang
            rdx = (ws - bicx[:, None].astype(jnp.float32)) - bsub_cx[:, None]
            qx = rdx / bsx[:, None]
            wx = jnp.exp(-0.5 * qx * qx)
            mx = (jnp.abs(ws_i - bicx[:, None]) <= br[:, None])
            mx &= wx >= 1e-6
            if multi_tile:
                cs, ce, rs, re = _device_tile_clip(jnp, cfg, bicx, bicy)
                my &= (hs_i >= rs[:, None]) & (hs_i < re[:, None])
                mx &= (ws_i >= cs[:, None]) & (ws_i < ce[:, None])
            wy = jnp.where(my, wy, 0.0)
            wx = jnp.where(mx, wx, 0.0)

            cols = [wx * bf0[:, None]]
            if nf == 2:
                cols.append(wx)
            colfac = (jnp.concatenate(cols, axis=1)
                      if len(cols) > 1 else cols[0])
            contrib = jax.lax.dot_general(
                wy, colfac, (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
            out = []
            for f in range(nf):
                cur = jax.lax.dynamic_slice(carry[f], (row0, 0), (TH, W))
                out.append(jax.lax.dynamic_update_slice(
                    carry[f], cur + contrib[:, f * W:(f + 1) * W],
                    (row0, 0)))
            return tuple(out), None

        states, _ = jax.lax.scan(
            body, states, (icx, icy, sub_cx, sub_cy, sx, sy, r, f0, bids))
        return states

    return update


GAUSS_ROW_BLOCK = 128          # TH: rows per block in the separable splat
_SUB_LADDER = (8, 32, 128, 512, 1024, 1536, 2048)  # nsub buckets (bounded jits)


def _nsub_bucket(k: int) -> int:
    for b in _SUB_LADDER:
        if k <= b:
            return b
    # Above the ladder, round to multiples of 256: keeps the jit-signature
    # count bounded at ~5% padding.
    return ((k + 255) // 256) * 256


def gauss_product_cutoff_bites(r, sx, sy) -> bool:
    """True when the square +-r window can contain cells that the
    reference's PRODUCT weight cutoff (w >= 1e-6, glyph_kernels.cu's
    `if (weight < 1e-6f) continue`) drops: the separable factorization
    can only mask per axis (wx >= 1e-6 AND wy >= 1e-6), so window
    corners with qx^2 + qy^2 > -2 ln(1e-6) would survive it wrongly.
    Worst case |dq| <= (r + 1)/sigma per axis (sub-cell offset < 1 cell);
    bites only for small sigma — the 3-sigma window stays inside the
    cutoff ellipse from about sigma >= 1.7."""
    qx = (np.asarray(r, np.float64) + 1.0) / np.maximum(
        np.abs(np.asarray(sx, np.float64)), 1e-30)
    qy = (np.asarray(r, np.float64) + 1.0) / np.maximum(
        np.abs(np.asarray(sy, np.float64)), 1e-30)
    return bool(np.any(qx * qx + qy * qy > 27.631021))


# Device cost of one window-form cell update (an atomic scatter-add into
# the state) in units of one separable-form cell evaluation (an exp, a mask
# and a multiply-add in the (TH x B) @ (B x W) product), measured by
# benchmarks/gauss_forms.py on an H100 (700 W): about 2 while the state
# fits in the card's 50 MB L2 cache, about 9 once the atomics go to HBM.
WINDOW_CELL_COST_CACHED = 2.0
WINDOW_CELL_COST_UNCACHED = 9.0
L2_CACHE_BYTES = 50 << 20


def gauss_form(rotated: bool, r, sx, sy, width: int,
               state_bytes: int) -> str:
    """Which exact Gaussian form a chunk runs: 'window' or 'separable'.

    Rotated footprints have no row/column factorization, and where the
    product cutoff bites the separable per-axis masks would keep cells the
    reference drops; both take the window form. Otherwise the cheaper form
    per point wins: the window form updates (2r+1)^2 cells of a state of
    `state_bytes`, the separable form evaluates a full grid row for every
    row block the footprint touches, (1 + 2r/GAUSS_ROW_BLOCK) * width
    cells."""
    if rotated or gauss_product_cutoff_bites(r, sx, sy):
        return "window"
    rmax = int(np.max(r)) if np.size(r) else 0
    cost = (WINDOW_CELL_COST_CACHED if state_bytes <= L2_CACHE_BYTES
            else WINDOW_CELL_COST_UNCACHED)
    window = cost * (2 * rmax + 1) ** 2
    separable = (1 + 2 * rmax / GAUSS_ROW_BLOCK) * width
    return "window" if window <= separable else "separable"


def _build_gaussian_window_update(info: ReductionInfo, cfg: GridConfig,
                                  bucket: int, rmax: int):
    """Exact Gaussian window splat: one scan step per window offset
    (dx, dy) in [-rmax, rmax]^2, each a masked scatter-add of every point's
    weight — the reference's footprint loop (glyph_kernels.cu:145-176),
    including rotation and the 1e-6 product cutoff. Masked entries get an
    out-of-range row and drop, so they touch no cell. Packed layout:
    [icx | icy | sub_cx | sub_cy | sx | sy | cos | sin | r | values];
    invalid points carry r == -1."""
    jax, jnp = _jax()
    H, W = cfg.height, cfg.width
    nf, use_val = _glyph_nf(info)
    multi_tile = cfg.total_tiles() > 1

    def update(states, buf):
        seg = lambda i: buf[i * bucket:(i + 1) * bucket]
        f32 = lambda i: jax.lax.bitcast_convert_type(seg(i), jnp.float32)
        icx, icy = seg(0), seg(1)
        sub_cx, sub_cy = f32(2), f32(3)
        sx, sy = f32(4), f32(5)
        cos_rot, sin_rot = f32(6), f32(7)
        r = seg(8)
        values = f32(9)
        if multi_tile:
            # clamp tile rows to the local grid: a row-offset shard view
            # can return negative rs
            cs, ce, rs, re = _device_tile_clip(jnp, cfg, icx, icy)
            rs = jnp.maximum(rs, 0)
            re = jnp.minimum(re, H)
        else:
            cs, ce, rs, re = 0, W, 0, H
        rows_out = states[0].shape[0]   # any row >= this drops

        def body(carry, offsets):
            dy, dx = offsets
            gy = icy + dy
            gx = icx + dx
            rdy = dy.astype(jnp.float32) - sub_cy
            rdx = dx.astype(jnp.float32) - sub_cx
            rdx_rot = rdx * cos_rot - rdy * sin_rot
            rdy_rot = rdx * sin_rot + rdy * cos_rot
            qx = rdx_rot / sx
            qy = rdy_rot / sy
            w = jnp.exp(-0.5 * (qx * qx + qy * qy))
            ok = ((w >= 1e-6)
                  & (jnp.abs(dy) <= r) & (jnp.abs(dx) <= r)
                  & (gx >= cs) & (gx < ce) & (gy >= rs) & (gy < re))
            gys = jnp.where(ok, gy, rows_out)
            f0 = values * w if use_val else w
            out = [carry[0].at[gys, gx].add(f0, mode="drop")]
            if nf == 2:
                out.append(carry[1].at[gys, gx].add(w, mode="drop"))
            return tuple(out), None

        k = 2 * rmax + 1
        dys = jnp.repeat(jnp.arange(-rmax, rmax + 1, dtype=jnp.int32), k)
        dxs = jnp.tile(jnp.arange(-rmax, rmax + 1, dtype=jnp.int32), k)
        states, _ = jax.lax.scan(body, tuple(states), (dys, dxs))
        return states

    return update


def _build_line_update(info: ReductionInfo, cfg: GridConfig, bucket: int,
                       max_steps: int):
    """Vectorized Bresenham line splat: all lines advance together, one
    masked scatter-add per step (glyph_kernels.cu:252-279 semantics).
    Packed layout: [ix0 | iy0 | ix1 | iy1 | (col | row) | values]; invalid
    points carry sentinel endpoints that never hit any cell. col/row (the
    clamped assigned cell, for home-tile clipping) are only packed for
    multi-tile grids."""
    jax, jnp = _jax()
    H, W = cfg.height, cfg.width
    C = H * W
    nf, use_val = _glyph_nf(info)
    multi_tile = cfg.total_tiles() > 1

    def update(states, buf):
        seg = lambda i: buf[i * bucket:(i + 1) * bucket]
        ix0, iy0, ix1, iy1 = seg(0), seg(1), seg(2), seg(3)
        k = 4
        if multi_tile:
            col, row = seg(4), seg(5)
            k = 6
            # col/row are the clamped assigned cell (except under a
            # row-offset shard view, where row is the local-shifted
            # global cell — _device_tile_clip reconstructs the frame).
            # Clamp the tile rows to the local grid: a shard view can
            # return negative rs, and a negative walk cell would WRAP
            # (numpy index semantics) instead of dropping.
            cs, ce, rs, re = _device_tile_clip(jnp, cfg, col, row)
            rs = jnp.maximum(rs, 0)
            re = jnp.minimum(re, H)
        else:
            cs, ce, rs, re = 0, W, 0, H
        values = jax.lax.bitcast_convert_type(seg(k), jnp.float32)

        s0 = states[0]
        s1 = states[1] if nf == 2 else None
        ddx = jnp.abs(ix1 - ix0)
        ddy = jnp.abs(iy1 - iy0)
        sx = jnp.where(ix0 < ix1, 1, -1).astype(jnp.int32)
        sy = jnp.where(iy0 < iy1, 1, -1).astype(jnp.int32)
        per_point_max = 2 * (ddx + ddy) + 2

        # Phase 1: the Bresenham walk only advances integer registers — no
        # state dependency — so collect every step's target cell and do ONE
        # scatter at the end (a sequential scatter per step would serialize
        # max_steps round trips through device memory).
        def walk(carry, step):
            cx, cy, err, done = carry
            active = (~done) & (step <= per_point_max)
            hit = (active & (cx >= cs) & (cx < ce) & (cy >= rs) & (cy < re))
            flat = jnp.where(hit, cy * W + cx, C)
            at_end = active & (cx == ix1) & (cy == iy1)
            done = done | at_end
            adv = active & (~at_end)
            e2 = 2 * err
            step_x = adv & (e2 > -ddy)
            step_y = adv & (e2 < ddx)
            err = err - jnp.where(step_x, ddy, 0) + jnp.where(step_y, ddx, 0)
            cx = cx + jnp.where(step_x, sx, 0)
            cy = cy + jnp.where(step_y, sy, 0)
            return (cx, cy, err, done), flat

        # done-init derives from ix0 so its mesh-variance matches the
        # carry output under shard_map (a constant zeros((n,), bool) is
        # axis-unvarying and trips the scan carry type check)
        init = (ix0, iy0, (ddx - ddy).astype(jnp.int32),
                ix0 != ix0)
        steps = jax.lax.broadcasted_iota(jnp.int32, (max_steps, 1), 0)[:, 0]
        _, flats = jax.lax.scan(walk, init, steps)   # (K, B)
        flat_all = flats.reshape(-1)
        if use_val:
            vals_all = jnp.broadcast_to(values[None, :],
                                        flats.shape).reshape(-1)
            s0 = s0.at[flat_all].add(vals_all, mode="drop")
        else:
            s0 = s0.at[flat_all].add(1.0, mode="drop")
        if s1 is not None:
            s1 = s1.at[flat_all].add(1.0, mode="drop")
        return (s0, s1) if nf == 2 else (s0,)

    return update


# ---------------------------------------------------------------------------
# Staged chunks
# ---------------------------------------------------------------------------

@dataclass
class StagedChunk:
    """One device-resident packed chunk plus the jit key that consumes it."""
    key: tuple
    buf: object          # jax.Array (nseg * bucket,) int32
    builder: object      # zero-arg callable building the update fn
    npoints: int


# ---------------------------------------------------------------------------
# TpuEngine — owns device state + compiled update functions for one pipeline
# ---------------------------------------------------------------------------

class TpuEngine:
    """Device-resident accumulation engine for one Pipeline run.

    One instance owns, per ReductionSpec, a tuple of float32 state arrays in
    device memory — flat (C,) for Point/Line scatter, grid-shaped (H_pad, W)
    for Gaussian splats — plus jit-compiled donated update functions keyed
    by chunk bucket.
    """

    def __init__(self, cfg: GridConfig, plans, device=None):
        import jax
        enable_compilation_cache()
        self.cfg = cfg
        self.plans = plans
        self.device = device or jax.devices()[0]
        self.H = cfg.height
        self.W = cfg.width
        self.C = self.H * self.W
        # Gaussian states are padded to a row-block multiple so the
        # separable splat's dynamic slices never clamp at the bottom edge.
        self.H_pad = ((self.H + GAUSS_ROW_BLOCK - 1)
                      // GAUSS_ROW_BLOCK) * GAUSS_ROW_BLOCK
        self._states = []
        self._grid_shaped = []
        # Everything a builder reads is captured here: grid geometry (the
        # builders' only cfg dependencies) and the per-spec ReductionInfo
        # singletons (keyed by type). Chunk keys carry the remaining statics
        # (bucket, rmax, ...), so (namespace, chunk key) fully determines
        # the traced program.
        b = cfg.bounds
        ns_key = (
            cfg.width, cfg.height, cfg.tile_width, cfg.tile_height,
            float(cfg.cell_size_x), float(cfg.cell_size_y),
            (float(b.min_x), float(b.min_y),
             float(b.max_x), float(b.max_y)) if b is not None else None,
            tuple((spec.glyph.type, info.type, info.state_floats,
                   info.scatter_kind, info.token)
                  for spec, info in plans),
            self.H_pad,
            # row-offset shard views (parallel.engine._LocalCfg) bake the
            # offset into tile-clip constants — distinct programs per shard
            getattr(cfg, "row_offset", 0),
            getattr(cfg, "global_height", cfg.height),
        )
        self._jits = _shared_jit_namespace(ns_key)
        # Lazy commit queue (PCR_LAZY_COMMIT=1): staged chunks accumulate
        # here and materialize at the next state access (or finalize).
        self._pending = []
        self._pending_cap = int(os.environ.get("PCR_PENDING_CAP", 12))
        from .glyph import GlyphType
        for spec, info in plans:
            self._pending.append([])
            # Gaussian splats run over (H_pad, W) states; everything else
            # uses flat scatter states.
            grid_shaped = GlyphType(spec.glyph.type) == GlyphType.Gaussian
            self._grid_shaped.append(grid_shaped)
            shape = (self.H_pad, self.W) if grid_shaped else (self.C,)
            st = tuple(
                jax.device_put(
                    np.full(shape, info.identity[f], dtype=np.float32),
                    self.device)
                for f in range(info.state_floats))
            self._states.append(st)

    # -- state access ---------------------------------------------------------

    def load_state(self, spec_idx: int, fields_hw) -> None:
        """Replace device state from host (H, W) field arrays (resume)."""
        import jax
        self._pending[spec_idx].clear()   # replaced wholesale
        _, info = self.plans[spec_idx]
        grid_shaped = self._grid_shaped[spec_idx]
        st = []
        for fi, f in enumerate(fields_hw):
            a = np.asarray(f, dtype=np.float32)
            if grid_shaped:
                full = np.full((self.H_pad, self.W), info.identity[fi],
                               np.float32)
                full[: self.H] = a
                a = full
            else:
                a = a.reshape(-1)
            st.append(jax.device_put(a, self.device))
        self._states[spec_idx] = tuple(st)

    def fetch_state(self, spec_idx: int):
        """Download state to host as a list of (H, W) float32 arrays."""
        self.flush_pending(spec_idx)
        spec, info = self.plans[spec_idx]
        if self._grid_shaped[spec_idx]:
            fields = [np.asarray(f)[: self.H] for f in self._states[spec_idx]]
        else:
            fields = [np.asarray(f).reshape(self.H, self.W)
                      for f in self._states[spec_idx]]
        return gauss_state_flush(spec, info, fields, np)

    def finalize_band(self, spec_idx: int) -> np.ndarray:
        """Finalize on device, fetch only the single output band (halves the
        device→host traffic for 2-field states)."""
        import jax
        self.flush_pending(spec_idx)
        spec, info = self.plans[spec_idx]
        key = ("finalize", spec_idx)
        fn = self._jits.get(key)
        if fn is None:
            import jax.numpy as jnp
            fn = jax.jit(lambda st: info.finalize_arrays(
                gauss_state_flush(spec, info, list(st), jnp)))
            self._jits[key] = fn
        band = np.asarray(fn(self._states[spec_idx]))
        if self._grid_shaped[spec_idx]:
            return band[: self.H]
        return band.reshape(self.H, self.W)

    # -- staging ------------------------------------------------------------------

    def _pack(self, bucket: int, segs) -> np.ndarray:
        """Pad each host segment (array, fill) to bucket length and
        concatenate as i32 (f32 segments are bit-viewed)."""
        out = np.empty(len(segs) * bucket, dtype=np.int32)
        for i, (arr, fill) in enumerate(segs):
            a = np.asarray(arr)
            if a.dtype == np.float32:
                a = a.view(np.int32)
                fill = np.float32(fill).view(np.int32) if fill else 0
            o = i * bucket
            m = len(a)
            out[o:o + m] = a
            out[o + m:o + bucket] = fill
        return out

    def _put(self, buf: np.ndarray):
        import jax
        return jax.device_put(buf, self.device)

    # -- row-block bucketing for the separable Gaussian splat -------------------

    def _bucket_rowblocks(self, blk0, blk1, block, seg_arrays):
        """Lay entries out row-block-contiguously.

        blk0/blk1: inclusive per-point target block ranges (halo); points
        spanning several blocks are duplicated. Each block's entry run is
        padded to a multiple of `block`. Returns (buf, nsub, E) where buf is
        the packed int32 buffer [seg0 | seg1 | ... | bids].

        seg_arrays: list of (array, fill) — gathered by entry, padded with
        fill (f32 arrays are bit-viewed into the i32 buffer)."""
        nblocks = self.H_pad // GAUSS_ROW_BLOCK
        n = len(blk0)
        k = (blk1 - blk0 + 1).astype(np.int64)
        if (k == 1).all():
            idx = None   # identity: slots index the source arrays directly
            eb = blk0.astype(np.int64)
        else:
            idx = np.repeat(np.arange(n, dtype=np.int64), k)
            starts = np.zeros(n, np.int64)
            np.cumsum(k[:-1], out=starts[1:])
            eb = blk0[idx] + (np.arange(len(idx), dtype=np.int64)
                              - np.repeat(starts, k))
        # _nsub_floor: the sharded engine forces a common nsub across sp
        # shards so per-shard buffers stack into one mesh array
        floor = getattr(self, "_nsub_floor", 1)
        from .. import native
        if native.available():
            # native counting-sort layout: one pass count + one pass place
            slots, bids, nsub = native.bucket_layout(
                eb, nblocks, block, False,
                lambda kk, f=floor: _nsub_bucket(max(kk, f)))
            sel = (np.maximum(slots, 0) if idx is None
                   else idx[np.maximum(slots, 0)])
            return self._pack_layout(sel, slots >= 0, bids, nsub,
                                     nsub * block, seg_arrays)

        # numpy fallback: per-block extraction for few blocks, stable
        # (radix) argsort otherwise
        if idx is None:
            idx = np.arange(len(eb), dtype=np.int64)
        if nblocks <= 16:
            per_block = [idx[eb == b] for b in range(nblocks)]
            idx_s = np.concatenate(per_block) if nblocks > 1 else idx
            counts = np.array([len(p) for p in per_block], dtype=np.int64)
        else:
            order = np.argsort(eb, kind="stable")
            idx_s = idx[order]
            counts = np.bincount(eb[order], minlength=nblocks)

        per_block_subs = (counts + block - 1) // block
        nsub_real = int(per_block_subs.sum())
        nsub = _nsub_bucket(max(nsub_real, 1, floor))
        E = nsub * block
        slots = np.full(E, -1, np.int64)
        bids = np.zeros(nsub, np.int32)
        pos = 0
        epos = 0
        for bidx in range(nblocks):
            c = int(counts[bidx])
            pc = int(per_block_subs[bidx]) * block
            if pc == 0:
                continue
            slots[epos:epos + c] = np.arange(pos, pos + c)
            bids[epos // block:(epos + pc) // block] = bidx
            pos += c
            epos += pc
        # trailing ladder-pad sub-chunks (all dead entries) extend the last
        # block's run
        if epos // block < nsub:
            bids[epos // block:] = bids[max(epos // block - 1, 0)]

        sel = idx_s[np.maximum(slots, 0)]
        return self._pack_layout(sel, slots >= 0, bids, nsub, E,
                                 seg_arrays)

    def _pack_layout(self, sel, live, bids, nsub, E, seg_arrays):
        all_live = bool(live.all())
        nseg = len(seg_arrays)
        buf = np.empty(nseg * E + nsub, dtype=np.int32)
        for i, (arr, fill) in enumerate(seg_arrays):
            a = np.asarray(arr)[sel]
            if not all_live:
                a = np.where(live, a, np.asarray(fill, a.dtype))
            if a.dtype != np.int32:
                a = (a.astype(np.float32).view(np.int32)
                     if a.dtype.kind == "f" else a.astype(np.int32))
            buf[i * E:(i + 1) * E] = a
        buf[nseg * E:] = bids
        return buf, nsub, E

    @staticmethod
    def _point_fields(info, values, weights, n):
        """Host-side field contributions (f0, f1|None) for sum-family ops."""
        rtype = ReductionType(info.type)
        values = np.asarray(values, dtype=np.float32)
        if rtype == ReductionType.Sum:
            return values, None
        if rtype == ReductionType.Count:
            return np.ones(n, np.float32), None
        if rtype == ReductionType.Average:
            # the count field is an implicit 1 per entry
            return values, None
        # WeightedAverage
        w = (np.asarray(weights, np.float32) if weights is not None
             else np.ones(n, np.float32))
        return values * w, w

    def prepare_point(self, spec_idx: int, cells, valid: np.ndarray,
                      values: np.ndarray, weights=None, timestamps=None,
                      col=None, row=None):
        """Stage Point-glyph chunks for the flat XLA scatter, invalid
        points encoded as cell == C. Callers pass flat `cells` or the
        assigned `col`/`row`."""
        _, info = self.plans[spec_idx]
        if cells is None:
            cells = row * np.int32(self.W) + col
        n = len(cells)
        cells = np.where(valid, cells, np.int32(self.C)).astype(np.int32)
        values = np.asarray(values, dtype=np.float32)
        staged = []
        for start, end in chunk_ranges(n):
            b = bucket_size(end - start)
            segs = [(cells[start:end], self.C), (values[start:end], 0)]
            if info.uses_weight:
                w = (np.asarray(weights[start:end], np.float32)
                     if weights is not None
                     else np.ones(end - start, np.float32))
                segs.append((w, 0))
            if info.uses_timestamp:
                t = (np.asarray(timestamps[start:end], np.float32)
                     if timestamps is not None
                     else np.full(end - start, -FLT_MAX, np.float32))
                segs.append((t, 0))
            key = ("point", spec_idx, b)
            builder = (lambda info=info, b=b:
                       _build_point_update_packed(info, self.C, b))
            staged.append(StagedChunk(key, self._put(self._pack(b, segs)),
                                      builder, end - start))
        return staged

    def prepare_point_grid(self, spec_idx: int, cells, valid, values,
                           weights=None, col=None, row=None):
        """Stage sum-family Point chunks for grid-shaped (H_pad, W) states
        (the mesh engines' local state blocks): [cells | f0 | (f1)], with
        the native library fusing flatten+sentinel+field+pad into one host
        pass when `col`/`row` are given."""
        from .. import native
        _, info = self.plans[spec_idx]
        n = len(cells) if cells is not None else len(col)
        rtype = ReductionType(info.type)
        mode = {ReductionType.Count: 1,
                ReductionType.WeightedAverage: 2}.get(rtype, 0)
        with_f1 = mode == 2
        staged = []

        def builder_for(b):
            return (lambda info=info, b=b, wf1=with_f1:
                    _build_point_update_grid(info, self.W, b, wf1))

        if col is not None and native.available():
            for start, end in chunk_ranges(n):
                b = bucket_size(end - start)
                buf = native.pack_point_wire(
                    col, row, valid, values, weights, start, end, b,
                    self.W, self.C, mode)
                staged.append(StagedChunk(
                    ("point_grid", spec_idx, b, with_f1), self._put(buf),
                    builder_for(b), end - start))
            return staged
        if cells is None:
            cells = row * np.int32(self.W) + col
        f0, f1 = self._point_fields(info, values, weights, n)
        cells = np.where(valid, cells, np.int32(self.C)).astype(np.int32)
        for start, end in chunk_ranges(n):
            b = bucket_size(end - start)
            segs = [(cells[start:end], self.C), (f0[start:end], 0)]
            if with_f1:
                segs.append((f1[start:end], 0))
            staged.append(StagedChunk(
                ("point_grid", spec_idx, b, with_f1),
                self._put(self._pack(b, segs)), builder_for(b),
                end - start))
        return staged

    def prepare_gaussian(self, spec_idx: int, gp, valid, values,
                         block: int = 4_096):
        """Stage Gaussian chunks (gp: routing.GaussianParams) for the form
        `gauss_form` picks (the mesh planner may pin it through
        `_gauss_form`, so every shard compiles the same program)."""
        _, info = self.plans[spec_idx]
        n = len(values)
        r = np.where(valid, gp.r, np.int32(-1)).astype(np.int32)
        values = np.asarray(values, dtype=np.float32)
        form = getattr(self, "_gauss_form", None) or gauss_form(
            bool(gp.rotated), r[valid], gp.sx[valid], gp.sy[valid], self.W,
            4 * info.state_floats * self.H_pad * self.W)
        if form == "window":
            staged = []
            for start, end in chunk_ranges(n):
                b = bucket_size(end - start)
                sl = slice(start, end)
                # _rmax_floor: the sharded engine forces a common rmax
                # across sp shards (the scan length feeds the jit key)
                rmax = max(int(r[sl].max()) if end > start else 0, 0,
                           getattr(self, "_rmax_floor", 0))
                segs = [(gp.icx[sl], 0), (gp.icy[sl], 0),
                        (gp.sub_cx[sl], 0), (gp.sub_cy[sl], 0),
                        (gp.sx[sl], 1.0), (gp.sy[sl], 1.0),
                        (gp.cos_rot[sl], 1.0), (gp.sin_rot[sl], 0),
                        (r[sl], -1), (values[sl], 0)]
                key = ("gauss_window", spec_idx, b, rmax)
                builder = (lambda info=info, b=b, rmax=rmax:
                           _build_gaussian_window_update(
                               info, self.cfg, b, rmax))
                staged.append(StagedChunk(
                    key, self._put(self._pack(b, segs)), builder,
                    end - start))
            return staged

        rtype = ReductionType(info.type)
        f0 = (np.ones(n, np.float32)
              if rtype == ReductionType.Count else values)
        segs = [(gp.icx, 0), (gp.icy, 0),
                (gp.sub_cx, 0), (gp.sub_cy, 0),
                (gp.sx, 1.0), (gp.sy, 1.0), (r, -1), (f0, 0)]
        TH = GAUSS_ROW_BLOCK
        nblocks = self.H_pad // TH
        icy = gp.icy.astype(np.int64)
        blk0 = np.where(valid, np.clip((icy - r) // TH, 0, nblocks - 1), 0)
        blk1 = np.where(valid, np.clip((icy + r) // TH, 0, nblocks - 1), 0)
        buf, nsub, E = self._bucket_rowblocks(blk0, blk1, block, segs)
        key = ("gauss_sorted", spec_idx, nsub, block, TH)
        builder = (lambda info=info, nsub=nsub, block=block, TH=TH:
                   _build_sorted_matmul_update(info, self.cfg, nsub, block,
                                               TH))
        return [StagedChunk(key, self._put(buf), builder, n)]

    def prepare_line(self, spec_idx: int, lp, valid, values, col, row):
        """Stage Line chunks (lp: routing.LineParams) for the vectorized
        Bresenham scatter."""
        _, info = self.plans[spec_idx]
        s = _LINE_SENTINEL
        ix0 = np.where(valid, lp.ix0, s).astype(np.int32)
        iy0 = np.where(valid, lp.iy0, s).astype(np.int32)
        ix1 = np.where(valid, lp.ix1, s).astype(np.int32)
        iy1 = np.where(valid, lp.iy1, s).astype(np.int32)
        values = np.asarray(values, dtype=np.float32)
        multi_tile = self.cfg.total_tiles() > 1
        staged = []
        for start, end in chunk_ranges(len(ix0)):
            b = bucket_size(end - start)
            sl = slice(start, end)
            segs = [(ix0[sl], s), (iy0[sl], s), (ix1[sl], s), (iy1[sl], s)]
            if multi_tile:
                segs += [(col[sl], 0), (row[sl], 0)]
            segs.append((values[sl], 0))
            key = ("line", spec_idx, b, lp.k_cells)
            builder = (lambda info=info, b=b, ms=lp.k_cells:
                       _build_line_update(info, self.cfg, b, ms))
            staged.append(StagedChunk(key, self._put(self._pack(b, segs)),
                                      builder, end - start))
        return staged

    # -- commit ----------------------------------------------------------------

    def commit(self, spec_idx: int, staged) -> None:
        """Dispatch the staged chunks' updates (device compute only).

        Dispatch is async, so committing eagerly starts device compute
        immediately and it overlaps the host's bookkeeping and the next
        chunk's routing. PCR_LAZY_COMMIT=1 queues instead until the next
        state access."""
        staged = list(staged)
        if not staged:
            return
        pend = self._pending[spec_idx]
        pend.extend(staged)
        if (os.environ.get("PCR_LAZY_COMMIT", "0") != "1"
                or len(pend) >= self._pending_cap):
            self.flush_pending(spec_idx)

    def flush_pending(self, spec_idx: int | None = None) -> None:
        """Materialize queued chunks: one jit call PER CHUNK, each keyed by
        the chunk's own (bucket-ladder) key, so the compiled-program set
        stays exactly the bucket ladder however a run was chunked."""
        import jax
        specs = (range(len(self.plans)) if spec_idx is None else [spec_idx])
        for i in specs:
            staged = self._pending[i]
            if not staged:
                continue
            self._pending[i] = []
            for chunk in staged:
                fn = self._jits.get(chunk.key)
                if fn is None:
                    fn = jax.jit(chunk.builder(), donate_argnums=(0,))
                    self._jits[chunk.key] = fn
                self._states[i] = fn(self._states[i], chunk.buf)

    def _state_planes(self, spec_idx: int, fields):
        """(H, W) views of a spec's state fields inside a jitted program."""
        if self._grid_shaped[spec_idx]:
            return [s[: self.H] for s in fields]
        return [s.reshape(self.H, self.W) for s in fields]

    def finalize_strips(self, spec_idx: int, strip_rows: int = 256,
                        with_state: bool = False):
        """Apply pending updates, finalize, slice the output into row
        strips, and start async D2H for every strip — ALL in one
        dispatch. Returns [(row0, row1, device_strip), ...]; the caller
        fetches strips in order (np.asarray) while later strips are still
        in flight, overlapping transfer with host-side encoding.

        Without `with_state` each strip is the finalized band, shape
        (rows, W).  With `with_state` each strip is the raw state fields
        stacked as (K, rows, W) — the caller host-finalizes (cheap) and
        writes PCRT checkpoints from the same bytes (reference flush_all +
        assemble is one pass too, pipeline.cpp:1154-1363)."""
        import jax
        spec, info = self.plans[spec_idx]
        # per-chunk dispatches keep the finalize program's key independent
        # of the pending-chunk history
        self.flush_pending(spec_idx)
        H = self.H
        ranges = [(a, min(a + strip_rows, H))
                  for a in range(0, H, strip_rows)]
        key = ("finstrips", spec_idx, strip_rows, with_state)
        fn = self._jits.get(key)
        if fn is None:
            import jax.numpy as jnp

            def combined(states):
                flds = gauss_state_flush(spec, info, list(states), jnp)
                if with_state:
                    planes = jnp.stack(self._state_planes(spec_idx, flds))
                    return states, tuple(planes[:, a:b] for a, b in ranges)
                band = self._state_planes(
                    spec_idx, [info.finalize_arrays(flds)])[0]
                return states, tuple(band[a:b] for a, b in ranges)

            fn = jax.jit(combined, donate_argnums=(0,))
            self._jits[key] = fn
        states, strips = fn(self._states[spec_idx])
        self._states[spec_idx] = states
        for s in strips:
            start_d2h(s)
        return [(a, b, s) for (a, b), s in zip(ranges, strips)]

    def finalize_packed_async(self, spec_idx: int, with_state: bool = False):
        """One fused dispatch: pending updates + finalize, returning a
        single stacked device array whose D2H is already initiated.

        Shape (1, H, W) = just the band, or (K, H, W) = the raw state
        fields when `with_state` (the caller host-finalizes)."""
        import jax
        import jax.numpy as jnp
        spec, info = self.plans[spec_idx]
        self.flush_pending(spec_idx)
        key = ("finpack", spec_idx, with_state)
        fn = self._jits.get(key)
        if fn is None:

            def combined(states):
                flds = gauss_state_flush(spec, info, list(states), jnp)
                if not with_state:
                    flds = [info.finalize_arrays(flds)]
                return states, jnp.stack(self._state_planes(spec_idx, flds))

            fn = jax.jit(combined, donate_argnums=(0,))
            self._jits[key] = fn
        states, packed = fn(self._states[spec_idx])
        self._states[spec_idx] = states
        start_d2h(packed)
        return packed

    # -- one-shot ingest ---------------------------------------------------------

    def ingest_point(self, spec_idx, cells, valid, values,
                     weights=None, timestamps=None) -> None:
        self.commit(spec_idx, self.prepare_point(
            spec_idx, cells, valid, values, weights, timestamps))

    def ingest_gaussian(self, spec_idx, gp, valid, values) -> None:
        self.commit(spec_idx, self.prepare_gaussian(
            spec_idx, gp, valid, values))

    def ingest_line(self, spec_idx, lp, valid, values, col, row) -> None:
        self.commit(spec_idx, self.prepare_line(
            spec_idx, lp, valid, values, col, row))

    def block_until_ready(self):
        import jax
        self.flush_pending()
        for st in self._states:
            jax.block_until_ready(st)
