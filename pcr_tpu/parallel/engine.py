"""
ShardedTpuEngine — multi-chip device state behind the Pipeline API.

Mirrors the single-device ``TpuEngine`` surface (prepare_*/commit/
fetch_state/load_state/finalize_band/block_until_ready) so ``Pipeline``
can run its full create → ingest → resume → finalize → GeoTIFF lifecycle
(reference lifecycle: src/engine/pipeline.cpp:31-1403) over a
``jax.sharding.Mesh`` instead of one chip:

  * per-reduction state lives sharded ``P('sp', None)`` — row blocks over
    the spatial axis, replicated over the data axis;
  * ingest routes every entry to the sp shard(s) its footprint touches ON
    THE HOST, then each device runs the SAME single-device update program
    (grid scatter, Gaussian window or separable splat, Bresenham scatter)
    over its own entries in LOCAL row coordinates, so per-device work is
    the single-device engine's work on a 1/sp-height grid;
  * with dp > 1 each shard's entries further split over the data axis and
    per-device results merge with one collective (``psum`` for the sum
    family, ``pmax``/``pmin`` for Max/Min; the merges are associative —
    builtin_ops.h:15-120); dp == 1 runs collective-free;
  * finalize runs on-device over the sharded state and fetches one band.

Multi-tile grids route to ``PartitionedTpuEngine`` (per-device
single-device engines, see its docstring). The dense shard_map steps in
``parallel.sharding`` remain as library-level building blocks (still
oracle-exact) but no Pipeline configuration reaches them.

Host inputs are padded to a bounded ladder of lengths (powers of two of a
dp-divisible quantum) so the jit cache stays small; padding entries are
in-band inert (valid=False, empty rect intervals, r == -1).
"""

from __future__ import annotations

import numpy as np

from ..core.types import ReductionType
from ..ops.reduction import FLT_MAX
from . import sharding

__all__ = ["ShardedTpuEngine", "PartitionedTpuEngine",
           "resolve_mesh_devices"]


def resolve_mesh_devices(mesh_devices, platform=None):
    """Normalize a PipelineConfig mesh_devices value to a device list.

    Accepts None (single-device: caller should not build this engine),
    an int (take that many from jax.devices(), preferring the requested
    platform), or an explicit device list."""
    import jax
    if mesh_devices is None:
        return None
    if isinstance(mesh_devices, int):
        if platform is not None:
            try:
                devs = jax.devices(platform)
            except RuntimeError:
                devs = jax.devices()
        else:
            devs = jax.devices()
        if len(devs) < mesh_devices:
            raise ValueError(
                f"mesh_devices={mesh_devices} but only {len(devs)} "
                f"devices available")
        return devs[:mesh_devices]
    return list(mesh_devices)


def _pad_len(n: int, quantum: int) -> int:
    """Next padded length: quantum * 2^k (bounded jit-signature ladder)."""
    m = max(1, -(-n // quantum))
    return quantum * (1 << (m - 1).bit_length())


def _pad(arr, length, fill):
    a = np.asarray(arr)
    if len(a) == length:
        return a
    out = np.full(length, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


class _Staged:
    """One mesh-sharded staged chunk: the jit key, the sharded input
    arrays, and a zero-arg builder for the step function."""

    __slots__ = ("key", "arrays", "builder", "npoints")

    def __init__(self, key, arrays, builder, npoints):
        self.key = key
        self.arrays = arrays
        self.builder = builder
        self.npoints = npoints


class _StagedPacked:
    """One host-routed staged chunk: a (dp, sp, L) packed i32 buffer (one
    single-chip packed chunk per mesh cell, same program everywhere) and
    the zero-arg builder of the LOCAL update fn. ``local_key`` is the
    single-chip chunk key; the engine wraps the local update in a
    shard_map step cached under ("packed", local_key)."""

    __slots__ = ("key", "buf", "builder", "npoints")

    def __init__(self, key, buf, builder, npoints):
        self.key = key
        self.buf = buf
        self.builder = builder
        self.npoints = npoints


def _flat_state_builder(builder, lhp, ws):
    """Adapt a flat-state single-chip update (e.g. the Bresenham line
    scatter, whose sentinel C == local_rows*W lands in the pad rows of
    the (lhp, ws) layout) to the engine's 2-D local state blocks."""
    def build():
        u = builder()

        def fn(states, buf):
            out = u(tuple(s.reshape(-1) for s in states), buf)
            return tuple(s.reshape(lhp, ws) for s in out)

        return fn
    return build


class _LocalCfg:
    """GridConfig facade for one row shard: the shard's row slice in
    LOCAL coordinates, carrying the global frame (row_offset /
    global_height / the real tile grid) so every home-tile clip site
    (routing.home_tile_ranges, tpu_backend._device_tile_clip) computes
    tile rows in GLOBAL coordinates and
    translates back. Single-tile global grids keep the legacy view (the
    shard itself is one tile; no clipping anywhere)."""

    def __init__(self, cfg, local_rows: int, row_offset: int = 0):
        self.width = cfg.width
        self.height = local_rows
        self.row_offset = row_offset
        self.global_height = cfg.height
        if cfg.total_tiles() > 1:
            self.tile_width = cfg.tile_width
            self.tile_height = cfg.tile_height
            self._tiles = cfg.total_tiles()
        else:
            self.tile_width = cfg.width
            self.tile_height = local_rows
            self._tiles = 1
        self.cell_size_x = getattr(cfg, "cell_size_x", 1.0)
        self.cell_size_y = getattr(cfg, "cell_size_y", -1.0)
        self.bounds = getattr(cfg, "bounds", None)

    def total_tiles(self) -> int:
        return self._tiles


# chunk-key field that carries nsub, per key name (used to raise the
# cross-shard nsub floor so every shard compiles the same program)
_NSUB_POS = {"gauss_sorted": 2}


class ShardedTpuEngine:
    """Multi-chip accumulation engine for one Pipeline run (see module
    docstring). Drop-in for ``TpuEngine`` from the Pipeline's viewpoint."""

    def __init__(self, cfg, plans, mesh=None, devices=None,
                 dp: int | None = None, sp: int | None = None,
                 block: int = 1024):
        import jax
        from ..engine.tpu_backend import (
            GAUSS_ROW_BLOCK, enable_compilation_cache)
        enable_compilation_cache()
        self.cfg = cfg
        self.plans = plans
        self.block = block
        if mesh is None:
            mesh = sharding.make_mesh(devices, dp=dp, sp=sp)
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.sp = mesh.shape["sp"]
        self.H = cfg.height
        self.W = cfg.width
        self.local_rows = -(-self.H // self.sp)
        # Host-routed fast path (single-tile grids): each shard's local
        # state is row-block aligned so the single-device separable-splat
        # programs run unchanged per shard. Multi-tile grids keep the
        # dense legacy steps and the unaligned layout they assume.
        self._fast = cfg.total_tiles() == 1
        if self._fast:
            self.local_h_pad = (-(-self.local_rows // GAUSS_ROW_BLOCK)
                                * GAUSS_ROW_BLOCK)
        else:
            self.local_h_pad = self.local_rows
        self.H_pad = self.sp * self.local_h_pad
        self._states = []
        # jitted step programs shared across engine instances (a fresh
        # Pipeline otherwise re-traces + re-compiles every shard_map
        # program) — same machinery as TpuEngine
        from ..engine.tpu_backend import _shared_jit_namespace
        b = cfg.bounds
        ns_key = (
            "sharded",
            tuple(d.id for d in self.mesh.devices.flat),
            self.dp, self.sp,
            cfg.width, cfg.height, cfg.tile_width, cfg.tile_height,
            float(cfg.cell_size_x), float(cfg.cell_size_y),
            float(b.min_x), float(b.min_y), float(b.max_x), float(b.max_y),
            tuple((spec.glyph.type, info.type, info.state_floats,
                   info.scatter_kind, info.token)
                  for spec, info in plans),
            self._fast, self.local_h_pad,
        )
        self._jits = _shared_jit_namespace(ns_key)
        for spec, info in plans:
            fields = info.init_state((self.H_pad, self.W))
            self._states.append(
                sharding.replicate_state(self.mesh, fields, self.H_pad,
                                         self.W))

    # -- per-shard planner (borrowed single-chip staging machinery) --------

    def _planner(self, nsub_floor: int = 1, rmax_floor: int = 0,
                 flat_C: int | None = None, gauss_form: str | None = None):
        """A TpuEngine facade for ONE sp shard: same staging methods, no
        device state, `_put` kept on host (placement happens when the
        per-shard buffers stack into the mesh array)."""
        from ..engine import tpu_backend as tb
        p = object.__new__(tb.TpuEngine)
        p.cfg = _LocalCfg(self.cfg, self.local_rows)
        p.H = self.local_rows
        p.W = self.W
        p.C = flat_C or self.local_rows * self.W
        p.H_pad = self.local_h_pad
        p.plans = self.plans
        p.device = None
        p._put = lambda buf: buf
        p._nsub_floor = nsub_floor
        p._rmax_floor = rmax_floor
        p._gauss_form = gauss_form
        return p

    def _route(self, lo, hi, valid):
        """Per (dp, sp) mesh cell: indices whose inclusive global-row span
        [lo, hi] overlaps the sp shard's owned rows, split contiguously
        over dp. Entries spanning several shards are duplicated (their
        out-of-shard parts clip away in local coordinates)."""
        lr = self.local_rows
        s0 = np.clip(np.minimum(lo, hi) // lr, 0, self.sp - 1)
        s1 = np.clip(np.maximum(lo, hi) // lr, 0, self.sp - 1)
        out = []
        for s in range(self.sp):
            idx = np.flatnonzero(valid & (s0 <= s) & (s <= s1))
            parts = np.array_split(idx, self.dp)
            out.append(parts)
        return out   # out[s][d] -> index array

    def _stack(self, spec_idx, prepare_one, npoints,
               rmax_floor: int = 0, flat_C: int | None = None,
               gauss_form: str | None = None):
        """Run the single-chip staging per (dp, sp) cell, force a common
        program across cells (nsub floor re-pass when the bucketing
        ladder disagrees), and stack the packed buffers into (dp, sp, L)
        mesh arrays — one _StagedPacked per chunk index.

        prepare_one(planner, s, d) -> list[StagedChunk] with host bufs.
        rmax_floor / flat_C / gauss_form are passed THROUGH (not via
        instance attributes): hybrid-mode ingest stages concurrently from
        worker threads, and shared mutable staging state would race.
        """
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        def run(nsub_floor):
            planner = self._planner(nsub_floor, rmax_floor, flat_C,
                                    gauss_form)
            return [[prepare_one(planner, s, d) for s in range(self.sp)]
                    for d in range(self.dp)]

        cells = run(1)
        # uniform chunk count is guaranteed (same padded lengths); force
        # uniform nsub across cells per chunk index
        nchunks = len(cells[0][0])
        floor = 1
        for j in range(nchunks):
            for d in range(self.dp):
                for s in range(self.sp):
                    key = cells[d][s][j].key
                    pos = _NSUB_POS.get(key[0])
                    if pos is not None:
                        floor = max(floor, key[pos])
        keys0 = [cells[0][0][j].key for j in range(nchunks)]
        if any(cells[d][s][j].key != keys0[j]
               for j in range(nchunks)
               for d in range(self.dp) for s in range(self.sp)):
            cells = run(floor)
            keys0 = [cells[0][0][j].key for j in range(nchunks)]
            for j in range(nchunks):
                for d in range(self.dp):
                    for s in range(self.sp):
                        if cells[d][s][j].key != keys0[j]:
                            raise AssertionError(
                                "sharded staging failed to converge on a "
                                f"common program: {cells[d][s][j].key} vs "
                                f"{keys0[j]}")
        sh = NamedSharding(self.mesh, P("dp", "sp", None))
        staged = []
        for j in range(nchunks):
            if self.dp == 1 and self.sp == 1:
                # no-copy view; device_put copies anyway
                buf = np.asarray(cells[0][0][j].buf)[None, None, :]
            else:
                buf = np.stack([
                    np.stack([cells[d][s][j].buf for s in range(self.sp)])
                    for d in range(self.dp)])
            staged.append(_StagedPacked(
                ("packed", spec_idx) + keys0[j],
                jax.device_put(buf, sh),
                cells[0][0][j].builder, npoints))
        return staged

    def _packed_step(self, builder, info):
        """Wrap a single-chip local update fn into the mesh step: each
        chip updates its local (local_h_pad, W) state block from
        its (1, 1, L) buffer slice; dp > 1 merges per-chip results with
        the op's collective — psum for the sum family, pmax/pmin for
        Max/Min, a lexicographic (timestamp, dp-index) reduction for
        MostRecent (associativity: builtin_ops.h:15-120)."""
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        upd = builder()
        dp = self.dp
        nf = info.state_floats
        kind = info.scatter_kind

        def local(states, buf):
            b = buf.reshape(buf.shape[-1])
            if dp == 1:
                return tuple(upd(tuple(states), b))
            if kind == "sum":
                zeros = tuple(
                    sharding._vary(jax, jnp.zeros_like(s), ("dp",))
                    for s in states)
                delta = upd(zeros, b)
                return tuple(s + jax.lax.psum(d, "dp")
                             for s, d in zip(states, delta))
            # non-sum kinds: run the chip's update from identity state,
            # then merge the per-chip candidates with the op's collective
            ident = tuple(
                sharding._vary(
                    jax, jnp.full_like(s, np.float32(info.identity[f])),
                    ("dp",))
                for f, s in enumerate(states))
            cand = upd(ident, b)
            if kind == "max":
                return (jnp.maximum(states[0],
                                    jax.lax.pmax(cand[0], "dp")),)
            if kind == "min":
                return (jnp.minimum(states[0],
                                    jax.lax.pmin(cand[0], "dp")),)
            if kind == "argmax_ts":
                # MostRecent: max timestamp wins across chips; the lowest
                # dp index breaks ties (dp shards split points in ingest
                # order, so this keeps "earliest point wins on ties");
                # existing state wins ties against the batch.
                cur_v, cur_t = states
                cv, ct = cand
                gm = jax.lax.pmax(ct, "dp")
                dpi = jax.lax.axis_index("dp")
                big = jnp.int32(2**31 - 1)
                my_win = (ct == gm) & (gm > jnp.float32(-FLT_MAX))
                windev = jax.lax.pmin(jnp.where(my_win, dpi, big), "dp")
                gv = jax.lax.psum(
                    jnp.where(my_win & (dpi == windev), cv, 0.0), "dp")
                take = gm > cur_t
                return (jnp.where(take, gv, cur_v),
                        jnp.where(take, gm, cur_t))
            raise NotImplementedError(kind)

        # dp == 1: the buffer's unit leading axis stays unsharded so the
        # update output is dp-replicated (no psum, no variance mismatch)
        buf_spec = P("dp", "sp", None) if dp > 1 else P(None, "sp", None)
        kw = {"in_specs": (tuple(P("sp", None) for _ in range(nf)),
                           buf_spec),
              "out_specs": tuple(P("sp", None) for _ in range(nf))}
        fn = shard_map(local, mesh=self.mesh, **kw)
        return jax.jit(fn, donate_argnums=(0,))

    def _padded_rows(self, rows):
        """Map global row -> padded-global row (shard-local offsets are
        preserved; the inter-shard pad gap is skipped). Only valid for
        single-cell targets — windows/intervals must be routed+clipped."""
        lr = self.local_rows
        return (rows // lr) * self.local_h_pad + rows % lr

    # -- state access -------------------------------------------------------

    def load_state(self, spec_idx: int, fields_hw) -> None:
        _, info = self.plans[spec_idx]
        lr, lhp = self.local_rows, self.local_h_pad
        padded = []
        for fi, f in enumerate(fields_hw):
            a = np.full((self.H_pad, self.W), info.identity[fi],
                        np.float32)
            src = np.asarray(f, np.float32)
            for s in range(self.sp):
                rows = min(lr, self.H - s * lr)
                if rows > 0:
                    a[s * lhp:s * lhp + rows, : self.W] = \
                        src[s * lr:s * lr + rows]
            padded.append(a)
        self._states[spec_idx] = sharding.replicate_state(
            self.mesh, padded, self.H_pad, self.W)

    def _unpad(self, a):
        a = np.asarray(a).reshape(self.sp, self.local_h_pad, self.W)
        return a[:, : self.local_rows, : self.W].reshape(-1, self.W)[
            : self.H]

    def fetch_state(self, spec_idx: int):
        from ..engine.tpu_backend import gauss_state_flush
        spec, info = self.plans[spec_idx]
        return gauss_state_flush(
            spec, info,
            [self._unpad(f) for f in self._states[spec_idx]], np)

    def finalize_band(self, spec_idx: int) -> np.ndarray:
        import jax
        from ..engine.tpu_backend import gauss_state_flush
        spec, info = self.plans[spec_idx]
        key = ("finalize", spec_idx)
        fn = self._jits.get(key)
        if fn is None:
            import jax.numpy as jnp
            fn = jax.jit(lambda st: info.finalize_arrays(
                gauss_state_flush(spec, info, list(st), jnp)))
            self._jits[key] = fn
        return self._unpad(fn(self._states[spec_idx]))

    def block_until_ready(self):
        import jax
        for st in self._states:
            jax.block_until_ready(st)

    # -- staging --------------------------------------------------------------

    def _shard(self, *arrays):
        return sharding.shard_points(self.mesh, *arrays)

    def prepare_point(self, spec_idx: int, cells, valid, values,
                      weights=None, timestamps=None, col=None, row=None):
        _, info = self.plans[spec_idx]
        valid = np.asarray(valid, bool)
        values = np.asarray(values, np.float32)
        if col is not None:
            n = len(col)
            rows = np.asarray(row, np.int32)
            cols = np.asarray(col, np.int32)
        else:
            n = len(cells)
            cells = np.asarray(cells, np.int64)
            rows = (cells // self.W).astype(np.int32)
            cols = (cells % self.W).astype(np.int32)
        if self._fast and info.scatter_kind == "sum" and info.builtin:
            # host-route each point to its owning sp shard; per-cell
            # packed [cells|f0|(f1)] chunks run the single-device
            # grid-scatter update in local coordinates
            w = (np.asarray(weights, np.float32)
                 if weights is not None else None)
            if self.sp * self.dp == 1:
                # trivial mesh: skip the routing/gather/pad copies (the
                # planner masks invalids itself, and the col/row form
                # engages the native fused pack)
                def prepare_one(planner, s, d):
                    if col is not None:
                        return planner.prepare_point_grid(
                            spec_idx, None, valid, values, w,
                            col=cols, row=rows)
                    return planner.prepare_point_grid(
                        spec_idx, cells.astype(np.int32, copy=False),
                        valid, values, w)

                return self._stack(spec_idx, prepare_one,
                                   int(np.count_nonzero(valid)))
            routed = self._route(rows, rows, valid)
            lmax = max((len(routed[s][d]) for s in range(self.sp)
                        for d in range(self.dp)), default=0)
            lmax = max(lmax, 1)

            def prepare_one(planner, s, d):
                idx = routed[s][d]
                lcells = ((rows[idx] - s * self.local_rows).astype(np.int64)
                          * self.W + cols[idx])
                k = len(idx)
                return planner.prepare_point_grid(
                    spec_idx,
                    _pad(lcells.astype(np.int32), lmax, 0),
                    _pad(np.ones(k, bool), lmax, False),
                    _pad(values[idx], lmax, 0.0),
                    _pad(w[idx], lmax, 1.0) if w is not None else None)

            return self._stack(spec_idx, prepare_one,
                               int(np.count_nonzero(valid)))
        if self._fast and (info.scatter_kind in ("max", "min", "argmax_ts")
                           or not info.builtin):
            # Max/Min/MostRecent (and Custom ops of any kind) fast path:
            # host-route each point to its
            # owning sp shard; per-cell packed [cells|values|(w)|(ts)]
            # chunks run the single-device XLA scatter (incl. the 3-scatter
            # lexicographic argmax for MostRecent) on the shard's local
            # state, flattened to the padded (lhp, W) layout —
            # the planner's C override makes the invalid-cell sentinel
            # drop cleanly there. dp > 1 merges per-chip candidates with
            # pmax/pmin/lexicographic collectives in _packed_step.
            w = (np.asarray(weights, np.float32)
                 if weights is not None else None)
            ts = (np.asarray(timestamps, np.float32)
                  if timestamps is not None else None)
            lhp, ws = self.local_h_pad, self.W
            if self.sp * self.dp == 1:
                # trivial mesh: no routing/gather/pad copies — the
                # planner's sentinel handles invalids
                flat = (cells if col is None
                        else rows.astype(np.int64) * ws + cols)

                def prepare_one(planner, s, d):
                    chunks = planner.prepare_point(
                        spec_idx, flat.astype(np.int32, copy=False),
                        valid, values, w, ts)
                    return [type(c)(c.key, c.buf,
                                    _flat_state_builder(c.builder, lhp,
                                                        ws),
                                    c.npoints) for c in chunks]

                return self._stack(spec_idx, prepare_one,
                                   int(np.count_nonzero(valid)),
                                   flat_C=lhp * ws)
            routed = self._route(rows, rows, valid)
            lmax = max((len(routed[s][d]) for s in range(self.sp)
                        for d in range(self.dp)), default=0)
            lmax = max(lmax, 1)

            def prepare_one(planner, s, d):
                idx = routed[s][d]
                k = len(idx)
                lrow = (rows[idx].astype(np.int64)
                        - np.int64(s * self.local_rows))
                lcells = lrow * ws + cols[idx]
                chunks = planner.prepare_point(
                    spec_idx,
                    _pad(lcells.astype(np.int32), lmax, 0),
                    _pad(np.ones(k, bool), lmax, False),
                    _pad(values[idx], lmax, 0.0),
                    _pad(w[idx], lmax, 1.0) if w is not None else None,
                    _pad(ts[idx], lmax, -FLT_MAX)
                    if ts is not None else None)
                return [type(c)(c.key, c.buf,
                                _flat_state_builder(c.builder, lhp, ws),
                                c.npoints) for c in chunks]

            return self._stack(spec_idx, prepare_one,
                               int(np.count_nonzero(valid)),
                               flat_C=lhp * ws)
        # dense legacy step (kept for the library-level sharded_point_step
        # surface; no Pipeline configuration reaches it anymore): rows
        # pre-mapped to the padded-global layout (single-cell targets, so
        # the per-shard offset mapping is exact)
        L = _pad_len(n, self.dp * 1024)
        prow = self._padded_rows(np.maximum(rows, 0))
        arrays = self._shard(
            _pad(prow.astype(np.int32), L, 0),
            _pad(cols, L, 0),
            _pad(valid, L, False),
            _pad(values, L, 0.0),
            _pad(np.asarray(weights, np.float32) if weights is not None
                 else np.ones(n, np.float32), L, 1.0),
            _pad(np.asarray(timestamps, np.float32)
                 if timestamps is not None
                 else np.full(n, -FLT_MAX, np.float32), L, -FLT_MAX))
        key = ("point", spec_idx, L)
        builder = (lambda info=info: sharding.sharded_point_step(
            info, self.H_pad, self.W, self.mesh))
        return [_Staged(key, arrays, builder,
                        int(np.count_nonzero(valid)))]

    def prepare_gaussian(self, spec_idx: int, gp, valid, values):
        _, info = self.plans[spec_idx]
        n = len(values)
        valid = np.asarray(valid, bool)
        values = np.asarray(values, np.float32)
        if self._fast:
            # route by footprint row span; each shard runs the single-device
            # Gaussian staging in local coordinates, in the form chosen for
            # the whole cloud (every shard compiles the same program)
            from ..engine.tpu_backend import gauss_form
            icy = gp.icy.astype(np.int64)
            r = np.where(valid, gp.r, 0).astype(np.int64)
            form = gauss_form(bool(gp.rotated), r[valid], gp.sx[valid],
                              gp.sy[valid], self.W,
                              4 * info.state_floats * self.local_h_pad
                              * self.W)
            routed = self._route(icy - r, icy + r, valid)
            lmax = max((len(routed[s][d]) for s in range(self.sp)
                        for d in range(self.dp)), default=0)
            lmax = max(lmax, 1)
            rmax_floor = int(r.max()) if n else 0

            def prepare_one(planner, s, d):
                idx = routed[s][d]
                k = len(idx)
                gpl = _GpView(
                    icx=_pad(gp.icx[idx], lmax, 0),
                    icy=_pad((gp.icy[idx]
                              - np.int32(s * self.local_rows)), lmax, 0),
                    sub_cx=_pad(gp.sub_cx[idx], lmax, 0.0),
                    sub_cy=_pad(gp.sub_cy[idx], lmax, 0.0),
                    sx=_pad(gp.sx[idx], lmax, 1.0),
                    sy=_pad(gp.sy[idx], lmax, 1.0),
                    cos_rot=_pad(gp.cos_rot[idx], lmax, 1.0),
                    sin_rot=_pad(gp.sin_rot[idx], lmax, 0.0),
                    r=_pad(gp.r[idx], lmax, -1),
                    rotated=gp.rotated)
                return planner.prepare_gaussian(
                    spec_idx, gpl,
                    _pad(np.ones(k, bool), lmax, False),
                    _pad(values[idx], lmax, 0.0))

            return self._stack(spec_idx, prepare_one, n,
                               rmax_floor=rmax_floor, gauss_form=form)
        if gp.rotated:
            L = _pad_len(n, self.dp * 1024)
            rmax = int(np.where(valid, gp.r, 0).max()) if n else 0
            arrays = self._shard(
                _pad(gp.icx, L, 0), _pad(gp.icy, L, 0),
                _pad(gp.sub_cx, L, 0.0), _pad(gp.sub_cy, L, 0.0),
                _pad(gp.sx, L, 1.0), _pad(gp.sy, L, 1.0),
                _pad(gp.cos_rot, L, 1.0), _pad(gp.sin_rot, L, 0.0),
                _pad(gp.r, L, -1), _pad(valid, L, False),
                _pad(values, L, 0.0))
            key = ("gauss_rot", spec_idx, L, rmax)
            builder = (lambda info=info, rmax=rmax:
                       sharding.sharded_gaussian_rotated_step(
                           info, self.H_pad, self.W, self.mesh, rmax,
                           cfg=self.cfg))
            return [_Staged(key, arrays, builder, n)]
        L = _pad_len(n, self.dp * self.block)
        arrays = self._shard(
            _pad(gp.icx, L, 0), _pad(gp.icy, L, 0),
            _pad(gp.sub_cx, L, 0.0), _pad(gp.sub_cy, L, 0.0),
            _pad(gp.sx, L, 1.0), _pad(gp.sy, L, 1.0),
            _pad(gp.r, L, -1), _pad(valid, L, False),
            _pad(values, L, 0.0))
        key = ("gauss", spec_idx, L)
        builder = (lambda info=info: sharding.sharded_gaussian_step(
            info, self.H_pad, self.W, self.mesh, block=self.block,
            cfg=self.cfg))
        return [_Staged(key, arrays, builder, n)]

    def prepare_line(self, spec_idx: int, lp, valid, values, col, row):
        from ..engine import routing
        _, info = self.plans[spec_idx]
        valid = np.asarray(valid, bool)
        values = np.asarray(values, np.float32)
        if self._fast:
            # route by endpoint row span; each shard runs the single-device
            # Bresenham scatter in local coordinates
            lo = np.minimum(lp.iy0, lp.iy1).astype(np.int64)
            hi = np.maximum(lp.iy0, lp.iy1).astype(np.int64)
            routed = self._route(lo, hi, valid)
            lmax = max((len(routed[s][d]) for s in range(self.sp)
                        for d in range(self.dp)), default=0)
            lmax = max(lmax, 1)

            def prepare_one(planner, s, d):
                idx = routed[s][d]
                k = len(idx)
                off = np.int32(s * self.local_rows)
                lpl = _LpView(
                    ix0=_pad(lp.ix0[idx], lmax, 0),
                    iy0=_pad(lp.iy0[idx] - off, lmax, 0),
                    ix1=_pad(lp.ix1[idx], lmax, 0),
                    iy1=_pad(lp.iy1[idx] - off, lmax, 0),
                    k_cells=lp.k_cells)
                chunks = planner.prepare_line(
                    spec_idx, lpl,
                    _pad(np.ones(k, bool), lmax, False),
                    _pad(values[idx], lmax, 0.0),
                    _pad(np.clip(col[idx], 0, self.W - 1), lmax, 0),
                    _pad(np.clip(row[idx] - off, 0,
                                 self.local_rows - 1), lmax, 0))
                return [type(c)(c.key, c.buf,
                                _flat_state_builder(
                                    c.builder, self.local_h_pad, self.W),
                                c.npoints) for c in chunks]

            return self._stack(spec_idx, prepare_one, len(lp.ix0))
        # dense legacy step: host rect decomposition in global rows,
        # rects split at shard boundaries, then mapped to the padded
        # layout (each piece lives inside one shard's row range)
        rects = routing.line_rects(lp, self.cfg, valid, col, row)
        ax, bx = rects.ax, rects.bx
        ay, by, owner = rects.ay, rects.by, rects.owner
        if self.local_h_pad != self.local_rows:
            pieces = []
            lr = self.local_rows
            s0 = np.maximum(ay, 0) // lr
            s1 = np.maximum(by, 0) // lr
            for off in range(int((s1 - s0).max()) + 1 if len(ay) else 1):
                sel = np.flatnonzero(s0 + off <= s1)
                if not len(sel):
                    continue
                ss = s0[sel] + off
                pieces.append((
                    ax[sel], bx[sel],
                    np.maximum(ay[sel], ss * lr),
                    np.minimum(by[sel], (ss + 1) * lr - 1),
                    owner[sel]))
            if pieces:
                ax = np.concatenate([p[0] for p in pieces])
                bx = np.concatenate([p[1] for p in pieces])
                ay = np.concatenate([p[2] for p in pieces])
                by = np.concatenate([p[3] for p in pieces])
                owner = np.concatenate([p[4] for p in pieces])
            ay = self._padded_rows(np.maximum(ay, 0)).astype(ay.dtype)
            by = self._padded_rows(np.maximum(by, 0)).astype(by.dtype)
        m = len(ax)
        L = _pad_len(m, self.dp * self.block)
        # pad fill makes an empty interval (ax=1 > bx=0): inert, no mask
        arrays = self._shard(
            _pad(ax, L, 1), _pad(bx, L, 0),
            _pad(ay, L, 1), _pad(by, L, 0),
            _pad(np.ones(m, bool), L, False),
            _pad(values[owner], L, 0.0))
        key = ("line", spec_idx, L)
        builder = (lambda info=info: sharding.sharded_line_step(
            info, self.H_pad, self.W, self.mesh, block=self.block))
        return [_Staged(key, arrays, builder, len(lp.ix0))]

    # -- commit -----------------------------------------------------------------

    def commit(self, spec_idx: int, staged) -> None:
        _, info = self.plans[spec_idx]
        for chunk in staged:
            fn = self._jits.get(chunk.key)
            if fn is None:
                if isinstance(chunk, _StagedPacked):
                    fn = self._packed_step(chunk.builder, info)
                else:
                    fn = chunk.builder()
                self._jits[chunk.key] = fn
            if isinstance(chunk, _StagedPacked):
                self._states[spec_idx] = fn(self._states[spec_idx],
                                            chunk.buf)
            else:
                self._states[spec_idx] = fn(self._states[spec_idx],
                                            *chunk.arrays)

    # -- one-shot ingest ----------------------------------------------------------

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


class PartitionedTpuEngine:
    """Multi-device engine for MULTI-TILE grids: one single-chip
    ``TpuEngine`` per device, each owning a contiguous row shard of the
    grid; ingest host-routes every entry to the shard(s) its footprint
    touches, exactly like the single-tile host-routed fast path — per-chip
    work is proportional to its share of the points, never the total.

    Why not the shard_map path: home-tile clipping (glyph footprints clip
    to the owner's tile, tile_router semantics) computes tile rows from
    the shard's global row offset, and that offset is a per-shard
    trace-time constant inside the single-device programs — a shard_map
    program must be identical on every mesh cell. One engine per device
    gives each shard its own correctly-offset program via the
    ``_LocalCfg`` shard view; every single-device path (window and
    separable splats, native staging, lazy commit batching) runs
    unchanged.

    Row ownership is exclusive, so no collectives are needed (the
    reference's ops only require an associative merge for cross-unit
    combination — builtin_ops.h:15-120 — and here units never share
    cells; straddling footprints are duplicated and clipped, not
    merged). The dp/sp mesh split is flattened: all dp*sp devices serve
    as row shards."""

    def __init__(self, cfg, plans, devices):
        from ..engine.tpu_backend import TpuEngine, enable_compilation_cache
        enable_compilation_cache()
        self.cfg = cfg
        self.plans = plans
        self.devices = list(devices)
        self.H, self.W = cfg.height, cfg.width
        n = max(1, min(len(self.devices), self.H))
        self.local_rows = -(-self.H // n)
        self.nshards = -(-self.H // self.local_rows)
        self.engines = []
        self.offsets = []
        for s in range(self.nshards):
            off = s * self.local_rows
            rows = min(self.local_rows, self.H - off)
            view = _LocalCfg(cfg, rows, off)
            self.engines.append(TpuEngine(
                view, plans, device=self.devices[s % len(self.devices)]))
            self.offsets.append(off)

    # -- state access -------------------------------------------------------

    def load_state(self, spec_idx: int, fields_hw) -> None:
        for s, eng in enumerate(self.engines):
            off = self.offsets[s]
            rows = eng.H
            eng.load_state(spec_idx, [
                np.asarray(f, np.float32)[off:off + rows]
                for f in fields_hw])

    def fetch_state(self, spec_idx: int):
        _, info = self.plans[spec_idx]
        parts = [eng.fetch_state(spec_idx) for eng in self.engines]
        return [np.concatenate([p[f] for p in parts], axis=0)[: self.H]
                for f in range(info.state_floats)]

    def finalize_band(self, spec_idx: int) -> np.ndarray:
        return np.concatenate(
            [eng.finalize_band(spec_idx) for eng in self.engines],
            axis=0)[: self.H]

    def block_until_ready(self):
        for eng in self.engines:
            eng.block_until_ready()

    def flush_pending(self, spec_idx=None):
        for eng in self.engines:
            eng.flush_pending(spec_idx)

    # -- routing ------------------------------------------------------------

    def _route(self, lo, hi, valid):
        """Per shard: indices whose inclusive global-row span [lo, hi]
        overlaps the shard's rows (duplicates straddlers; out-of-shard
        parts clip away in the shard's local frame)."""
        lr = self.local_rows
        s0 = np.clip(np.minimum(lo, hi) // lr, 0, self.nshards - 1)
        s1 = np.clip(np.maximum(lo, hi) // lr, 0, self.nshards - 1)
        return [np.flatnonzero(valid & (s0 <= s) & (s <= s1))
                for s in range(self.nshards)]

    # -- staging ------------------------------------------------------------
    # Staged lists are [(shard, chunks), ...]; empty shards stage nothing
    # (and therefore dispatch nothing at commit).

    def prepare_point(self, spec_idx: int, cells, valid, values,
                      weights=None, timestamps=None, col=None, row=None):
        if cells is None:
            cells = np.asarray(row, np.int64) * self.W + col
        cells = np.asarray(cells, np.int64)
        valid = np.asarray(valid, bool)
        values = np.asarray(values, np.float32)
        w = (np.asarray(weights, np.float32)
             if weights is not None else None)
        ts = (np.asarray(timestamps, np.float32)
              if timestamps is not None else None)
        rows = cells // self.W
        cols = cells % self.W
        staged = []
        for s, idx in enumerate(self._route(rows, rows, valid)):
            if not len(idx):
                continue
            eng = self.engines[s]
            lcells = ((rows[idx] - s * self.local_rows) * self.W
                      + cols[idx]).astype(np.int32)
            staged.append((s, eng.prepare_point(
                spec_idx, lcells, np.ones(len(idx), bool), values[idx],
                w[idx] if w is not None else None,
                ts[idx] if ts is not None else None)))
        return staged

    def prepare_gaussian(self, spec_idx: int, gp, valid, values):
        valid = np.asarray(valid, bool)
        values = np.asarray(values, np.float32)
        icy = gp.icy.astype(np.int64)
        r = np.where(valid, gp.r, 0).astype(np.int64)
        staged = []
        for s, idx in enumerate(self._route(icy - r, icy + r, valid)):
            if not len(idx):
                continue
            k = len(idx)
            gpl = _GpView(
                icx=gp.icx[idx],
                icy=(gp.icy[idx]
                     - np.int32(s * self.local_rows)),
                sub_cx=gp.sub_cx[idx], sub_cy=gp.sub_cy[idx],
                sx=gp.sx[idx], sy=gp.sy[idx],
                cos_rot=gp.cos_rot[idx], sin_rot=gp.sin_rot[idx],
                r=gp.r[idx], rotated=gp.rotated)
            staged.append((s, self.engines[s].prepare_gaussian(
                spec_idx, gpl, np.ones(k, bool), values[idx])))
        return staged

    def prepare_line(self, spec_idx: int, lp, valid, values, col, row):
        valid = np.asarray(valid, bool)
        values = np.asarray(values, np.float32)
        lo = np.minimum(lp.iy0, lp.iy1).astype(np.int64)
        hi = np.maximum(lp.iy0, lp.iy1).astype(np.int64)
        staged = []
        for s, idx in enumerate(self._route(lo, hi, valid)):
            if not len(idx):
                continue
            k = len(idx)
            off = np.int32(s * self.local_rows)
            lpl = _LpView(
                ix0=lp.ix0[idx], iy0=lp.iy0[idx] - off,
                ix1=lp.ix1[idx], iy1=lp.iy1[idx] - off,
                k_cells=lp.k_cells)
            # col/row: the clamped GLOBAL assigned cell, row shifted to
            # the shard frame UNCLAMPED — home_tile_ranges reconstructs
            # the global frame via the view's row_offset, so a line whose
            # home tile lies outside this shard paints nothing here.
            staged.append((s, self.engines[s].prepare_line(
                spec_idx, lpl, np.ones(k, bool), values[idx],
                np.asarray(col)[idx], np.asarray(row)[idx] - off)))
        return staged

    # -- commit -------------------------------------------------------------

    def commit(self, spec_idx: int, staged) -> None:
        for s, chunks in staged:
            self.engines[s].commit(spec_idx, chunks)

    # -- one-shot ingest ------------------------------------------------------

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


class _GpView:
    """GaussianParams view with per-shard gathered/shifted arrays."""

    __slots__ = ("icx", "icy", "sub_cx", "sub_cy", "sx", "sy",
                 "cos_rot", "sin_rot", "r", "rotated")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _LpView:
    """LineParams view with per-shard gathered/shifted arrays."""

    __slots__ = ("ix0", "iy0", "ix1", "iy1", "k_cells")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
