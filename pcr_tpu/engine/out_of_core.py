"""
Out-of-core device engine — grids whose accumulation state exceeds the
device-memory budget.

Reference semantics: the TileManager serves *device* state with H2D/D2H on
acquire/release so GPU mode handles grids bigger than VRAM
(src/engine/tile_manager.cpp:183-414). This redesign works in row *bands*
instead of tiles:

  * the full per-reduction state lives in host RAM (float32 (H, W) arrays);
  * ONE band-shaped ``TpuEngine`` executor owns device state for the band
    currently being accumulated (band height = a tile-row multiple sized
    from ``gpu_memory_budget``), so every jit compiles once and is reused
    for every band;
  * ingest entries group by the *home tile* of each point — glyph
    footprints clip to the home tile (TileRouter semantics), so a band
    aligned to tile rows fully contains every entry's footprint and no
    cross-band halo exists;
  * inputs are localized by an integer row offset (icy - r0, never a
    re-route through float math), so banded results are bit-identical to
    the resident engine's.

Band switch = D2H of the dirty band state + H2D of the next band's
(acquire/release). Finalize flushes the current band and runs the host
finalize over the full arrays.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..core.grid_config import GridConfig
from ..ops.reduction import FLT_MAX

__all__ = ["OutOfCoreTpuEngine", "pick_band_rows"]


def pick_band_rows(cfg: GridConfig, plans, budget: int) -> int:
    """Largest band height whose device working set (state fields +
    staging slack) fits the budget; 0 means the whole grid fits (no
    banding needed).

    Tiled grids band on tile-row multiples (glyph footprints clip to the
    home tile, so tile-aligned bands need no halo). Untiled grids band on
    raw GAUSS_ROW_BLOCK-aligned rows — there is no tile clip to respect,
    and the engine duplicates each glyph entry into every band its
    footprint touches."""
    nf = sum(info.state_floats for _, info in plans)
    bytes_per_row = cfg.width * 4 * nf
    # staging buffers + donated double-buffering: keep the state itself
    # within ~1/4 of the budget
    rows = int(budget // (4 * bytes_per_row))
    if cfg.total_tiles() <= 1:
        from .tpu_backend import GAUSS_ROW_BLOCK
        rows = (rows // GAUSS_ROW_BLOCK) * GAUSS_ROW_BLOCK
        if rows >= cfg.height:
            return 0
        return max(rows, GAUSS_ROW_BLOCK)
    rows = (rows // cfg.tile_height) * cfg.tile_height
    if rows >= cfg.height:
        return 0
    return max(rows, cfg.tile_height)


class OutOfCoreTpuEngine:
    """Band-swapped accumulation engine (see module docstring). Mirrors the
    ``TpuEngine`` surface the Pipeline uses."""

    def __init__(self, cfg: GridConfig, plans, band_rows: int, device=None):
        from .tpu_backend import GAUSS_ROW_BLOCK, TpuEngine
        self.untiled = cfg.total_tiles() <= 1
        if self.untiled:
            # untiled grids band on raw rows; glyph footprints may span
            # bands, so prepare_* duplicates entries into every band
            # their footprint touches (the band kernel's row masks clip
            # each copy to its band exactly)
            if band_rows % GAUSS_ROW_BLOCK != 0:
                raise ValueError(
                    "band_rows must be a GAUSS_ROW_BLOCK multiple for "
                    "untiled grids")
        elif band_rows % cfg.tile_height != 0:
            raise ValueError("band_rows must be a tile_height multiple")
        self.cfg = cfg
        self.plans = plans
        self.H, self.W = cfg.height, cfg.width
        self.band_rows = band_rows
        self.nbands = -(-self.H // band_rows)
        band_cfg = replace(cfg)
        band_cfg.height = band_rows
        band_cfg.tiles_y = (1 if self.untiled
                            else band_rows // cfg.tile_height)
        self._exec = TpuEngine(band_cfg, plans, device=device)
        self._host = [info.init_state((self.H, self.W))
                      for _, info in plans]
        self._cur: int | None = None
        self._dirty = False
        self._tpb = max(band_rows // cfg.tile_height, 1)  # tile rows/band

    # -- band residency ---------------------------------------------------------

    def _band_of(self, row_clamped: np.ndarray) -> np.ndarray:
        """Band id from the (clamped) assigned row — i.e. of the home
        tile (tiled grids) or the raw row (untiled)."""
        if self.untiled:
            return row_clamped // self.band_rows
        return (row_clamped // self.cfg.tile_height) // self._tpb

    def _flush_cur(self):
        if self._cur is None or not self._dirty:
            return
        r0 = self._cur * self.band_rows
        r1 = min(r0 + self.band_rows, self.H)
        for i in range(len(self.plans)):
            fields = self._exec.fetch_state(i)
            for f, arr in enumerate(fields):
                self._host[i][f][r0:r1] = arr[: r1 - r0]
        self._dirty = False

    def _use_band(self, b: int):
        if b == self._cur:
            return
        self._flush_cur()
        self._cur = b
        r0 = b * self.band_rows
        r1 = min(r0 + self.band_rows, self.H)
        for i, (spec, info) in enumerate(self.plans):
            fields = []
            for f in range(info.state_floats):
                full = np.full((self.band_rows, self.W), info.identity[f],
                               np.float32)
                full[: r1 - r0] = self._host[i][f][r0:r1]
                fields.append(full)
            self._exec.load_state(i, fields)

    # -- state access (host-resident) --------------------------------------------

    def fetch_state(self, spec_idx: int):
        self._flush_cur()
        from .tpu_backend import gauss_state_flush
        spec, info = self.plans[spec_idx]
        return gauss_state_flush(
            spec, info, [f.copy() for f in self._host[spec_idx]], np)

    def load_state(self, spec_idx: int, fields_hw) -> None:
        self._flush_cur()
        self._cur = None    # cached band is stale
        self._host[spec_idx] = [np.asarray(f, np.float32).copy()
                                for f in fields_hw]

    def finalize_band(self, spec_idx: int) -> np.ndarray:
        self._flush_cur()
        from .tpu_backend import gauss_state_flush
        spec, info = self.plans[spec_idx]
        return np.asarray(
            info.finalize_arrays(gauss_state_flush(
                spec, info, list(self._host[spec_idx]), np)),
            dtype=np.float32)

    def block_until_ready(self):
        self._flush_cur()

    # -- staging: group by band, localize rows, delegate to the band engine ------

    def prepare_point(self, spec_idx: int, cells, valid, values,
                      weights=None, timestamps=None, col=None, row=None):
        if cells is None:
            cells = np.asarray(row, np.int64) * self.W + col
        cells = np.asarray(cells)
        valid = np.asarray(valid, bool)
        row = cells // self.W
        col = cells - row * self.W
        band = self._band_of(np.clip(row, 0, self.H - 1))
        staged = []
        for b in self._bands_touched(band, valid):
            sel = valid & (band == b)
            if not sel.any():
                continue
            lcells = ((row[sel] - b * self.band_rows).astype(np.int32)
                      * np.int32(self.W) + col[sel].astype(np.int32))
            chunks = self._exec.prepare_point(
                spec_idx, lcells, np.ones(len(lcells), bool),
                np.asarray(values)[sel],
                None if weights is None else np.asarray(weights)[sel],
                None if timestamps is None
                else np.asarray(timestamps)[sel])
            staged.append((int(b), chunks))
        return staged

    def _band_span(self, y_lo, y_hi, valid):
        """Per-point inclusive band range [b0, b1] for a footprint
        spanning rows [y_lo, y_hi] (untiled grids only — tiled grids'
        footprints clip to the home tile, one band)."""
        b0 = np.clip(np.asarray(y_lo) // self.band_rows, 0,
                     self.nbands - 1)
        b1 = np.clip(np.asarray(y_hi) // self.band_rows, 0,
                     self.nbands - 1)
        bands = (range(int(b0[valid].min()), int(b1[valid].max()) + 1)
                 if valid.any() else [])
        return b0, b1, bands

    def prepare_gaussian(self, spec_idx: int, gp, valid, values):
        valid = np.asarray(valid, bool)
        if self.untiled:
            b0, b1, bands = self._band_span(gp.icy - gp.r, gp.icy + gp.r,
                                            valid)
            staged = []
            for b in bands:
                sel = valid & (b0 <= b) & (b <= b1)
                if not sel.any():
                    continue
                lgp = replace(gp, icy=(gp.icy[sel]
                                       - np.int32(b * self.band_rows)),
                              icx=gp.icx[sel], sub_cx=gp.sub_cx[sel],
                              sub_cy=gp.sub_cy[sel], sx=gp.sx[sel],
                              sy=gp.sy[sel], cos_rot=gp.cos_rot[sel],
                              sin_rot=gp.sin_rot[sel], r=gp.r[sel])
                chunks = self._exec.prepare_gaussian(
                    spec_idx, lgp, np.ones(int(sel.sum()), bool),
                    np.asarray(values)[sel])
                staged.append((int(b), chunks))
            return staged
        band = self._band_of(np.clip(gp.icy, 0, self.H - 1))
        staged = []
        for b in self._bands_touched(band, valid):
            sel = valid & (band == b)
            if not sel.any():
                continue
            lgp = replace(gp, icy=(gp.icy[sel]
                                   - np.int32(b * self.band_rows)),
                          icx=gp.icx[sel], sub_cx=gp.sub_cx[sel],
                          sub_cy=gp.sub_cy[sel], sx=gp.sx[sel],
                          sy=gp.sy[sel], cos_rot=gp.cos_rot[sel],
                          sin_rot=gp.sin_rot[sel], r=gp.r[sel])
            chunks = self._exec.prepare_gaussian(
                spec_idx, lgp, np.ones(int(sel.sum()), bool),
                np.asarray(values)[sel])
            staged.append((int(b), chunks))
        return staged

    def prepare_line(self, spec_idx: int, lp, valid, values, col, row):
        valid = np.asarray(valid, bool)
        row = np.asarray(row)
        if self.untiled:
            y_lo = np.minimum(lp.iy0, lp.iy1)
            y_hi = np.maximum(lp.iy0, lp.iy1)
            b0, b1, bands = self._band_span(y_lo, y_hi, valid)
            staged = []
            for b in bands:
                sel = valid & (b0 <= b) & (b <= b1)
                if not sel.any():
                    continue
                off = np.int32(b * self.band_rows)
                llp = replace(lp, ix0=lp.ix0[sel], iy0=lp.iy0[sel] - off,
                              ix1=lp.ix1[sel], iy1=lp.iy1[sel] - off)
                ddx = np.abs(llp.ix1.astype(np.int64) - llp.ix0)
                ddy = np.abs(llp.iy1.astype(np.int64) - llp.iy0)
                llp.max_steps = (int((2 * (ddx + ddy) + 2).max())
                                 if len(ddx) else 0)
                llp.k_cells = (int(np.maximum(ddx, ddy).max()) + 1
                               if len(ddx) else 0)
                chunks = self._exec.prepare_line(
                    spec_idx, llp, np.ones(int(sel.sum()), bool),
                    np.asarray(values)[sel], np.asarray(col)[sel],
                    np.clip(row[sel] - off, 0, self.band_rows - 1))
                staged.append((int(b), chunks))
            return staged
        band = self._band_of(np.clip(row, 0, self.H - 1))
        staged = []
        for b in self._bands_touched(band, valid):
            sel = valid & (band == b)
            if not sel.any():
                continue
            off = np.int32(b * self.band_rows)
            llp = replace(lp, ix0=lp.ix0[sel], iy0=lp.iy0[sel] - off,
                          ix1=lp.ix1[sel], iy1=lp.iy1[sel] - off)
            ddx = np.abs(llp.ix1.astype(np.int64) - llp.ix0)
            ddy = np.abs(llp.iy1.astype(np.int64) - llp.iy0)
            llp.max_steps = int((2 * (ddx + ddy) + 2).max()) if len(ddx) else 0
            llp.k_cells = (int(np.maximum(ddx, ddy).max()) + 1
                           if len(ddx) else 0)
            chunks = self._exec.prepare_line(
                spec_idx, llp, np.ones(int(sel.sum()), bool),
                np.asarray(values)[sel], np.asarray(col)[sel],
                row[sel] - off)
            staged.append((int(b), chunks))
        return staged

    @staticmethod
    def _bands_touched(band, valid):
        return sorted(np.unique(band[valid]).tolist())

    # -- commit -------------------------------------------------------------------

    def commit(self, spec_idx: int, staged) -> None:
        for b, chunks in sorted(staged, key=lambda t: t[0]):
            self._use_band(b)
            self._exec.commit(spec_idx, chunks)
            self._exec.flush_pending(spec_idx)
            self._dirty = True

    # -- one-shot ingest -------------------------------------------------------------

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
