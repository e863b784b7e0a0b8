"""
Multi-chip ingest — jax.sharding Mesh + shard_map + XLA collectives.

The reference is single-device (SURVEY.md §2.7: no NCCL/MPI anywhere); its
only cross-unit "communication" is PCIe memcpy. This module is the
scale-out the reference never had, built on the fact that every registered
reduction has an associative, commutative merge (builtin_ops.h merge
functions), so cross-device combination is a psum/pmax-style collective
(NCCL over NVLink on GPUs).

Two mesh axes:

  * ``dp``  — data parallel over points: each chip ingests a shard of the
    chunk; per-chip deltas are merged with psum (Sum/Count/Average/
    WeightedAverage), pmax/pmin (Max/Min), or a lexicographic
    (timestamp, device) reduction (MostRecent).
  * ``sp``  — spatial parallel over grid rows: the state is sharded
    row-wise (the analogue of tensor parallelism for this workload); each
    chip owns a contiguous row block and accumulates only the points that
    land in it. No collective is needed on this axis for Point glyphs —
    cells are uniquely owned. (Gaussian/Line footprints that straddle row
    blocks are handled by letting every sp shard see all points and mask
    rows to its block.)

The grid state is laid out (H, W) and sharded PartitionSpec('sp', None);
point inputs are sharded PartitionSpec(('dp',)) on the leading axis and
replicated over 'sp'.
"""

from __future__ import annotations


import numpy as np

from ..core.types import ReductionType
from ..ops.reduction import FLT_MAX, ReductionInfo

__all__ = ["make_mesh", "sharded_point_step", "sharded_gaussian_step",
           "sharded_gaussian_rotated_step", "sharded_line_step",
           "replicate_state", "shard_points"]


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _vary(jax, x, axes):
    """Mark a replicated-constant as varying over mesh axes (needed for
    shard_map scan carries that later psum)."""
    return jax.lax.pcast(x, axes, to="varying")


def make_mesh(devices=None, dp: int | None = None, sp: int | None = None):
    """Build a ('dp', 'sp') mesh over the given devices.

    By default uses all devices on the dp axis. dp*sp must equal the device
    count."""
    import jax
    from jax.sharding import Mesh
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) != devices({n})")
    arr = np.asarray(devices).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def replicate_state(mesh, states, H, W):
    """Place per-field (H, W) state arrays sharded row-wise over 'sp' and
    replicated over 'dp'."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P("sp", None))
    return tuple(jax.device_put(np.asarray(s, np.float32).reshape(H, W), sh)
                 for s in states)


def shard_points(mesh, *arrays):
    """Place 1-D per-point arrays sharded over 'dp', replicated over 'sp'."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P("dp"))
    return tuple(jax.device_put(np.asarray(a), sh) for a in arrays)


def sharded_point_step(info: ReductionInfo, H: int, W: int, mesh):
    """Build a jitted multi-chip Point-glyph ingest step.

    f(states, rows, cols, valid, values, weights, timestamps) -> states

    states: tuple of (H, W) f32 sharded P('sp', None); point arrays sharded
    P('dp'). Deltas accumulate locally per chip and merge over 'dp' with the
    op's collective; 'sp' needs no collective (each chip owns its rows).
    """
    jax, jnp = _jax()
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    kind = info.scatter_kind
    n_sp = mesh.shape["sp"]
    local_h = H // n_sp
    if local_h * n_sp != H:
        raise ValueError(f"grid height {H} not divisible by sp={n_sp}")

    def local(states, rows, cols, valid, values, weights, timestamps):
        sp_idx = jax.lax.axis_index("sp")
        row_off = sp_idx * local_h
        lrows = rows - row_off
        mine = valid & (lrows >= 0) & (lrows < local_h)
        lrows = jnp.where(mine, lrows, 0)
        lcols = jnp.where(mine, cols, 0)
        fields = info.fields(values, weights, timestamps)
        if kind == "sum":
            out = []
            for f, fv in enumerate(fields):
                fv = jnp.where(mine, fv, 0.0).astype(jnp.float32)
                delta = jnp.zeros_like(states[f]).at[lrows, lcols].add(fv)
                out.append(states[f] + jax.lax.psum(delta, "dp"))
            return tuple(out)
        if kind in ("max", "min"):
            ident = -FLT_MAX if kind == "max" else FLT_MAX
            fv = jnp.where(mine, fields[0], ident).astype(jnp.float32)
            delta = jnp.full_like(states[0], ident)
            delta = (delta.at[lrows, lcols].max(fv) if kind == "max"
                     else delta.at[lrows, lcols].min(fv))
            merged = (jax.lax.pmax(delta, "dp") if kind == "max"
                      else jax.lax.pmin(delta, "dp"))
            combine = jnp.maximum if kind == "max" else jnp.minimum
            return (combine(states[0], merged),)
        if kind == "argmax_ts":
            return _argmax_ts_sharded(jax, jnp, states, lrows, lcols, mine,
                                      fields[0], fields[1], local_h, W)
        raise NotImplementedError(kind)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(tuple(P("sp", None) for _ in range(info.state_floats)),
                  P("dp"), P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=tuple(P("sp", None) for _ in range(info.state_floats)),
    )
    return jax.jit(fn, donate_argnums=(0,))


def _argmax_ts_sharded(jax, jnp, states, lrows, lcols, mine, values, ts,
                       local_h, W):
    """MostRecent across chips: local 3-scatter argmax, then a
    (timestamp, device-id) lexicographic merge over 'dp'. Existing state
    wins timestamp ties; among chips the lowest dp index wins; within a
    chip the earliest point wins."""
    cur_v, cur_t = states
    n = lrows.shape[0]
    ts = jnp.where(mine, ts, -FLT_MAX).astype(jnp.float32)
    values = values.astype(jnp.float32)
    # local winner per cell
    m = jnp.full((local_h, W), -FLT_MAX, jnp.float32).at[lrows, lcols].max(ts)
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)[:, 0]
    big = jnp.int32(2**31 - 1)
    is_win = mine & (ts == m[lrows, lcols]) & (ts > -FLT_MAX)
    idxm = jnp.where(is_win, idx, big)
    widx = jnp.full((local_h, W), big, jnp.int32).at[lrows, lcols].min(idxm)
    final = is_win & (idx == widx[lrows, lcols])
    safe_r = jnp.where(final, lrows, local_h)
    loc_v = jnp.full((local_h, W), np.nan, jnp.float32).at[
        safe_r, lcols].set(values, mode="drop")
    # cross-chip: max ts wins, lowest dp index breaks ties
    gm = jax.lax.pmax(m, "dp")
    dp_idx = jax.lax.axis_index("dp")
    my_win = (m == gm) & (gm > -FLT_MAX)
    windev = jax.lax.pmin(jnp.where(my_win, dp_idx, big), "dp")
    contrib = jnp.where(my_win & (dp_idx == windev), loc_v, 0.0)
    gv = jax.lax.psum(contrib, "dp")
    # merge into carried state (strictly greater replaces)
    take = gm > cur_t
    return (jnp.where(take, gv, cur_v), jnp.where(take, gm, cur_t))


def sharded_gaussian_step(info: ReductionInfo, H: int, W: int, mesh,
                          block: int = 2048, cfg=None):
    """Multi-chip separable Gaussian splat (rotation-free): each chip runs
    the soft-one-hot matmul over its dp shard of points restricted to its
    sp row block, then deltas psum over 'dp'.

    f(states, icx, icy, sub_cx, sub_cy, sx, sy, r, valid, values) -> states

    When `cfg` (a GridConfig with multiple tiles) is given, footprints are
    additionally clipped to each point's home tile — the single-device
    TileRouter semantics, needed for Pipeline-level oracle parity.
    """
    jax, jnp = _jax()
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rtype = ReductionType(info.type)
    nf = 2 if rtype in (ReductionType.WeightedAverage,
                        ReductionType.Average) else 1
    use_val = rtype != ReductionType.Count
    n_sp = mesh.shape["sp"]
    local_h = H // n_sp
    multi_tile = cfg is not None and cfg.total_tiles() > 1

    def local(states, icx, icy, sub_cx, sub_cy, sx, sy, r, valid, values):
        sp_idx = jax.lax.axis_index("sp")
        row_off = (sp_idx * local_h).astype(jnp.int32)
        n = icx.shape[0]
        if n % block != 0:
            raise ValueError(
                f"per-shard point count {n} not divisible by block {block}; "
                "pad inputs to a multiple of block * mesh.shape['dp']")
        nb = n // block

        hs_i = jax.lax.broadcasted_iota(jnp.int32, (1, local_h), 1) + row_off
        ws_i = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)
        hs = hs_i.astype(jnp.float32)
        ws = ws_i.astype(jnp.float32)

        def body(carry, args):
            (bicx, bicy, bsub_cx, bsub_cy, bsx, bsy, br, bvalid, bval) = args
            rdy = (hs - bicy[:, None].astype(jnp.float32)) - bsub_cy[:, None]
            qy = rdy / bsy[:, None]
            wy = jnp.exp(-0.5 * qy * qy)
            my = (jnp.abs(hs_i - bicy[:, None]) <= br[:, None]) & (wy >= 1e-6)
            wy = jnp.where(my & bvalid[:, None], wy, 0.0)
            rdx = (ws - bicx[:, None].astype(jnp.float32)) - bsub_cx[:, None]
            qx = rdx / bsx[:, None]
            wx = jnp.exp(-0.5 * qx * qx)
            mx = (jnp.abs(ws_i - bicx[:, None]) <= br[:, None]) & (wx >= 1e-6)
            if multi_tile:
                from ..engine.tpu_backend import _device_tile_clip
                cs, ce, rs, re = _device_tile_clip(jnp, cfg, bicx, bicy)
                my &= (hs_i >= rs[:, None]) & (hs_i < re[:, None])
                mx &= (ws_i >= cs[:, None]) & (ws_i < ce[:, None])
                wy = jnp.where(my & bvalid[:, None], wy, 0.0)
            wx = jnp.where(mx, wx, 0.0)
            cols = ([wx * bval[:, None], wx] if nf == 2
                    else ([wx * bval[:, None]] if use_val else [wx]))
            colfac = jnp.concatenate(cols, axis=1) if len(cols) > 1 else cols[0]
            contrib = jax.lax.dot_general(
                wy, colfac, (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
            return tuple(carry[f] + contrib[:, f * W:(f + 1) * W]
                         for f in range(nf)), None

        def rb(a):
            return a[: nb * block].reshape(nb, block)

        zeros = tuple(
            _vary(jax, jnp.zeros((local_h, W), jnp.float32), ("dp", "sp"))
            for _ in range(nf))
        deltas, _ = jax.lax.scan(body, zeros, tuple(map(rb, (
            icx, icy, sub_cx, sub_cy, sx, sy, r, valid, values))))
        return tuple(states[f] + jax.lax.psum(deltas[f], "dp")
                     for f in range(nf))

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(tuple(P("sp", None) for _ in range(nf)),) + tuple(
            P("dp") for _ in range(9)),
        out_specs=tuple(P("sp", None) for _ in range(nf)),
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_gaussian_rotated_step(info: ReductionInfo, H: int, W: int, mesh,
                                  rmax: int, cfg=None):
    """Multi-chip exact rotated-Gaussian splat: each chip scatter-adds its
    dp shard of points over the (2*rmax+1)^2 offset window (reference
    semantics glyph_kernels.cu:145-176 incl. the 1e-6 cutoff), restricted
    to its sp row block; deltas psum over 'dp'.

    f(states, icx, icy, sub_cx, sub_cy, sx, sy, cos_rot, sin_rot, r,
      valid, values) -> states
    """
    jax, jnp = _jax()
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rtype = ReductionType(info.type)
    nf = 2 if rtype in (ReductionType.WeightedAverage,
                        ReductionType.Average) else 1
    use_val = rtype != ReductionType.Count
    n_sp = mesh.shape["sp"]
    local_h = H // n_sp
    multi_tile = cfg is not None and cfg.total_tiles() > 1

    def local(states, icx, icy, sub_cx, sub_cy, sx, sy, cos_rot, sin_rot,
              r, valid, values):
        sp_idx = jax.lax.axis_index("sp")
        row_off = (sp_idx * local_h).astype(jnp.int32)
        r = jnp.where(valid, r, -1)
        if multi_tile:
            from ..engine.tpu_backend import _device_tile_clip
            cs, ce, rs, re = _device_tile_clip(jnp, cfg, icx, icy)
        else:
            cs, ce, rs, re = 0, W, 0, H

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
            ly = gy - row_off
            ok = ((w >= 1e-6)
                  & (jnp.abs(dy) <= r) & (jnp.abs(dx) <= r)
                  & (gx >= cs) & (gx < ce) & (gy >= rs) & (gy < re)
                  & (ly >= 0) & (ly < local_h))
            w = jnp.where(ok, w, 0.0)
            lys = jnp.where(ok, ly, 0)
            gxs = jnp.where(ok, gx, 0)
            out = list(carry)
            out[0] = carry[0].at[lys, gxs].add(values * w if use_val else w)
            if nf == 2:
                out[1] = carry[1].at[lys, gxs].add(w)
            return tuple(out), None

        k = 2 * rmax + 1
        dys = jnp.repeat(jnp.arange(-rmax, rmax + 1, dtype=jnp.int32), k)
        dxs = jnp.tile(jnp.arange(-rmax, rmax + 1, dtype=jnp.int32), k)
        zeros = tuple(
            _vary(jax, jnp.zeros((local_h, W), jnp.float32), ("dp", "sp"))
            for _ in range(nf))
        deltas, _ = jax.lax.scan(body, zeros, (dys, dxs))
        return tuple(states[f] + jax.lax.psum(deltas[f], "dp")
                     for f in range(nf))

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(tuple(P("sp", None) for _ in range(nf)),) + tuple(
            P("dp") for _ in range(11)),
        out_specs=tuple(P("sp", None) for _ in range(nf)),
    )
    return jax.jit(fn, donate_argnums=(0,))


def sharded_line_step(info: ReductionInfo, H: int, W: int, mesh,
                      block: int = 2048):
    """Multi-chip Line-glyph splat in rect mode: line glyphs decompose on
    the host into exact Bresenham runs (routing.line_rects); each chip
    splats its dp shard of rectangles restricted to its sp row block as
    interval x interval rank-1 factors, then deltas psum over 'dp'.

    f(states, ax, bx, ay, by, valid, values) -> states

    ax/bx/ay/by: per-rect inclusive cell intervals (int32); values: the
    owning line's value gathered per rect. Empty intervals (ax > bx) are
    inert, so padding needs no mask.
    """
    jax, jnp = _jax()
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rtype = ReductionType(info.type)
    nf = 2 if rtype in (ReductionType.WeightedAverage,
                        ReductionType.Average) else 1
    use_val = rtype != ReductionType.Count
    n_sp = mesh.shape["sp"]
    local_h = H // n_sp

    def local(states, ax, bx, ay, by, valid, values):
        sp_idx = jax.lax.axis_index("sp")
        row_off = (sp_idx * local_h).astype(jnp.int32)
        n = ax.shape[0]
        if n % block != 0:
            raise ValueError(
                f"per-shard rect count {n} not divisible by block {block}; "
                "pad inputs to a multiple of block * mesh.shape['dp']")
        nb = n // block

        hs_i = jax.lax.broadcasted_iota(jnp.int32, (1, local_h), 1) + row_off
        ws_i = jax.lax.broadcasted_iota(jnp.int32, (1, W), 1)

        def body(carry, args):
            bax, bbx, bay, bby, bvalid, bval = args
            wy = ((hs_i >= bay[:, None]) & (hs_i <= bby[:, None])
                  & bvalid[:, None]).astype(jnp.float32)
            wx = ((ws_i >= bax[:, None])
                  & (ws_i <= bbx[:, None])).astype(jnp.float32)
            cols = ([wx * bval[:, None], wx] if nf == 2
                    else ([wx * bval[:, None]] if use_val else [wx]))
            colfac = (jnp.concatenate(cols, axis=1) if len(cols) > 1
                      else cols[0])
            contrib = jax.lax.dot_general(
                wy, colfac, (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
            return tuple(carry[f] + contrib[:, f * W:(f + 1) * W]
                         for f in range(nf)), None

        def rb(a):
            return a[: nb * block].reshape(nb, block)

        zeros = tuple(
            _vary(jax, jnp.zeros((local_h, W), jnp.float32), ("dp", "sp"))
            for _ in range(nf))
        deltas, _ = jax.lax.scan(body, zeros, tuple(map(rb, (
            ax, bx, ay, by, valid, values))))
        return tuple(states[f] + jax.lax.psum(deltas[f], "dp")
                     for f in range(nf))

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(tuple(P("sp", None) for _ in range(nf)),) + tuple(
            P("dp") for _ in range(6)),
        out_specs=tuple(P("sp", None) for _ in range(nf)),
    )
    return jax.jit(fn, donate_argnums=(0,))
