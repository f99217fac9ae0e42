"""Batched, jittable, differentiable SDF evaluation in pure JAX.

This is the plain reference of the Hopper tile kernel
(`ops/sdf_triton.py`), the CPU execution path, and the autodiff path
of the framework. It
evaluates, for a batch of glyphs, the per-pixel signed distance to a
padded segment soup plus the winding-number sign — the same math as the
reference hot loop (`/root/reference/src/render/renderer_precise.rs`)
re-expressed as masked reductions over fixed shapes:

- distances/winding are masked sums/mins over ALL padded segments
  (``seg index < nseg``) — no R-tree, no sorted sweep (see
  `ops/sdf_ref.py` for the proof of equivalence);
- the pixel lattice is a flat padded axis; coordinates derive from the
  index via integer ops, producing the PBF's Y-flipped order directly.

Segment layout (packed on host by `render.batch.pack_segments`):
``segs[G, 8, S]`` float32 rows ``VX, VY, DX, DY, L2INV, DYINV, WY`` and
one spare — precomputed so the inner loop is pure fused elementwise work.

Everything here is differentiable w.r.t. ``segs``; `models/` uses
`signed_distance_batch` (the pre-quantization field) as the loss head,
since the byte quantization is a straight-through staircase.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import CUTOFF, SDF_RADIUS

# Component row indices in the packed [G, 8, S] segment tensor.
VX, VY, DX, DY, L2INV, DYINV, WY, _SPARE = range(8)

_BIG = 3.0e38  # ~f32 max; stands in for +inf distance of masked segments
_BIGI = 2147483647  # i32 max: argmin sentinel where no segment is live


def pixel_coords(meta: jnp.ndarray, P: int):
    """Pixel-center coordinates for the flat padded pixel axis.

    ``meta`` is ``[5]`` int32: ``x0, y0, w, h, nseg``. Output index ``i``
    corresponds to bitmap position ``(x, row) = (i % w, i // w)`` with
    render row ``y = h - 1 - row`` (the reference stores Y-flipped:
    `renderer_precise.rs:78`), so ``px = x0 + x + 0.5``,
    ``py = y0 + y + 0.5``. Returns (px, py, valid)."""
    x0, y0, w, h = meta[0], meta[1], meta[2], meta[3]
    i = jnp.arange(P, dtype=jnp.int32)
    ws = jnp.maximum(w, 1)
    x = i % ws
    row = i // ws
    y = h - 1 - row
    px = x0.astype(jnp.float32) + x.astype(jnp.float32) + 0.5
    py = y0.astype(jnp.float32) + y.astype(jnp.float32) + 0.5
    valid = i < w * h
    return px, py, valid


def _field_one(segs: jnp.ndarray, meta: jnp.ndarray, P: int):
    """Signed distance field for one glyph: segs [8, S], meta [5] i32.

    Returns float32 [P] signed distances (negative inside), using the
    exact projection/crossing formulas of the reference in f32."""
    px, py, _ = pixel_coords(meta, P)
    nseg = meta[4]
    S = segs.shape[-1]

    vx = segs[VX][None, :]
    vy = segs[VY][None, :]
    dx = segs[DX][None, :]
    dy = segs[DY][None, :]
    l2inv = segs[L2INV][None, :]
    dyinv = segs[DYINV][None, :]
    wy = segs[WY][None, :]
    seg_ok = (jnp.arange(S, dtype=jnp.int32) < nseg)[None, :]

    pxc = px[:, None]
    pyc = py[:, None]

    ex = pxc - vx
    ey = pyc - vy
    num = ex * dx + ey * dy
    t = num * l2inv
    tc = jnp.clip(t, 0.0, 1.0)
    qx = ex - tc * dx
    qy = ey - tc * dy
    d2 = qx * qx + qy * qy
    d2 = jnp.where(seg_ok, d2, _BIG)
    dmin2 = jnp.min(d2, axis=1)

    up = (vy <= pyc) & (wy > pyc)
    dn = (vy > pyc) & (wy <= pyc)
    tcr = ey * dyinv
    cx = vx + tcr * dx
    sign = up.astype(jnp.int32) - dn.astype(jnp.int32)
    hit = (cx <= pxc) & seg_ok & (up | dn)
    wn = jnp.sum(jnp.where(hit, sign, 0), axis=1)

    d = jnp.sqrt(dmin2)
    return jnp.where(wn != 0, -d, d)


def make_signed_distance_fn(P: int, sequential: bool = False):
    """Build a jittable ``(segs [G,8,S], meta [G,5]) -> sdf [G,P]``.

    ``sequential=True`` maps glyphs with `lax.map` (bounding the
    [P, S] temporary to one glyph — the memory-safe choice for big
    blocks); otherwise vmap (fastest for small batches)."""

    def one(args):
        segs, meta = args
        return _field_one(segs, meta, P)

    def fn(segs, meta):
        if sequential:
            return jax.lax.map(one, (segs, meta))
        return jax.vmap(lambda s, m: _field_one(s, m, P))(segs, meta)

    return fn


def _field_one_flat(flat, meta, P: int, S_max: int):
    """Signed distance field for one glyph from the kernel's flat
    segment layout: flat [4, N] f32 (vx, vy, wx, wy rows), meta [8] i32
    (x0, y0, w, h, nseg, seg_off, _, _). Derived components are
    computed in f32 in the same op order as the tile paths."""
    px, py, _ = pixel_coords(meta, P)
    nseg = meta[4]
    off = meta[5]

    sl = jax.lax.dynamic_slice(flat, (jnp.int32(0), off), (4, S_max))
    vx = sl[0][None, :]
    vy = sl[1][None, :]
    wx = sl[2][None, :]
    wy = sl[3][None, :]
    dx = wx - vx
    dy = wy - vy
    l2 = dx * dx + dy * dy
    l2inv = jnp.where(l2 > 0.0, 1.0 / l2, 0.0)
    dyinv = jnp.where(dy != 0.0, 1.0 / dy, 0.0)
    seg_ok = (jnp.arange(S_max, dtype=jnp.int32) < nseg)[None, :]

    pxc = px[:, None]
    pyc = py[:, None]
    ex = pxc - vx
    ey = pyc - vy
    num = ex * dx + ey * dy
    t = num * l2inv
    tc = jnp.clip(t, 0.0, 1.0)
    qx = ex - tc * dx
    qy = ey - tc * dy
    d2 = qx * qx + qy * qy
    d2 = jnp.where(seg_ok, d2, _BIG)
    dmin2 = jnp.min(d2, axis=1)

    up = (vy <= pyc) & (wy > pyc)
    dn = (vy > pyc) & (wy <= pyc)
    tcr = ey * dyinv
    cx = vx + tcr * dx
    sign = up.astype(jnp.int32) - dn.astype(jnp.int32)
    hit = (cx <= pxc) & seg_ok & (up | dn)
    wn = jnp.sum(jnp.where(hit, sign, 0), axis=1)

    d = jnp.sqrt(dmin2)
    return jnp.where(wn != 0, -d, d)


def _field_tile_flat(flat, tmeta, TP: int, S_max: int):
    """Signed distances for one tile row of the flat tile table:
    tmeta [8] i32 = x0, y0, w, h, nseg, seg_off, pix_base, _ (see
    `render.batch.plan_tiles`) over the 4-row flat segment layout."""
    x0, y0, w, h = tmeta[0], tmeta[1], tmeta[2], tmeta[3]
    nseg, off, base = tmeta[4], tmeta[5], tmeta[6]

    i = base + jnp.arange(TP, dtype=jnp.int32)
    ws = jnp.maximum(w, 1)
    x = i % ws
    row = i // ws
    y = h - 1 - row
    px = x0.astype(jnp.float32) + x.astype(jnp.float32) + 0.5
    py = y0.astype(jnp.float32) + y.astype(jnp.float32) + 0.5

    sl = jax.lax.dynamic_slice(flat, (jnp.int32(0), off), (4, S_max))
    vx = sl[0][None, :]
    vy = sl[1][None, :]
    wx = sl[2][None, :]
    wy = sl[3][None, :]
    dx = wx - vx
    dy = wy - vy
    l2 = dx * dx + dy * dy
    l2inv = jnp.where(l2 > 0.0, 1.0 / l2, 0.0)
    dyinv = jnp.where(dy != 0.0, 1.0 / dy, 0.0)
    seg_ok = (jnp.arange(S_max, dtype=jnp.int32) < nseg)[None, :]

    pxc = px[:, None]
    pyc = py[:, None]
    ex = pxc - vx
    ey = pyc - vy
    num = ex * dx + ey * dy
    t = num * l2inv
    tc = jnp.clip(t, 0.0, 1.0)
    qx = ex - tc * dx
    qy = ey - tc * dy
    d2 = qx * qx + qy * qy
    d2 = jnp.where(seg_ok, d2, _BIG)
    dmin2 = jnp.min(d2, axis=1)

    # Same crossing-parity form as the point-chain tile paths.
    c1 = vy <= pyc
    cross = c1 ^ (wy <= pyc)
    tcr = ey * dyinv
    cx = vx + tcr * dx
    hit = cross & (cx <= pxc) & seg_ok
    sign = jnp.where(c1, jnp.int32(1), jnp.int32(-1))
    wn = jnp.sum(jnp.where(hit, sign, 0), axis=1)

    d = jnp.sqrt(dmin2)
    sd = jnp.where(wn != 0, -d, d)
    # Padding rows (w·h = 0) must yield zero bytes like the kernel skip.
    return jnp.where(base < w * h, sd, _BIG)


def _field_tile_pts(pts, mask_words, tmeta, TP: int, L_max: int):
    """Signed distances for one tile row of the point-chain layout:
    tmeta [8] i32 = x0, y0, w, h, npts, off, pix_base, _. The plain
    reference of `ops/sdf_triton._tile_kernel` (segment i = points
    (i, i+1), valid iff mask bit i is set and i in [off, off+npts-1)),
    over a fixed window of L_max segments."""
    x0, y0, w, h = tmeta[0], tmeta[1], tmeta[2], tmeta[3]
    npts, off, base = tmeta[4], tmeta[5], tmeta[6]

    i = base + jnp.arange(TP, dtype=jnp.int32)
    ws = jnp.maximum(w, 1)
    x = i % ws
    row = i // ws
    y = h - 1 - row
    px = x0.astype(jnp.float32) + x.astype(jnp.float32) + 0.5
    py = y0.astype(jnp.float32) + y.astype(jnp.float32) + 0.5

    sl = jax.lax.dynamic_slice(pts, (jnp.int32(0), off), (2, L_max + 1))
    vx = sl[0, :L_max][None, :]
    vy = sl[1, :L_max][None, :]
    wx = sl[0, 1:][None, :]
    wy = sl[1, 1:][None, :]

    lane_abs = off + jnp.arange(L_max, dtype=jnp.int32)
    lane_words = mask_words[
        jax.lax.shift_right_logical(lane_abs, jnp.int32(5))
    ].astype(jnp.int32)
    bits = jnp.bitwise_and(
        jax.lax.shift_right_logical(
            lane_words, jnp.bitwise_and(lane_abs, jnp.int32(31))
        ),
        jnp.int32(1),
    )
    seg_ok = ((bits != 0) & (lane_abs < off + npts - 1))[None, :]

    dx = wx - vx
    dy = wy - vy
    l2 = dx * dx + dy * dy
    l2inv = jnp.where(l2 > 0.0, 1.0 / l2, 0.0)
    dyinv = jnp.where(dy != 0.0, 1.0 / dy, 0.0)

    pxc = px[:, None]
    pyc = py[:, None]
    ex = pxc - vx
    ey = pyc - vy
    num = ex * dx + ey * dy
    t = num * l2inv
    tc = jnp.clip(t, 0.0, 1.0)
    qx = ex - tc * dx
    qy = ey - tc * dy
    d2 = qx * qx + qy * qy
    d2 = jnp.where(seg_ok, d2, _BIG)
    dmin2 = jnp.min(d2, axis=1)

    c1 = vy <= pyc
    cross = c1 ^ (wy <= pyc)
    tcr = ey * dyinv
    cx = vx + tcr * dx
    hit = cross & (cx <= pxc) & seg_ok
    sign = jnp.where(c1, jnp.int32(1), jnp.int32(-1))
    wn = jnp.sum(jnp.where(hit, sign, 0), axis=1)

    d = jnp.sqrt(dmin2)
    sd = jnp.where(wn != 0, -d, d)
    return jnp.where(base < w * h, sd, _BIG)


@functools.partial(jax.jit, static_argnames=("TP", "L_max", "batch_size"))
def render_bitmaps_pts_jax(
    pts, mask_words, tmeta, TP: int, L_max: int, batch_size: int | None = None
):
    """Quantized uint8 bitmaps [T, TP] from the point-chain layout
    (same inputs/output as `ops.sdf_triton.render_tiles`, plus the i16
    fixed-point transport). The caller must guarantee
    ``off + L_max + 1 <= N`` for every row (pack_points slack).
    ``batch_size`` tiles are evaluated per `lax.map` step (default one:
    the memory-safe sequential map)."""
    if pts.dtype == jnp.int16:
        from ..render.metrics import Q16_SCALE

        pts = pts.astype(jnp.float32) * jnp.float32(1.0 / Q16_SCALE)
    pts = pts.astype(jnp.float32)
    tmeta = tmeta.astype(jnp.int32)

    def one(m):
        return quantize_sdf(_field_tile_pts(pts, mask_words, m, TP, L_max))

    return jax.lax.map(one, tmeta, batch_size=batch_size)


@functools.partial(jax.jit, static_argnames=("TP", "S_max"))
def render_bitmaps_tiles_jax(flat, tmeta, TP: int, S_max: int):
    """Quantized uint8 bitmaps [T, TP] from the flat tile table over
    the 4-row segment layout. Sequential over tiles to bound the
    [TP, S_max] temporary. The caller must guarantee
    ``seg_off + S_max <= N`` for every row."""
    flat = flat.astype(jnp.float32)
    tmeta = tmeta.astype(jnp.int32)

    def one(m):
        return quantize_sdf(_field_tile_flat(flat, m, TP, S_max))

    return jax.lax.map(one, tmeta)


@functools.partial(jax.jit, static_argnames=("P", "S_max"))
def render_bitmaps_flat_jax(flat, meta, P: int, S_max: int):
    """Quantized uint8 bitmaps [G, P] from the flat segment layout.
    Sequential over glyphs to bound the [P, S_max] temporary. The caller must guarantee
    ``seg_off + S_max <= N`` for every glyph (pad the flat array)."""
    flat = flat.astype(jnp.float32)
    meta = meta.astype(jnp.int32)

    def one(m):
        return quantize_sdf(_field_one_flat(flat, m, P, S_max))

    return jax.lax.map(one, meta)


def quantize_sdf(sdf: jnp.ndarray) -> jnp.ndarray:
    """SDF → byte: ``clamp(255 - (d·256/8 + 64), 0, 255)`` rounded half
    away from zero (`renderer_precise.rs:75-79`). Returns uint8."""
    v = sdf * jnp.float32(256.0 / SDF_RADIUS) + jnp.float32(CUTOFF)
    n = jnp.clip(255.0 - v, 0.0, 255.0)
    return jnp.floor(n + 0.5).astype(jnp.uint8)


def render_bitmaps_jax(segs, meta, P: int, sequential: bool = True):
    """Quantized uint8 bitmaps [G, P] for a packed glyph batch."""
    sdf = make_signed_distance_fn(P, sequential=sequential)(segs, meta)
    return quantize_sdf(sdf)


def _min_field_tile_pts(pts, mask_words, tmeta, TP: int, L_max: int):
    """Residual twin of `_field_tile_pts` for the differentiable path:
    returns (min-d², winding, global argmin lane) for one tile row —
    the reference of the kernel's residual mode (first-argmin tie
    rule; `_BIGI` sentinel where no live segment; skip tiles
    all-zero)."""
    x0, y0, w, h = tmeta[0], tmeta[1], tmeta[2], tmeta[3]
    npts, off, base = tmeta[4], tmeta[5], tmeta[6]

    i = base + jnp.arange(TP, dtype=jnp.int32)
    ws = jnp.maximum(w, 1)
    x = i % ws
    row = i // ws
    y = h - 1 - row
    px = x0.astype(jnp.float32) + x.astype(jnp.float32) + 0.5
    py = y0.astype(jnp.float32) + y.astype(jnp.float32) + 0.5

    sl = jax.lax.dynamic_slice(pts, (jnp.int32(0), off), (2, L_max + 1))
    vx = sl[0, :L_max][None, :]
    vy = sl[1, :L_max][None, :]
    wx = sl[0, 1:][None, :]
    wy = sl[1, 1:][None, :]

    lane_abs = off + jnp.arange(L_max, dtype=jnp.int32)
    lane_words = mask_words[
        jax.lax.shift_right_logical(lane_abs, jnp.int32(5))
    ].astype(jnp.int32)
    bits = jnp.bitwise_and(
        jax.lax.shift_right_logical(
            lane_words, jnp.bitwise_and(lane_abs, jnp.int32(31))
        ),
        jnp.int32(1),
    )
    seg_ok = ((bits != 0) & (lane_abs < off + npts - 1))[None, :]

    dx = wx - vx
    dy = wy - vy
    l2 = dx * dx + dy * dy
    l2inv = jnp.where(l2 > 0.0, 1.0 / l2, 0.0)
    dyinv = jnp.where(dy != 0.0, 1.0 / dy, 0.0)

    pxc = px[:, None]
    pyc = py[:, None]
    ex = pxc - vx
    ey = pyc - vy
    num = ex * dx + ey * dy
    t = num * l2inv
    tc = jnp.clip(t, 0.0, 1.0)
    qx = ex - tc * dx
    qy = ey - tc * dy
    d2 = qx * qx + qy * qy
    d2 = jnp.where(seg_ok, d2, _BIG)
    dmin2 = jnp.min(d2, axis=1)
    amin = jnp.min(
        jnp.where(d2 == dmin2[:, None], lane_abs[None, :], _BIGI), axis=1
    )
    amin = jnp.where(dmin2 < _BIG, amin, _BIGI)

    c1 = vy <= pyc
    cross = c1 ^ (wy <= pyc)
    tcr = ey * dyinv
    cx = vx + tcr * dx
    hit = cross & (cx <= pxc) & seg_ok
    sign = jnp.where(c1, jnp.int32(1), jnp.int32(-1))
    wn = jnp.sum(jnp.where(hit, sign, 0), axis=1)

    live = base < w * h
    return (
        jnp.where(live, dmin2, 0.0),
        jnp.where(live, wn, 0),
        jnp.where(live, amin, 0),
    )


@functools.partial(jax.jit, static_argnames=("TP", "L_max", "batch_size"))
def min_field_pts_jax(
    pts, mask_words, tmeta, TP: int, L_max: int, batch_size: int | None = None
):
    """Min-distance residuals from the point-chain layout (same
    contract as `ops.sdf_triton.min_field_tiles`). Returns (dmin2
    [T, TP] f32, wn [T, TP] i32, amin [T, TP] i32)."""
    pts = pts.astype(jnp.float32)
    tmeta = tmeta.astype(jnp.int32)

    def one(m):
        return _min_field_tile_pts(pts, mask_words, m, TP, L_max)

    return jax.lax.map(one, tmeta, batch_size=batch_size)
