"""Hopper SDF tile kernel: Pallas through Triton.

The per-pixel work of the whole product. One program renders one row
of the tile table (`render.batch.plan_tiles`): TP consecutive pixels of
one glyph's bitmap, evaluated against that glyph's own segments only.
This is the same dense masked reduction as the plain reference
(`ops.sdf_jax._field_tile_pts`), which replaces the reference's
per-pixel R-tree query and crossing sweep
(`renderer_precise.rs:33-80`, see `ops/sdf_ref.py`):

- the grid is the tile table; each program loads its own 8-int row
  (x0, y0, w, h, npts, off, pix_base, _). Thousands of rows per group
  fill the SMs; skip rows (pix_base >= w*h) run a zero-trip loop and
  store zeros;
- the loop runs over the glyph's OWN segment count, ``step`` segments
  per iteration, so a small glyph never pays for the largest outline of
  its group (the plain version pads every tile to the group's L_max).
  Segment ``i`` is the point pair (i, i+1) of the flat ``[2, N]``
  chain, read with masked loads at lanes i and i+1; its validity bit
  comes from ``mask_words``;
- min-d² and the winding sum are reduced per pixel at every step, so
  a program holds O(TP) accumulators, not O(TP*step);
- the render mode quantizes in the kernel and stores uint8; the
  residual mode (the fit's forward) stores min-d², winding and the
  first argmin lane instead. One body serves both.

No matrix product is involved, so Hopper's wgmma/TMA machinery (the
Mosaic GPU route) buys nothing Triton cannot express here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import CUTOFF, SDF_RADIUS
from .sdf_jax import _BIG, _BIGI

# (segments per loop step, warps, pipeline stages) per program, for the
# render and residual modes: the fastest of a sweep over steps 4-32,
# 2-8 warps and 1-2 stages on the DejaVu Sans groups, on an H100
# (PERF.md). Most settings with 4+ warps and steps up to 16 land
# within a few per cent of these.
RENDER_CONFIG = (8, 8, 1)
RESIDUAL_CONFIG = (32, 8, 2)


def _tile_kernel(tm_ref, pts_ref, words_ref, *out_refs, tp, step, residual):
    t = pl.program_id(0)
    x0 = tm_ref[t, 0]
    y0 = tm_ref[t, 1]
    w = tm_ref[t, 2]
    h = tm_ref[t, 3]
    npts = tm_ref[t, 4]
    off = tm_ref[t, 5]
    base = tm_ref[t, 6]

    # Pixel decomposition exactly as the reference: i -> (i % w, i // w),
    # row-flipped (the PBF stores rows top-down).
    i = base + jax.lax.iota(jnp.int32, tp)
    ws = jnp.maximum(w, 1)
    row = jax.lax.div(i, ws)
    x = i - row * ws
    y = h - 1 - row
    pxc = (x0.astype(jnp.float32) + x.astype(jnp.float32) + 0.5)[:, None]
    pyc = (y0.astype(jnp.float32) + y.astype(jnp.float32) + 0.5)[:, None]

    last = off + npts - 1  # lanes [off, last) start the glyph's segments
    nseg = jnp.maximum(npts - 1, 0)
    live = base < w * h
    i32 = jnp.int32  # explicit: lax ops do not promote python ints
    nsteps = jnp.where(live, jax.lax.div(nseg + i32(step - 1), i32(step)), i32(0))
    lane = jax.lax.iota(jnp.int32, step)

    def terms(k):
        start = off + k * step
        lanes = start + lane
        inb = lanes < last
        vx = plgpu.load(pts_ref.at[0, pl.ds(start, step)], mask=inb, other=0.0)
        vy = plgpu.load(pts_ref.at[1, pl.ds(start, step)], mask=inb, other=0.0)
        wx = plgpu.load(pts_ref.at[0, pl.ds(start + 1, step)], mask=inb, other=0.0)
        wy = plgpu.load(pts_ref.at[1, pl.ds(start + 1, step)], mask=inb, other=0.0)
        word = plgpu.load(
            words_ref.at[jax.lax.shift_right_logical(lanes, i32(5))],
            mask=inb, other=i32(0),
        )
        bit = jax.lax.shift_right_logical(word, jnp.bitwise_and(lanes, i32(31)))
        ok = (inb & (jnp.bitwise_and(bit, i32(1)) != 0))[None, :]
        vx, vy, wx, wy = vx[None, :], vy[None, :], wx[None, :], wy[None, :]

        dx = wx - vx
        dy = wy - vy
        l2 = dx * dx + dy * dy
        l2inv = jnp.where(l2 > 0.0, 1.0 / l2, 0.0)
        dyinv = jnp.where(dy != 0.0, 1.0 / dy, 0.0)
        ex = pxc - vx
        ey = pyc - vy
        num = ex * dx + ey * dy
        tc = jnp.clip(num * l2inv, 0.0, 1.0)
        qx = ex - tc * dx
        qy = ey - tc * dy
        d2 = jnp.where(ok, qx * qx + qy * qy, _BIG)

        c1 = vy <= pyc
        cross = c1 ^ (wy <= pyc)
        cx = vx + (ey * dyinv) * dx
        hit = cross & (cx <= pxc) & ok
        sign = jnp.where(c1, i32(1), i32(-1))
        wn = jnp.sum(jnp.where(hit, sign, i32(0)), axis=1, dtype=i32)
        return lanes, d2, wn

    dmin0 = jnp.full((tp,), _BIG, jnp.float32)
    wn0 = jnp.zeros((tp,), jnp.int32)

    if not residual:
        (out_ref,) = out_refs

        def body(k, carry):
            dmin, wn = carry
            _, d2, dwn = terms(k)
            return jnp.minimum(dmin, jnp.min(d2, axis=1)), wn + dwn

        dmin, wn = jax.lax.fori_loop(0, nsteps, body, (dmin0, wn0))
        d = jnp.sqrt(dmin)
        sd = jnp.where(wn != 0, -d, d)
        v = sd * jnp.float32(256.0 / SDF_RADIUS) + jnp.float32(CUTOFF)
        n = jnp.clip(255.0 - v, 0.0, 255.0)
        byte = jnp.where(live, jnp.floor(n + 0.5), 0.0).astype(jnp.uint8)
        out_ref[...] = byte[None, :]
        return

    d2_ref, wn_ref, am_ref = out_refs

    def body_res(k, carry):
        dmin, amin, wn = carry
        lanes, d2, dwn = terms(k)
        m = jnp.min(d2, axis=1)
        li = jnp.min(
            jnp.where(d2 == m[:, None], lanes[None, :], i32(_BIGI)), axis=1
        )
        # Strictly-less keeps the earliest step on ties: the first
        # argmin lane overall, as the reference picks it.
        better = m < dmin
        return (
            jnp.where(better, m, dmin),
            jnp.where(better, li, amin),
            wn + dwn,
        )

    amin0 = jnp.full((tp,), _BIGI, jnp.int32)
    dmin, amin, wn = jax.lax.fori_loop(0, nsteps, body_res, (dmin0, amin0, wn0))
    d2_ref[...] = jnp.where(live, dmin, 0.0)[None, :]
    wn_ref[...] = jnp.where(live, wn, i32(0))[None, :]
    am_ref[...] = jnp.where(live, amin, i32(0))[None, :]


def _launch(pts, mask_words, tmeta, TP, residual, interpret, step, num_warps, num_stages):
    pts = pts.astype(jnp.float32)
    mask_words = mask_words.astype(jnp.int32)
    tmeta = tmeta.astype(jnp.int32)
    T = tmeta.shape[0]
    assert tmeta.shape[1] == 8, tmeta.shape

    def whole(a):
        return pl.BlockSpec(a.shape, lambda t: (0,) * a.ndim)

    row = pl.BlockSpec((1, TP), lambda t: (t, 0))
    if residual:
        out_shape = [
            jax.ShapeDtypeStruct((T, TP), jnp.float32),
            jax.ShapeDtypeStruct((T, TP), jnp.int32),
            jax.ShapeDtypeStruct((T, TP), jnp.int32),
        ]
        out_specs = [row] * 3
    else:
        out_shape = jax.ShapeDtypeStruct((T, TP), jnp.uint8)
        out_specs = row
    return pl.pallas_call(
        functools.partial(_tile_kernel, tp=TP, step=step, residual=residual),
        out_shape=out_shape,
        grid=(T,),
        in_specs=[whole(tmeta), whole(pts), whole(mask_words)],
        out_specs=out_specs,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="sdf_min_field" if residual else "sdf_render_tiles",
    )(tmeta, pts, mask_words)


@functools.partial(jax.jit, static_argnames=("TP", "interpret"))
def render_tiles(pts, mask_words, tmeta, TP: int = 256, interpret: bool = False):
    """Quantized uint8 bitmaps [T, TP] from the point-chain layout.

    pts [2, N] f32 (x/y rows), mask_words [N//32] i32 validity bits,
    tmeta [T, 8] i32 row-major tile table. Same contract as the plain
    reference `ops.sdf_jax.render_bitmaps_pts_jax`, without its lane
    slack or L_max window: loads are masked to the glyph's own lanes.
    Skip rows are zero."""
    return _launch(pts, mask_words, tmeta, TP, False, interpret, *RENDER_CONFIG)


@functools.partial(jax.jit, static_argnames=("TP", "interpret"))
def min_field_tiles(pts, mask_words, tmeta, TP: int = 256, interpret: bool = False):
    """Residual mode: (min-d² [T, TP] f32, winding [T, TP] i32, first
    argmin lane [T, TP] i32 — `_BIGI` where no segment is live). Same
    contract as `ops.sdf_jax.min_field_pts_jax`; skip rows are zero in
    every output."""
    return _launch(pts, mask_words, tmeta, TP, True, interpret, *RESIDUAL_CONFIG)
