"""The SDF tile field on a device: wire decode, tile table, and the
choice between the Hopper kernel and the plain reference.

``impl`` (`utils.device.tile_impl`) names the implementation for the
platform the arrays live on: ``"kernel"`` is the Pallas/Triton kernel
(`ops.sdf_triton`, GPU), ``"reference"`` the plain jnp version
(`ops.sdf_jax`, CPU). Both take the same point-chain layout and tile
table and give the same bytes; the reference additionally needs the
static lane window ``L_max`` (the bucketed largest glyph of the group),
which the kernel ignores — callers pass it either way and it is
normalized out of the kernel's compile key here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..render.metrics import Q16_SCALE
from .sdf_jax import min_field_pts_jax, render_bitmaps_pts_jax

IMPLS = ("kernel", "reference")


def reconstruct_delta(deltas: jnp.ndarray, anchors: jnp.ndarray) -> jnp.ndarray:
    """Decode the i8-delta wire format back to exact q16 i32 positions.

    deltas: [2, N] i8 lane-to-lane diffs of the q16 chain (0 at anchor
    lanes); anchors: [3, K] i32 — row 0 the anchor lane index, rows
    1-2 the true x/y delta there (padding columns (0, 0, 0) are no-op
    adds). One sparse scatter-add (K ≈ 1-3% of N) plus one cumsum
    reconstructs positions **bit-identical** to `GlyphPrep.chain16`,
    so the i16 transport's parity argument carries over unchanged.
    Runs inside the caller's jit, on the device.
    """
    full = deltas.astype(jnp.int32)
    full = full.at[:, anchors[0]].add(anchors[1:3])
    return jnp.cumsum(full, axis=1)


def derive_tmeta(meta: jnp.ndarray, TP: int, T_pad: int) -> jnp.ndarray:
    """Build the [T_pad, 8] tile table on device from the per-glyph
    meta [G, 8] (`render.batch.pack_points` layout) — the table is pure
    derived data, so only the ~8× smaller glyph rows are uploaded.
    Matches `render.batch.plan_tiles` row for row over the first T_used
    rows; padding rows (clipped/padded by `jnp.repeat`) land on
    pix_base ≥ w·h and are skipped."""
    G = meta.shape[0]
    w = meta[:, 2]
    h = meta[:, 3]
    ntiles = jnp.maximum(1, -(-(w * h) // TP))
    starts = jnp.concatenate(
        [jnp.zeros(1, ntiles.dtype), jnp.cumsum(ntiles)[:-1]]
    )
    g_of_tile = jnp.repeat(
        jnp.arange(G, dtype=jnp.int32), ntiles, total_repeat_length=T_pad
    )
    pix_base = (
        jnp.arange(T_pad, dtype=jnp.int32) - starts[g_of_tile]
    ) * jnp.int32(TP)
    return meta[g_of_tile].at[:, 6].set(pix_base.astype(jnp.int32))


def _check(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown tile implementation {impl!r}")


def render_field(pts, words, tmeta, TP: int, L_max: int, impl: str):
    """uint8 bitmaps [T, TP] of a f32 point chain (traced helper)."""
    _check(impl)
    if impl == "kernel":
        from .sdf_triton import render_tiles

        return render_tiles(pts, words, tmeta, TP)
    return render_bitmaps_pts_jax(pts, words, tmeta, TP, L_max)


@functools.partial(jax.jit, static_argnames=("TP", "L_max", "impl"))
def _render_pts(pts, words, tmeta, TP, L_max, impl):
    if pts.dtype == jnp.int16:
        pts = pts.astype(jnp.float32) * jnp.float32(1.0 / Q16_SCALE)
    return render_field(pts, words, tmeta, TP, L_max, impl)


def render_pts(pts, words, tmeta, TP: int, L_max: int, impl: str):
    """One dispatch: dequantize (i16 transport) and render.

    pts [2, N] f32 or i16 q16 fixed point, words [N//32] i32 validity
    bits, tmeta [T, 8] i32 (`render.batch.plan_tiles`). Returns [T, TP]
    uint8."""
    return _render_pts(
        pts, words, tmeta, TP, L_max if impl == "reference" else 0, impl
    )


@functools.partial(jax.jit, static_argnames=("TP", "T_pad", "L_max", "impl"))
def _render_delta(deltas, words, anchors, meta, TP, T_pad, L_max, impl):
    q = reconstruct_delta(deltas, anchors)
    pts = q.astype(jnp.float32) * jnp.float32(1.0 / Q16_SCALE)
    tmeta = derive_tmeta(meta, TP, T_pad)
    return render_field(pts, words, tmeta, TP, L_max, impl)


def render_delta(deltas, words, anchors, meta, TP: int, T_pad: int, L_max: int, impl: str):
    """One dispatch over the i8-delta wire format (the default
    transport): `reconstruct_delta` + `derive_tmeta` + the tile field.
    Inputs are the `render.batch.pack_points_delta` arrays; the output
    matches `render_pts` on the i16 transport byte for byte."""
    return _render_delta(
        deltas, words, anchors, meta, TP, T_pad,
        L_max if impl == "reference" else 0, impl,
    )


def min_field(pts, words, tmeta, TP: int, L_max: int, impl: str):
    """Residuals (min-d² [T, TP] f32, winding [T, TP] i32, first argmin
    lane [T, TP] i32) of a f32 point chain — the fit's forward."""
    _check(impl)
    if impl == "kernel":
        from .sdf_triton import min_field_tiles

        return min_field_tiles(pts, words, tmeta, TP)
    return min_field_pts_jax(pts, words, tmeta, TP, L_max)
