"""Differentiable SDF over the flat point-chain layout.

The fitting path (`models/`) needs gradients of the per-pixel signed
distance w.r.t. the segment soup — the differentiable core of the
reference hot loop (`/root/reference/src/render/renderer_precise.rs:8-84`,
whose distance and crossing positions are piecewise-smooth in the
control points).

`signed_field_flat` factors the field so that no O(P·S) work is ever
differentiated: the tile field in residual mode (`ops.tiles.min_field`
— the Hopper kernel on a GPU, `min_field_pts_jax` on a CPU) is only an
ORACLE for the argmin lane and the winding number; the value and its
gradient come from an O(P) recompute at the argmin segment (gather →
pair math → scatter-add in reverse mode), in the exact op order of the
tile field, so the recomputed d² equals the oracle's bitwise.

Gradient semantics (a.e. exact, matching the jnp model path):

- distance: by the envelope theorem the clamped projection parameter
  ``tc`` is locally constant at the optimum, so with ``q = p − (v +
  tc·(w−v))`` the exact piecewise gradient of ``d² = |q|²`` is
  ``∂d²/∂v = 2q·(tc−1)``, ``∂d²/∂w = −2q·tc`` — the same values
  reverse-mode produces through the full ``t = (e·d)/|d|²`` chain
  (whose extra term carries ``q·(w−v) = 0`` at interior optima).
- min over segments: subgradient to the **first argmin lane** (the
  oracle records it), instead of `jnp.min`'s even tie split. Exact
  float ties across *differently computed* pair terms are measure-zero;
  where they do occur (a shared ring vertex as nearest point) the two
  conventions agree after chaining to the shared point.
- winding sign: piecewise constant → zero gradient, exactly like the
  jnp path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .sdf_jax import _BIG, _BIGI


def signed_field_flat(
    pts: jnp.ndarray,
    mask_words,
    tmeta,
    TP: int,
    L_max: int,
    impl: str,
) -> jnp.ndarray:
    """Differentiable signed-distance field over the flat point-chain
    layout.

    pts [2, N] f32 (live parameters; segment i = points (i, i+1) where
    the mask bit is set), mask_words [N//32] i32, tmeta [T, 8] i32
    row-major tile table (`models.fitting.build_flat_plan`), L_max =
    the reference's lane window, ``impl`` = `utils.device.tile_impl` of
    the platform the arrays live on. Returns sd [T, TP] f32 — negative
    inside; rows of padding tiles are garbage (mask them). Gradients
    flow to ``pts`` through the argmin recompute; the winding sign is
    piecewise constant (int — no cotangent by construction).
    """
    from .tiles import min_field

    N = pts.shape[1]
    pts_ng = jax.lax.stop_gradient(pts)
    d2k, wn, am = min_field(pts_ng, mask_words, tmeta, TP, L_max, impl)
    del d2k  # value comes from the bitwise-equal recompute below

    sentinel = am == _BIGI
    a = jnp.clip(am, 0, N - 2)
    v = jnp.take(pts, a, axis=1)  # [2, T, TP]
    w = jnp.take(pts, a + 1, axis=1)

    # Pixel centers, same decomposition as the tile field.
    tm = tmeta.astype(jnp.int32)
    x0 = tm[:, 0:1]
    y0 = tm[:, 1:2]
    ww = tm[:, 2:3]
    h = tm[:, 3:4]
    base = tm[:, 6:7]
    i = base + jnp.arange(TP, dtype=jnp.int32)[None, :]
    ws = jnp.maximum(ww, 1)
    x = i % ws
    row = i // ws
    y = h - 1 - row
    pxc = x0.astype(jnp.float32) + x.astype(jnp.float32) + 0.5
    pyc = y0.astype(jnp.float32) + y.astype(jnp.float32) + 0.5

    # The tile field's exact projection op order (bitwise-equal d²).
    vx, vy = v[0], v[1]
    wx, wy = w[0], w[1]
    dx = wx - vx
    dy = wy - vy
    l2 = dx * dx + dy * dy
    l2_safe = jnp.where(l2 > 0.0, l2, 1.0)
    l2inv = jnp.where(l2 > 0.0, 1.0 / l2_safe, 0.0)
    ex = pxc - vx
    ey = pyc - vy
    num = ex * dx + ey * dy
    t = num * l2inv
    tc = jnp.clip(t, 0.0, 1.0)
    qx = ex - tc * dx
    qy = ey - tc * dy
    d2 = qx * qx + qy * qy
    d2 = jnp.where(sentinel, _BIG, d2)

    d = jnp.sqrt(jnp.maximum(d2, 1e-12))
    sgn = jnp.where(wn != 0, -1.0, 1.0)
    return sgn * d
