"""Differentiable flat tile field (`ops/sdf_grad.signed_field_flat`):
forward parity with the jnp model, gradient parity with jnp autodiff,
finite differences, and the tile-field fitting path (SURVEY §7 step 5;
reference differentiable core:
`/root/reference/src/render/renderer_precise.rs:8-84`).

Runs the plain reference field on the CPU backend (conftest pins CPU);
on the card the same path runs the kernel's residual mode
(chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from versatiles_glyphs_tpu.models.glyph_model import sdf_field
from versatiles_glyphs_tpu.ops.sdf_grad import signed_field_flat
from versatiles_glyphs_tpu.render.batch import S_BUCKETS, bucket

TP = 256


def _grid(x0, y0, w, h, P):
    i = np.arange(P)
    x = i % w
    y = h - 1 - i // w
    return (
        (x0 + x + 0.5).astype(np.float32),
        (y0 + y + 0.5).astype(np.float32),
    )


def _flat_field(segs, mask, meta, P):
    """`signed_field_flat` over a [B, S, 4] segment soup: every live
    segment becomes its own 2-point chain (v lane valid, w lane a chain
    break), glyph runs back to back. Returns sd [B, P], differentiable
    in ``segs``."""
    B, S, _ = segs.shape
    m = np.asarray(mask) != 0
    meta_np = np.asarray(meta).astype(np.int64)
    lanes, offs, npts = [], [], []
    n = 0
    for b in range(B):
        live = np.flatnonzero(m[b])
        offs.append(n)
        npts.append(2 * len(live))
        lanes.append(n + 2 * np.arange(len(live)))
        n += 2 * len(live)
    L_max = bucket(max(max(npts), 1), S_BUCKETS)
    N = -(-(n + L_max + 1) // 128) * 128
    valid = np.zeros(N, np.uint8)
    for b in range(B):
        valid[lanes[b]] = 1
    words = np.packbits(valid, bitorder="little").view("<u4").view(np.int32)
    ntiles = -(-P // TP)
    tmeta = np.zeros((B * ntiles, 8), np.int32)
    for b in range(B):
        for t in range(ntiles):
            tmeta[b * ntiles + t] = (
                *meta_np[b, :4], npts[b], offs[b], t * TP, 0
            )
    v_idx = np.concatenate(lanes)
    live_bs = np.argwhere(m)
    seg_live = segs[live_bs[:, 0], live_bs[:, 1]]  # [n_live, 4]
    pts = jnp.zeros((2, N), jnp.float32)
    pts = pts.at[:, v_idx].set(seg_live[:, 0:2].T)
    pts = pts.at[:, v_idx + 1].set(seg_live[:, 2:4].T)
    sd = signed_field_flat(
        pts, jnp.asarray(words), jnp.asarray(tmeta), TP, L_max, "reference"
    )
    return sd.reshape(B, ntiles * TP)[:, :P]


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(7)
    B, S, w, h = 4, 70, 19, 23
    segs = rng.uniform(-2.0, 22.0, size=(B, S, 4)).astype(np.float32)
    mask = (rng.uniform(size=(B, S)) > 0.15).astype(np.float32)
    meta = np.tile(np.array([[-3, -3, w, h]], np.float32), (B, 1))
    return jnp.asarray(segs), jnp.asarray(mask), jnp.asarray(meta), w, h


def _jnp_fields(segs, mask, meta, P):
    out = []
    for b in range(segs.shape[0]):
        x0, y0, w, h = (int(v) for v in np.asarray(meta[b][:4]))
        px, py = _grid(x0, y0, w, h, P)
        out.append(
            sdf_field(segs[b], mask[b] != 0, jnp.asarray(px), jnp.asarray(py))
        )
    return jnp.stack(out)


def test_forward_matches_jnp_model(soup):
    segs, mask, meta, w, h = soup
    P = w * h
    sd = _flat_field(segs, mask, meta, P)
    ref = _jnp_fields(segs, mask, meta, P)
    np.testing.assert_allclose(np.asarray(sd), np.asarray(ref), atol=2e-6)


def test_grad_matches_jnp_autodiff(soup):
    segs, mask, meta, w, h = soup
    P = w * h
    rng = np.random.default_rng(3)
    wts = jnp.asarray(rng.normal(size=(segs.shape[0], P)).astype(np.float32))

    gk = jax.grad(lambda s: jnp.sum(_flat_field(s, mask, meta, P) * wts))(segs)
    gj = jax.grad(lambda s: jnp.sum(_jnp_fields(s, mask, meta, P) * wts))(segs)
    scale = float(jnp.max(jnp.abs(gj)))
    delta = np.abs(np.asarray(gk) - np.asarray(gj))
    # The two backends pick different (equally valid) subgradients at
    # exact f32 distance ties: jnp.min even-splits, the flat field
    # routes to the first argmin lane. Ties are rare — bound the
    # fraction and the worst deviation instead of demanding elementwise
    # equality.
    assert (delta > 5e-5 * scale).mean() < 0.01
    assert delta.max() < 5e-3 * scale


def test_grad_finite_differences(soup):
    segs, mask, meta, w, h = soup
    P = w * h
    rng = np.random.default_rng(11)
    wts = jnp.asarray(rng.normal(size=(segs.shape[0], P)).astype(np.float32))

    def loss(s):
        return jnp.sum(_flat_field(s, mask, meta, P) * wts)

    g = jax.grad(loss)(segs)
    v = jnp.asarray(rng.normal(size=segs.shape).astype(np.float32))
    v = v / jnp.linalg.norm(v)
    eps = 1e-2
    fd = (loss(segs + eps * v) - loss(segs - eps * v)) / (2 * eps)
    an = jnp.vdot(g, v)
    assert abs(float(fd) - float(an)) < 5e-3 * max(abs(float(fd)), 1.0)


def test_winding_sign_inside_negative():
    # 4x4 square centred in a 10x10 grid (the digit-art golden's shape,
    # `renderer_precise.rs:95-135`): interior pixels must come out
    # negative, exterior positive, with zero gradient from the sign.
    sq = np.array(
        [[3, 3, 3, 7], [3, 7, 7, 7], [7, 7, 7, 3], [7, 3, 3, 3]], np.float32
    )
    segs = jnp.asarray(sq[None])
    mask = jnp.ones((1, 4), jnp.float32)
    meta = jnp.asarray(np.array([[0, 0, 10, 10]], np.float32))
    sd = np.asarray(_flat_field(segs, mask, meta, 100)).reshape(10, 10)
    assert (sd[4:6, 4:6] < 0).all()  # deep interior
    assert (sd[0, :] > 0).all() and (sd[:, 0] > 0).all()


def _kernel_loss(batch, depth):
    """The single-device tile-field loss of `FontFitter(backend=
    'pallas')` on the CPU, with its plan arrays."""
    from versatiles_glyphs_tpu.models.fitting import (
        build_flat_plan,
        make_flat_kernel_loss,
    )

    plan = build_flat_plan(
        batch.curve_mask, batch.meta, depth, batch.target.shape[1]
    )
    arrays = {
        "plan_tmeta": plan.tmeta,
        "plan_words": plan.mask_words,
        "row_map": plan.row_map,
        "chunk_map": plan.chunk_map,
        "inv_chunk": plan.inv_chunk,
    }
    return make_flat_kernel_loss(plan, depth, "reference"), {
        k: jnp.asarray(v) for k, v in arrays.items()
    }


def test_fit_kernel_backend_matches_jnp(fira_entry):
    from versatiles_glyphs_tpu.models.fitting import (
        batch_loss,
        init_params,
        make_fit_batch,
    )

    batch = make_fit_batch(fira_entry, [ord("o"), ord("L")], depth=2)
    assert batch.meta is not None and batch.meta.shape[1] == 4

    params = init_params(batch.curves0)
    dev = {
        "curve_mask": jnp.asarray(batch.curve_mask),
        "px": jnp.asarray(batch.px, jnp.float32),
        "py": jnp.asarray(batch.py, jnp.float32),
        "pix_mask": jnp.asarray(batch.pix_mask, jnp.float32),
        "target": jnp.asarray(batch.target, jnp.float32),
        "meta": jnp.asarray(batch.meta, jnp.int32),
    }
    kloss, plan_dev = _kernel_loss(batch, 2)
    dev.update(plan_dev)
    lj, gj = jax.value_and_grad(batch_loss)(params, dev, 2, None)
    lk, gk = jax.value_and_grad(kloss)(params, dev)
    assert abs(float(lj) - float(lk)) < 1e-5 * max(float(lj), 1e-6)

    # Real glyphs have many *exact* f32 distance ties between unrelated
    # segments (medial axes of strokes / between rings), where the two
    # backends pick different valid subgradients: jnp.min even-splits,
    # the tile field routes to the first argmin. Tie redistribution stays
    # within a glyph, so the per-glyph sums (= the translate gradient)
    # and the field-only log_gain gradient must match tightly; the
    # per-control-point curves gradient matches except at tie sites.
    for k in ("translate", "log_gain"):
        a, b = np.asarray(gj[k]), np.asarray(gk[k])
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b, a, atol=1e-4 * scale, err_msg=k)
    a, b = np.asarray(gj["curves"]), np.asarray(gk["curves"])
    scale = max(np.abs(a).max(), 1e-6)
    delta = np.abs(a - b)
    assert (delta > 1e-3 * scale).mean() < 0.15
    np.testing.assert_allclose(
        b.sum(axis=(1, 2)), a.sum(axis=(1, 2)), atol=1e-4 * scale
    )

    # And the kernel gradient is independently validated by finite
    # differences of the kernel loss itself.
    rng = np.random.default_rng(5)
    v = jax.tree.map(
        lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)
        ),
        params,
    )
    vn = float(
        jnp.sqrt(sum(jnp.vdot(x, x) for x in jax.tree.leaves(v)))
    )
    v = jax.tree.map(lambda x: x / vn, v)
    eps = 1e-2
    pp = jax.tree.map(lambda p, d: p + eps * d, params, v)
    pm = jax.tree.map(lambda p, d: p - eps * d, params, v)
    fd = (float(kloss(pp, dev)) - float(kloss(pm, dev))) / (2 * eps)
    an = float(
        sum(jnp.vdot(gk[k], v[k]) for k in ("curves", "translate", "log_gain"))
    )
    # Looser than the soup FD test: the real-glyph loss has kinks
    # (argmin switches, clip saturation) inside the FD stencil.
    assert abs(fd - an) < 0.1 * max(abs(fd), 1e-3)


def test_fit_kernel_backend_descends(fira_entry):
    from versatiles_glyphs_tpu.models.fitting import FontFitter, make_fit_batch

    batch = make_fit_batch(fira_entry, [111, 110])  # 'o', 'n'
    rng = np.random.default_rng(1)
    batch.curves0 = batch.curves0 + rng.normal(
        0, 0.35, batch.curves0.shape
    ).astype(np.float32) * batch.curve_mask[:, :, None, None]

    # Same regimen and acceptance as the jnp-backend convergence test
    # (test_fitting.py): the hard-min objective is noisy step to step,
    # so judge the best point of the trajectory.
    fitter = FontFitter(depth=2, learning_rate=0.01, backend="pallas")
    params, opt_state, dev = fitter.init(batch)
    losses = []
    for _ in range(200):
        params, opt_state, loss = fitter.step(params, opt_state, dev)
        losses.append(float(loss))
    assert min(losses) < 0.5 * losses[0], (losses[0], min(losses), losses[-1])
    assert losses[-1] < losses[0]
    assert np.isfinite(np.asarray(params["curves"])).all()


def test_pallas_backend_rejects_bad_config():
    from versatiles_glyphs_tpu.models.fitting import FontFitter

    with pytest.raises(ValueError):
        FontFitter(backend="pallas", sharpness=8.0)


def test_fit_kernel_backend_sharded_mesh(fira_entry):
    """Tile-field train step shard_mapped over the 8-device CPU
    mesh: loss equals the single-device loss on the real batch (padded
    glyphs contribute zero), and a step runs end to end."""
    from versatiles_glyphs_tpu.models.fitting import (
        FontFitter,
        init_params,
        make_fit_batch,
    )
    from versatiles_glyphs_tpu.parallel.mesh import make_mesh

    # 2-device sub-mesh + small glyphs: the 8-device variant exercises
    # nothing extra (same SPMD program); B=3 pads to 4 (one padded
    # glyph still covers the zero-contribution path).
    batch = make_fit_batch(fira_entry, [105, 46, 44])  # 'i', '.', ','
    mesh = make_mesh(jax.devices()[:2])
    fitter = FontFitter(depth=2, learning_rate=0.01, backend="pallas", mesh=mesh)
    params, opt_state, dev = fitter.init(batch)
    assert dev["target"].shape[0] % mesh.devices.size == 0

    loss_sharded = float(fitter._kernel_loss(params, dev))

    ref_params = init_params(batch.curves0)
    kloss, ref_dev = _kernel_loss(batch, 2)
    ref_dev.update(
        pix_mask=jnp.asarray(batch.pix_mask, jnp.float32),
        target=jnp.asarray(batch.target, jnp.float32),
    )
    loss_single = float(kloss(ref_params, ref_dev))
    assert abs(loss_sharded - loss_single) < 1e-5 * max(loss_single, 1e-6)

    # One full optimizer step executes (value_and_grad through
    # shard_map + custom_vjp + psum) and produces finite params.
    params2, _, loss = fitter.step(params, opt_state, dev)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(params2["curves"])).all()
