"""Device-path tests: the flat-layout batched renderers (the plain
references of the tile kernel) and the padded JAX path vs the exact
f64 golden renderer; batch packing/planning; the device session.

The kernel itself is checked in interpret mode in
tests/test_tile_kernel.py, and compiled on the card by chip_smoke.py.
"""

import numpy as np
import pytest

from versatiles_glyphs_tpu.ops.sdf_jax import (
    render_bitmaps_flat_jax,
    render_bitmaps_jax,
)
from versatiles_glyphs_tpu.ops.sdf_ref import render_sdf_exact
from versatiles_glyphs_tpu.render.batch import (
    S_BUCKETS,
    bucket,
    pack_block,
    pack_flat,
    pack_segments,
    plan_batches,
)
from versatiles_glyphs_tpu.render.metrics import prepare_glyph


@pytest.fixture(scope="module")
def batch(fira_entry):
    preps = []
    for cp in [33, 65, 97, 230]:
        name = fira_entry.glyph_name(cp)
        p = prepare_glyph(
            cp,
            fira_entry.outline_rings(name),
            fira_entry.units_per_em,
            fira_entry.hor_advance(name),
        )
        assert not p.empty
        preps.append(p)
    segs, meta, P = pack_block(preps)
    return preps, segs, meta, P


def _diff_vs_exact(preps, bitmaps):
    maxdiff = 0
    ndiff = 0
    total = 0
    for g, p in enumerate(preps):
        got = np.asarray(bitmaps[g][: p.width * p.height], dtype=int)
        want = render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0).astype(int)
        d = np.abs(got - want)
        maxdiff = max(maxdiff, int(d.max()))
        ndiff += int((d > 0).sum())
        total += d.size
    return maxdiff, ndiff, total


def test_jax_path_matches_exact(batch):
    preps, segs, meta, P = batch
    out = np.asarray(render_bitmaps_jax(segs, meta, P))
    maxdiff, ndiff, total = _diff_vs_exact(preps, out)
    # f32 vs f64: at most ±1 byte on a tiny fraction of pixels.
    assert maxdiff <= 1
    assert ndiff <= total * 0.005


def test_flat_jax_path_matches_exact(batch):
    preps, _, _, _ = batch
    flat, meta, P = pack_flat(preps)
    S_max = bucket(max(int(m) for m in meta[:, 4]), S_BUCKETS)
    out = np.asarray(render_bitmaps_flat_jax(flat, meta, P, S_max))
    maxdiff, ndiff, total = _diff_vs_exact(preps, out)
    assert maxdiff <= 1
    assert ndiff <= total * 0.005


def test_pack_flat_layout(batch):
    preps, _, _, _ = batch
    flat, meta, P = pack_flat(preps)
    assert flat.shape[0] == 4
    assert flat.shape[1] % 128 == 0
    for g, p in enumerate(preps):
        n = p.segments.shape[0]
        off = meta[g, 5]
        assert off % 128 == 0
        assert meta[g, 4] == n
        np.testing.assert_array_equal(
            flat[:, off : off + n], p.segments.T.astype(np.float32)
        )
    # Slack after the last run: fixed-size slices never clamp.
    S_max = bucket(max(int(m) for m in meta[:, 4]), S_BUCKETS)
    assert flat.shape[1] >= int(meta[:, 5].max()) + S_max


def test_plan_batches_sorts_and_splits(batch):
    preps, _, _, _ = batch
    plans = plan_batches(preps, max_glyphs=2)
    assert len(plans) == 2
    # Each original prep appears exactly once.
    seen = sorted(i for idx, _ in plans for i in idx)
    assert seen == list(range(len(preps)))
    # Sorted by bitmap size: first batch holds the smaller glyphs.
    size = lambda p: p.width * p.height
    assert max(size(p) for p in plans[0][1]) <= min(size(p) for p in plans[1][1])


def test_driver_device_backend_matches_exact(batch):
    """The `device` backend on a CPU runs the plain reference field —
    exercises the full plan/pack/dispatch/scatter path (default i8
    transport)."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps, _, _, _ = batch
    r = Renderer("device")
    bitmaps = r.render_bitmaps(preps)
    maxdiff, ndiff, total = _diff_vs_exact(preps, bitmaps)
    assert maxdiff <= 1
    # i16 fixed-point transport: ±1 on a few percent of pixels
    # (measured 2.4% over Fira; bound with margin).
    assert ndiff <= total * 0.05


def test_driver_f32_transport_strict(batch):
    """The f32 transport keeps the tighter f32-vs-f64 parity."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps, _, _, _ = batch
    r = Renderer("device", transport="f32")
    bitmaps = r.render_bitmaps(preps)
    maxdiff, ndiff, total = _diff_vs_exact(preps, bitmaps)
    assert maxdiff <= 1
    assert ndiff <= total * 0.005


def test_chain16_roundtrip(batch):
    """i16 fixed-point chains dequantize to within half a grid step of
    the f64 chains, and q16_ok holds for normal glyphs."""
    from versatiles_glyphs_tpu.render.metrics import Q16_SCALE

    preps, _, _, _ = batch
    for p in preps:
        assert p.q16_ok
        exact = np.concatenate(p.rings_px, axis=0).T
        deq = p.chain16.astype(np.float64) / Q16_SCALE
        assert np.abs(deq - exact).max() <= 0.5 / Q16_SCALE + 1e-12


def test_q16_out_of_range_falls_back():
    """A glyph beyond the int16 range must route its group to f32 and
    still render correctly."""
    from versatiles_glyphs_tpu.render.driver import Renderer
    from versatiles_glyphs_tpu.render.metrics import GlyphPrep

    ring = np.array(
        [(200.0, 200.0), (220.0, 200.0), (220.0, 220.0),
         (200.0, 220.0), (200.0, 200.0)]
    )
    segs = np.concatenate([ring[:-1], ring[1:]], axis=1)
    p = GlyphPrep(
        codepoint=65, advance=10, empty=False,
        width=26, height=26, x0=197, y0=197, x1=223, y1=223,
        segments=segs,
    )
    assert not p.q16_ok
    r = Renderer("device")  # i16 default; must fall back per group
    bitmaps = r.render_bitmaps([p])
    maxdiff, ndiff, total = _diff_vs_exact([p], bitmaps)
    assert maxdiff <= 1
    assert ndiff <= total * 0.005  # f32 fallback = strict parity


def test_plan_tiles_layout(batch):
    from versatiles_glyphs_tpu.render.batch import plan_tiles

    preps, _, _, _ = batch
    _, meta, _ = pack_flat(preps)
    TP = 256
    tmeta, starts, _ = plan_tiles(preps, meta, TP)
    assert tmeta.shape[1] == 8
    assert tmeta.shape[0] % 256 == 0
    t = 0
    for g, p in enumerate(preps):
        npix = p.width * p.height
        ntiles = max(1, -(-npix // TP))
        assert starts[g] == t
        for k in range(ntiles):
            row = tmeta[t]
            assert tuple(row[:6]) == (
                p.x0, p.y0, p.width, p.height,
                p.segments.shape[0], meta[g, 5],
            )
            assert row[6] == k * TP
            t += 1
    # Padding rows: w·h = 0 so the kernel (and jnp twin) skip them.
    assert (tmeta[t:, 2] * tmeta[t:, 3]).sum() == 0


def test_tiles_jax_path_matches_exact(batch):
    from versatiles_glyphs_tpu.ops.sdf_jax import render_bitmaps_tiles_jax
    from versatiles_glyphs_tpu.render.batch import plan_tiles

    preps, _, _, _ = batch
    flat, meta, _ = pack_flat(preps)
    TP = 256
    tmeta, starts, _ = plan_tiles(preps, meta, TP)
    S_max = bucket(max(int(m) for m in meta[:, 4]), S_BUCKETS)
    out = np.asarray(render_bitmaps_tiles_jax(flat, tmeta, TP, S_max))
    bitmaps = [
        out.reshape(-1)[starts[g] * TP : starts[g] * TP + p.width * p.height]
        for g, p in enumerate(preps)
    ]
    maxdiff, ndiff, total = _diff_vs_exact(preps, bitmaps)
    assert maxdiff <= 1
    assert ndiff <= total * 0.005


def test_pack_points_layout(batch):
    from versatiles_glyphs_tpu.render.batch import pack_points

    preps, _, _, _ = batch
    pts, words, meta, P = pack_points(preps)
    assert pts.shape[0] == 2 and pts.shape[1] % 128 == 0
    assert words.shape == (pts.shape[1] // 32,)
    bits = np.unpackbits(
        words.view(np.uint32).view(np.uint8), bitorder="little"
    )
    for g, p in enumerate(preps):
        off, npts = int(meta[g, 5]), int(meta[g, 4])
        assert npts == sum(len(r) for r in p.rings_px)
        # Valid lanes reconstruct exactly the glyph's segment soup.
        lanes = np.nonzero(bits[off : off + max(npts - 1, 0)])[0] + off
        v = pts[:, lanes].T
        w = pts[:, lanes + 1].T
        segs = np.concatenate([v, w], axis=1)
        np.testing.assert_array_equal(
            segs, p.segments.astype(np.float32)
        )
        # Ring-end lanes are invalid; runs are back-to-back.
        if g + 1 < len(preps):
            assert int(meta[g + 1, 5]) == off + npts
            assert bits[off + npts - 1] == 0


def test_pts_jax_path_matches_exact(batch):
    from versatiles_glyphs_tpu.ops.sdf_jax import render_bitmaps_pts_jax
    from versatiles_glyphs_tpu.render.batch import pack_points, plan_tiles

    preps, _, _, _ = batch
    pts, words, meta, _ = pack_points(preps)
    TP = 256
    tmeta, starts, _ = plan_tiles(preps, meta, TP)
    L_max = bucket(max(int(m) for m in meta[:, 4]), S_BUCKETS)
    out = np.asarray(render_bitmaps_pts_jax(pts, words, tmeta, TP, L_max))
    bitmaps = [
        out.reshape(-1)[starts[g] * TP : starts[g] * TP + p.width * p.height]
        for g, p in enumerate(preps)
    ]
    maxdiff, ndiff, total = _diff_vs_exact(preps, bitmaps)
    assert maxdiff <= 1
    assert ndiff <= total * 0.005


def test_bucket():
    assert bucket(1, (128, 256)) == 128
    assert bucket(128, (128, 256)) == 128
    assert bucket(129, (128, 256)) == 256
    assert bucket(1000, (128, 256)) == 1024  # rounds up in steps of 256


def test_pack_segments_components():
    segs = [np.array([[0.0, 0.0, 3.0, 4.0]]), np.zeros((0, 4))]
    packed = pack_segments(segs, S_pad=128)
    assert packed.shape == (2, 8, 128)
    from versatiles_glyphs_tpu.ops.sdf_jax import DX, DY, L2INV, VX, WY

    assert packed[0, VX, 0] == 0.0
    assert packed[0, DX, 0] == 3.0
    assert packed[0, DY, 0] == 4.0
    assert packed[0, WY, 0] == 4.0
    np.testing.assert_allclose(packed[0, L2INV, 0], 1.0 / 25.0)
    # Degenerate/padded entries have zero inverses (no NaN path).
    assert packed[1].sum() == 0.0


def test_pack_block_meta(batch):
    preps, segs, meta, P = batch
    assert meta.shape == (len(preps), 8)
    for g, p in enumerate(preps):
        assert tuple(meta[g, :5]) == (
            p.x0, p.y0, p.width, p.height, p.segments.shape[0],
        )
    assert P % 256 == 0


def test_driver_group_split(batch, monkeypatch):
    """Forcing tiny group caps must split into multiple groups and still
    produce correct bitmaps in the original order."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps, _, _, _ = batch
    monkeypatch.setattr(Renderer, "_LANES_MAX", 256)
    monkeypatch.setattr(Renderer, "_TILES_MAX", 2)
    monkeypatch.setattr(Renderer, "_LANES_SOFT", 256)
    monkeypatch.setattr(Renderer, "_TILES_SOFT", 2)
    r = Renderer("device", transport="f32")
    bitmaps = r.render_bitmaps(preps)
    maxdiff, ndiff, total = _diff_vs_exact(preps, bitmaps)
    assert maxdiff <= 1
    assert ndiff <= total * 0.005


def test_render_session_incremental(batch, monkeypatch):
    """RenderSession: preps added across several add() calls with tiny
    group caps (mid-add dispatches) and an i16-incompatible outlier
    (routed to the f32 aux buffer, dispatched last) must come back in
    submit order, matching render_bitmaps on the same list."""
    from versatiles_glyphs_tpu.render.driver import Renderer
    from versatiles_glyphs_tpu.render.metrics import prepare_glyph

    preps, _, _, _ = batch
    # A glyph far outside the i16 fixed-point range (bbox > ±127 px).
    big_ring = np.array(
        [(0.0, 0.0), (6000.0, 0.0), (6000.0, 6000.0), (0.0, 6000.0), (0.0, 0.0)]
    )
    outlier = prepare_glyph(9999, [big_ring], 1000, 6000)
    assert not outlier.q16_ok
    mixed = list(preps[:3]) + [outlier] + list(preps[3:])

    monkeypatch.setattr(Renderer, "_LANES_SOFT", 256)
    monkeypatch.setattr(Renderer, "_TILES_SOFT", 512)
    r = Renderer("device", transport="i16")
    want = r.render_bitmaps(mixed, parallel=False)

    s = r.start_session(parallel=False)
    for i in range(0, len(mixed), 2):
        s.add(mixed[i : i + 2])
    got = list(s.results())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_render_session_progress_ticks(batch):
    """Progress callbacks sum to the number of non-empty preps."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps, _, _, _ = batch
    ticks = []
    r = Renderer("device", transport="f32")
    s = r.start_session(parallel=False, progress=ticks.append)
    s.add(list(preps))
    list(s.results())
    assert sum(ticks) == len(preps)


def test_delta_wire_roundtrip(batch):
    """pack_points_delta → reconstruct_delta recovers positions
    bit-identical to the i16 chain (the exactness that lets the i8
    wire format inherit the i16 parity gate)."""
    import numpy as np

    import jax

    from versatiles_glyphs_tpu.ops.tiles import reconstruct_delta
    from versatiles_glyphs_tpu.render.batch import pack_points, pack_points_delta

    preps, _, _, _ = batch
    deltas, words, anchors, meta = pack_points_delta(preps, arena_tag="_t")
    pts16, words16, meta16, _ = pack_points(
        preps, N_pad=deltas.shape[1], dtype=np.int16, arena_tag="_t"
    )
    np.testing.assert_array_equal(np.asarray(words), np.asarray(words16))
    np.testing.assert_array_equal(meta[: len(preps)], meta16[: len(preps)])
    q = np.asarray(jax.jit(reconstruct_delta)(deltas, anchors))
    N = sum(p.npts for p in preps)
    np.testing.assert_array_equal(q[:, :N], pts16.astype(np.int32)[:, :N])
    # The wire really is thinner: anchors are a few percent of lanes.
    K = int((np.asarray(anchors)[0] != 0).sum()) + 1
    assert K < 0.2 * N


def test_driver_i8_matches_i16_bitwise(batch):
    """The i8 delta transport must be byte-identical to i16 end to end
    (same decoded positions, same kernel math)."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps, _, _, _ = batch
    b8 = Renderer("device", transport="i8").render_bitmaps(preps)
    b16 = Renderer("device", transport="i16").render_bitmaps(preps)
    assert len(b8) == len(b16)
    for a, b in zip(b8, b16):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_derive_tmeta_matches_plan_tiles(batch):
    """Device-side tile-table derivation == the host plan_tiles rows
    over the used prefix (and skip-safe beyond it)."""
    import jax

    from versatiles_glyphs_tpu.ops.tiles import derive_tmeta
    from versatiles_glyphs_tpu.render.batch import pack_points, plan_tiles

    preps, _, _, _ = batch
    TP = 256
    _, _, meta, _ = pack_points(preps, dtype=np.int16, arena_tag="_t2")
    tmeta_host, starts, T_used = plan_tiles(preps, meta, TP, T_pad=256)
    G = len(preps)
    meta_p = np.zeros((32, 8), np.int32)
    meta_p[:G] = meta[:G]
    tmeta_dev = np.asarray(
        jax.jit(derive_tmeta, static_argnums=(1, 2))(meta_p, TP, 256)
    )
    np.testing.assert_array_equal(tmeta_dev[:T_used], tmeta_host[:T_used])
    # Padding rows must be kernel-skipped: pix_base >= w*h.
    for t in range(T_used, 256):
        assert tmeta_dev[t, 6] >= tmeta_dev[t, 2] * tmeta_dev[t, 3]


def test_canonical_tier_selection():
    """The dispatch path's canonical-shape choice: smallest tier that
    fits, and the large shape for true outliers (whose lane overflow
    the caller then routes to the bucket fallback)."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    small_N, small_T = Renderer._canonical_tier(600_000, 4000)
    assert small_T == 4096 and 640_000 <= small_N < 1_250_000
    mid_N, mid_T = Renderer._canonical_tier(1_200_000, 5000)
    assert mid_T == 8192 and 1_250_000 <= mid_N < Renderer._LANES_MAX
    # Tile pressure alone also promotes the tier.
    _, t = Renderer._canonical_tier(100_000, 5000)
    assert t == 8192
    big_N, big_T = Renderer._canonical_tier(1_500_000, 12_000)
    assert big_T == Renderer._TILES_MAX and big_N >= Renderer._LANES_MAX
    # Outlier beyond every tier: returns the large shape; the caller
    # sees need_lanes > canon_N and falls back to per-group buckets.
    over_N, _ = Renderer._canonical_tier(3_000_000, 12_000)
    assert over_N == big_N and 3_000_000 > over_N


def test_i8_tiles_overflow_takes_fallback(batch, monkeypatch, capsys):
    """A group whose tile count exceeds the canonical T_pad must NOT go
    down the i8 dispatch path — `derive_tmeta(..., total_repeat_length=
    T_pad)` would clip real tiles SILENTLY and bitmaps would be
    assembled from wrong offsets. The guard routes tile overflow to the
    same per-group-bucket fallback as lane overflow, with the stderr
    note (the repo's no-silent-caps rule)."""
    import versatiles_glyphs_tpu.ops.tiles as tiles
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps, _, _, _ = batch
    TP = 256
    n_tiles = sum(max(1, -(-(p.width * p.height) // TP)) for p in preps)
    assert n_tiles > 1

    # Tiny canonical tier: lanes fit with room, tiles do not.
    monkeypatch.setattr(
        Renderer,
        "_canonical_tier",
        classmethod(lambda cls, nl, nt: (1 << 20, n_tiles - 1)),
    )

    def fail_delta(*a, **k):
        raise AssertionError("i8 delta path must not run on tile overflow")

    monkeypatch.setattr(tiles, "render_delta", fail_delta)

    r = Renderer("device", transport="i8")
    items = list(enumerate(preps))
    gitems, starts, out = r._dispatch_group(items, "i8", 0, TP, "reference")
    err = capsys.readouterr().err
    assert "tiles" in err and "dedicated kernel variant" in err

    flat = np.asarray(out).reshape(-1)
    for g, (_i, p) in enumerate(gitems):
        got = flat[starts[g] * TP : starts[g] * TP + p.width * p.height]
        exact = render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0)
        delta = np.abs(got.astype(np.int32) - exact.astype(np.int32))
        assert delta.max(initial=0) <= 1
