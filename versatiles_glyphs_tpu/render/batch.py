"""Glyph-batch packing: variable host geometry → fixed device shapes.

Compiled device code wants static shapes; glyph outlines don't have
them. This module bridges the two: a block's glyphs (each with its own segment
count and bitmap size) are packed into padded tensors whose dims are
drawn from a small set of **buckets**, so the whole run compiles a
handful of kernel variants instead of one per block.

- ``segs_packed``: [G, 8, S_pad] float32 — per-segment precomputed
  components (see `ops.sdf_jax` for the row layout), lane-major so the
  kernel slices (1, SC) rows with no relayout.
- ``meta``: [G, 8] int32 — x0, y0, w, h, nseg per glyph (padding rows
  zeroed, which the kernel's ``w·h = 0`` guard skips).

This is the batched replacement for the reference's per-glyph serial
loop (`/root/reference/src/font/glyph_block.rs:69-80`): glyphs within a
block become one padded device tensor, blocks become the data-parallel
axis (`parallel/`).
"""

from __future__ import annotations

import numpy as np

from ..ops.sdf_jax import DX, DY, DYINV, L2INV, VX, VY, WY
from ..utils.arena import get_array

# Shape buckets (multiples of the 128-lane chunk).
S_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)
P_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
# Flat lane-array length buckets; they extend to whole-font sizes.
# Above 64 Ki lanes the bucket step is 64 Ki: upload bytes track the
# workload instead of doubling, at the cost of a few more cached
# compiled variants.
N_BUCKETS = tuple([16384, 32768] + [65536 * k for k in range(1, 65)])
# Glyph-count buckets for batch meta arrays.
G_BUCKETS = (32, 128, 512, 1024)

SC = 128  # lane chunk: glyph runs of the flat layouts align to it
# Lanes of slack the point-chain packers leave after the last glyph, on
# top of the largest glyph's own lanes (the reference's fixed L_max
# window must never run past the array).
LANE_SLACK = 12 * SC


def bucket(value: int, buckets) -> int:
    for b in buckets:
        if value <= b:
            return b
    # Beyond the largest bucket: round up to the largest bucket's
    # granularity. Callers may instead choose a host fallback.
    step = buckets[-1]
    return ((value + step - 1) // step) * step


def pack_segments(seg_list: list[np.ndarray], S_pad: int | None = None) -> np.ndarray:
    """Pack per-glyph (S_i, 4) float64 segment soups into the kernel's
    [G, 8, S_pad] float32 component layout."""
    G = len(seg_list)
    max_s = max((s.shape[0] for s in seg_list), default=0)
    if S_pad is None:
        S_pad = bucket(max(max_s, 1), S_BUCKETS)
    out = np.zeros((G, 8, S_pad), dtype=np.float32)
    for g, segs in enumerate(seg_list):
        n = segs.shape[0]
        if n == 0:
            continue
        vx = segs[:, 0]
        vy = segs[:, 1]
        wx = segs[:, 2]
        wy = segs[:, 3]
        dx = wx - vx
        dy = wy - vy
        l2 = dx * dx + dy * dy
        with np.errstate(divide="ignore"):
            l2inv = np.where(l2 > 0.0, 1.0 / l2, 0.0)
            dyinv = np.where(dy != 0.0, 1.0 / dy, 0.0)
        out[g, VX, :n] = vx
        out[g, VY, :n] = vy
        out[g, DX, :n] = dx
        out[g, DY, :n] = dy
        out[g, L2INV, :n] = l2inv
        out[g, DYINV, :n] = dyinv
        out[g, WY, :n] = wy
    return out


def pack_flat(preps, N_pad: int | None = None):
    """Pack non-empty `GlyphPrep`s into the kernel's flat layout.

    Returns (flat [4, N_pad] f32 rows vx/vy/wx/wy, meta [G, 8] i32 with
    x0, y0, w, h, nseg, seg_off, P_pad). Each glyph's segment run starts
    at an SC-aligned offset; the only padding is that alignment (~10%
    on real fonts) instead of the ~6× of a per-glyph padded tensor.
    """
    G = len(preps)
    meta = np.zeros((max(G, 1), 8), dtype=np.int32)
    if G:
        cols = np.array(
            [(p.x0, p.y0, p.width, p.height, p.segments.shape[0]) for p in preps],
            dtype=np.int64,
        )
        runs = -(-np.maximum(cols[:, 4], 1) // SC) * SC
        offs = np.concatenate([[0], np.cumsum(runs)[:-1]])
        meta[:G, :5] = cols
        meta[:G, 5] = offs
        off = int(runs.sum())
    else:
        off = 0
    if N_pad is None:
        # Leave an S-bucket of slack after the last run so fixed-size
        # dynamic slices (the jnp twin of the kernel) never clamp.
        s_slack = bucket(max((int(m) for m in meta[:, 4]), default=1), S_BUCKETS)
        N_pad = bucket(max(off + s_slack, SC), N_BUCKETS)
    # Arena buffer (see utils.arena); lanes outside each glyph's
    # [off, off+n) run may hold stale values — every consumer masks by
    # nseg.
    flat = get_array("pack_flat", (4, N_pad), np.float32)
    if G:
        for g, p in enumerate(preps):
            n = p.segments.shape[0]
            if n:
                o = int(meta[g, 5])
                flat[:, o : o + n] = p.segments.T
    max_p = max((p.width * p.height for p in preps), default=0)
    P_pad = bucket(max(max_p, 1), P_BUCKETS)
    return flat, meta, P_pad


def pack_points(preps, N_pad: int | None = None, dtype=np.float32, arena_tag: str = ""):
    """Pack non-empty `GlyphPrep`s into the point-chain device layout.

    Instead of 16 B per segment this ships 8 B per *point* plus one
    validity bit per lane: segment ``i`` is the point pair
    ``(pts[:, i], pts[:, i+1])``, valid only when both points belong to
    the same ring (ring-end lanes have their mask bit cleared). Glyph
    runs are packed back-to-back with NO alignment padding — the tile
    field gates by absolute lane index.

    ``dtype=np.int16`` selects the fixed-point transport (4 B per point
    — half again: coordinates ×`metrics.Q16_SCALE`, dequantized on
    device; see `GlyphPrep.chain16` for the ±1-byte error argument).
    Callers must ensure every prep's ``q16_ok``.

    Returns (pts [2, N_pad] f32-or-i16 rows x/y, mask_words [N_pad//32]
    i32 little-endian bit j of word w = lane 32w+j, meta [G, 8] i32
    with x0, y0, w, h, npts, off).
    """
    G = len(preps)
    meta = np.zeros((max(G, 1), 8), dtype=np.int32)
    npts = np.asarray([p.npts for p in preps] + [0] * (not G), dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(npts)[:-1]])
    N = int(npts.sum())
    if G:
        meta[:G, 0] = [p.x0 for p in preps]
        meta[:G, 1] = [p.y0 for p in preps]
        meta[:G, 2] = [p.width for p in preps]
        meta[:G, 3] = [p.height for p in preps]
        meta[:G, 4] = npts[:G]
        meta[:G, 5] = offs[:G]
    if N_pad is None:
        # Slack: the reference slices fixed windows of the largest lane
        # bucket.
        s_slack = bucket(
            int(npts.max(initial=1)) + LANE_SLACK + 256, S_BUCKETS
        )
        N_pad = bucket(max(N + s_slack, SC), N_BUCKETS)
    # ``arena_tag`` distinguishes concurrent consumers (e.g. per device
    # group in the driver): device_put may stage asynchronously from the
    # source buffer, so a buffer must not be rewritten while a previous
    # transfer could still be in flight.
    i16 = np.dtype(dtype) == np.int16
    pts = get_array(
        f"pack_points_{'i16' if i16 else 'f32'}{arena_tag}", (2, N_pad), dtype
    )
    valid = get_array(f"pack_points_valid{arena_tag}", (N_pad,), np.uint8)
    valid[N:] = 0  # runs are contiguous from 0; only the tail is stale
    if G and N:
        # One C-level concatenate pass per array (see pack_points_delta).
        chains = [p.chain16 if i16 else p.chain32 for p in preps]
        np.concatenate(chains, axis=1, out=pts[:, :N])
        np.concatenate([p.valid8 for p in preps], out=valid[:N])
    words = np.packbits(valid, bitorder="little").view("<u4").view(np.int32)
    max_p = max((p.width * p.height for p in preps), default=0)
    P_pad = bucket(max(max_p, 1), P_BUCKETS)
    return pts, words, meta, P_pad


# Anchor-count buckets for the i8-delta transport (each anchor is a
# 12 B column of the [3, K_pad] array — real fonts run 1-4% of lanes,
# so the steps stay fine enough that padding costs ≲50 KB).
K_BUCKETS = (1024, 4096, 8192, 16384, 24576, 32768, 49152, 65536, 131072)


def pack_points_delta(preps, N_pad: int | None = None, arena_tag: str = ""):
    """Pack non-empty `GlyphPrep`s into the i8-delta device layout.

    The wire format below the i16 fixed-point transport: consecutive
    flattened points differ by ≲1-2 px, so most lane-to-lane deltas of
    the q16 chain (`GlyphPrep.chain16`) fit one signed byte. Lanes
    whose delta overflows i8 (ring/glyph jumps, long line segments —
    1-3% on real fonts) become **anchors**: their shipped delta is 0
    and the true delta rides in a sparse i32 side table that the
    device scatter-adds back before one `cumsum` reconstructs the
    exact q16 values (`ops.tiles.reconstruct_delta`). The
    decoded positions are bit-identical to the i16 transport, so its
    ±1-byte parity argument (and gate) carries over unchanged — this
    is a pure wire-bytes optimization (~2.1 B/lane vs 4).

    Returns (deltas [2, N_pad] i8, mask_words [N_pad//32] i32,
    anchors [3, K_pad] i32 — row 0 lane index, rows 1-2 the x/y jump;
    padding columns are (0, 0, 0), a no-op scatter-add — and
    meta [G, 8] i32 as in `pack_points`).
    """
    G = len(preps)
    meta = np.zeros((max(G, 1), 8), dtype=np.int32)
    npts = np.asarray([p.npts for p in preps] + [0] * (not G), dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(npts)[:-1]])
    N = int(npts.sum())
    if G:
        meta[:G, 0] = [p.x0 for p in preps]
        meta[:G, 1] = [p.y0 for p in preps]
        meta[:G, 2] = [p.width for p in preps]
        meta[:G, 3] = [p.height for p in preps]
        meta[:G, 4] = npts[:G]
        meta[:G, 5] = offs[:G]
    if N_pad is None:
        s_slack = bucket(
            int(npts.max(initial=1)) + LANE_SLACK + 256, S_BUCKETS
        )
        N_pad = bucket(max(N + s_slack, SC), N_BUCKETS)

    # Assemble from the per-glyph caches (`GlyphPrep.delta_cache`,
    # precomputed vectorized for whole fonts in
    # `render.metrics.build_cores`): each glyph's intra deltas are a
    # bulk i8 copy; only its lane-0 anchor depends on the pack order
    # (jump = q_first − previous glyph's q_last, so the global cumsum
    # lands exactly on q_first). Assembly is np.concatenate(out=...)
    # over the cache lists — one C-level pass per array instead of
    # ~10 small numpy slice calls per glyph.
    deltas = get_array(f"pack_delta_d8{arena_tag}", (2, N_pad), np.int8)
    # Stale tail lanes [N:] only corrupt masked positions (cumsum is
    # forward-only), exactly like the stale tail of pack_points.
    caches = [p.delta_cache for p in preps]
    ancs = np.fromiter(
        (c[1].shape[0] for c in caches), dtype=np.int64, count=G
    ) if G else np.zeros(0, np.int64)
    astarts = np.zeros(G, np.int64)
    if G:
        np.cumsum(ancs[:-1] + 1, out=astarts[1:])
    K = int(ancs.sum()) + G
    K_pad = bucket(max(K, 1), K_BUCKETS)
    anchors = get_array(f"pack_delta_anc{arena_tag}", (3, K_pad), np.int32)
    anchors[:, K:] = 0
    # Lane-0 jumps, vectorized: glyph g's first-lane jump is
    # q_first[g] − q_last[g−1] (q_last[−1] = 0).
    if G:
        if N:
            np.concatenate([c[0] for c in caches], axis=1, out=deltas[:, :N])
        # concatenate+reshape, not np.stack: stack reshapes each of the
        # G tiny (2,) arrays individually (~3 ms/font measured).
        qf_all = np.concatenate([c[3] for c in caches]).reshape(G, 2).T
        ql_all = np.concatenate([c[4] for c in caches]).reshape(G, 2).T
        j0 = qf_all.copy()
        j0[:, 1:] -= ql_all[:, :-1]
        anchors[0, astarts] = offs
        anchors[1:3, astarts] = j0
        Ka = int(ancs.sum())
        if Ka:
            # Per-glyph anchor blocks land at astarts[g]+1 ...; build
            # the destination indices with the repeat/arange trick and
            # scatter once.
            ai_all = np.concatenate([c[1] for c in caches]).astype(np.int64)
            aj_all = np.concatenate([c[2] for c in caches], axis=1)
            within = np.arange(Ka) - np.repeat(
                np.concatenate([[0], np.cumsum(ancs)[:-1]]), ancs
            )
            dst = np.repeat(astarts + 1, ancs) + within
            anchors[0, dst] = ai_all + np.repeat(offs[:G], ancs)
            anchors[1:3, dst] = aj_all

    valid = get_array(f"pack_points_valid{arena_tag}", (N_pad,), np.uint8)
    valid[N:] = 0
    if G and N:
        np.concatenate([p.valid8 for p in preps], out=valid[:N])
    words = np.packbits(valid, bitorder="little").view("<u4").view(np.int32)
    return deltas, words, anchors, meta


# Tile-count buckets for the single-launch tile table (32 B rows).
T_BUCKETS = (256, 1024, 4096, 8192, 12288)


def tile_starts(meta: np.ndarray, G: int, TP: int):
    """Per-glyph first-tile index + total used tiles for a packed
    group (the host-side bookkeeping twin of the device-side
    `ops.tiles.derive_tmeta`): glyph g's bitmap is
    ``out.reshape(-1)[starts[g]*TP : starts[g]*TP + w·h]``."""
    if G == 0:
        return np.zeros(0, np.int64), 0
    npix = meta[:G, 2].astype(np.int64) * meta[:G, 3]
    ntiles = np.maximum(1, -(-npix // TP))
    starts = np.concatenate([[0], np.cumsum(ntiles)[:-1]])
    return starts, int(ntiles.sum())


def plan_tiles(preps, meta: np.ndarray, TP: int, T_pad: int | None = None):
    """Build the flat tile table for the single-launch kernel.

    Each glyph occupies ``ceil(w·h / TP)`` consecutive rows; row ``t`` is
    ``[x0, y0, w, h, nseg, seg_off, pix_base, 0]`` where ``pix_base`` is
    the tile's first flat pixel index within its glyph. Because a
    glyph's tiles are contiguous, its bitmap is
    ``out.reshape(-1)[starts[g]*TP : starts[g]*TP + w·h]``.

    Rows are padded to a T bucket with zeros (``w·h = 0`` → the kernel
    skips them). Returns (tmeta [T_pad, 8] i32, starts [G] i64,
    T_used) — callers fetch only the first T_used rows of the output.

    This is the launch plan that makes a whole group ONE device call
    (the reference's analogue of this choice is the rayon task list
    being global rather than per-font, `manager.rs:87-97`).
    """
    G = len(preps)
    if G == 0:
        T0 = T_pad if T_pad is not None else T_BUCKETS[0]
        return np.zeros((T0, 8), dtype=np.int32), np.zeros(0, np.int64), 0
    npix = meta[:G, 2].astype(np.int64) * meta[:G, 3]
    ntiles = np.maximum(1, -(-npix // TP))
    starts = np.concatenate([[0], np.cumsum(ntiles)[:-1]])
    T = int(ntiles.sum())
    if T_pad is None:
        T_pad = bucket(max(T, 1), T_BUCKETS)
    assert T <= T_pad, f"{T} tiles exceed T_pad={T_pad}"
    tmeta = get_array("plan_tiles", (T_pad, 8), np.int32)
    tmeta[T:] = 0  # padding rows: w·h = 0 → kernel skip
    g_of_tile = np.repeat(np.arange(G), ntiles)
    tmeta[:T] = meta[g_of_tile]
    tmeta[:T, 6] = (np.arange(T) - starts[g_of_tile]) * TP
    return tmeta, starts, T


def pad_meta(meta: np.ndarray) -> np.ndarray:
    """Pad the glyph axis to a G bucket so batches of different sizes
    hit the same compiled kernel; padding rows have w·h = 0 → the
    kernel skips them."""
    G = meta.shape[0]
    G_pad = bucket(max(G, 1), G_BUCKETS)
    if G_pad == G:
        return meta
    out = np.zeros((G_pad, meta.shape[1]), dtype=meta.dtype)
    out[:G] = meta
    return out


def plan_batches(preps, max_glyphs: int = G_BUCKETS[-1], max_seg_lanes: int | None = None):
    """Split an arbitrary prep list into device batches.

    Sorts by bitmap size, then groups by **pixel bucket**: each batch's
    P_pad is the bucket of its largest glyph, so small glyphs never pay
    a big glyph's pixel padding, and batches stay few (one per occupied
    bucket, typically 2-3 per font) — which matters because every batch
    costs a fixed-latency device round trip. Returns a list of
    (indices, preps) with indices into the original order.
    """
    order = sorted(range(len(preps)), key=lambda i: preps[i].width * preps[i].height)
    batches = []
    cur_idx: list[int] = []
    cur_bucket = None
    cur_lanes = 0
    for i in order:
        n = preps[i].segments.shape[0]
        lanes = -(-max(n, 1) // SC) * SC
        b = bucket(max(preps[i].width * preps[i].height, 1), P_BUCKETS)
        if cur_idx and (
            b != cur_bucket
            or len(cur_idx) >= max_glyphs
            or (max_seg_lanes is not None and cur_lanes + lanes > max_seg_lanes)
        ):
            batches.append(cur_idx)
            cur_idx = []
            cur_lanes = 0
        cur_idx.append(i)
        cur_bucket = b
        cur_lanes += lanes
    if cur_idx:
        batches.append(cur_idx)
    return [(idx, [preps[i] for i in idx]) for idx in batches]


def pack_block(preps, P_pad: int | None = None, S_pad: int | None = None):
    """Pack a list of non-empty `GlyphPrep` into device tensors.

    Returns (segs [G,8,S_pad] f32, meta [G,8] i32, P_pad)."""
    G = len(preps)
    seg_list = [p.segments for p in preps]
    segs = pack_segments(seg_list, S_pad=S_pad)
    max_p = max((p.width * p.height for p in preps), default=0)
    if P_pad is None:
        P_pad = bucket(max(max_p, 1), P_BUCKETS)
    meta = np.zeros((G, 8), dtype=np.int32)
    for g, p in enumerate(preps):
        meta[g, 0] = p.x0
        meta[g, 1] = p.y0
        meta[g, 2] = p.width
        meta[g, 3] = p.height
        meta[g, 4] = p.segments.shape[0]
    return segs, meta, P_pad
