"""Render driver: per-glyph prep + pluggable SDF backends.

The structural equivalent of the reference's `Renderer`
(`/root/reference/src/render/renderer.rs:23-150`) with batched device
internals: metrics are computed per glyph on the host (f64, exact
integer parity), then whole groups of glyphs are rendered in one
device call.

Backends (reference's precise/dummy modes, plus the device paths):

- ``"device"`` — the batched tile field (`ops.tiles`) on the default
                 device: the Hopper kernel on a GPU, its plain jnp
                 reference on a CPU (`utils.device.tile_impl`). The
                 session is the same on every platform.
- ``"jax"``    — pure-JAX padded-layout evaluation (`ops.sdf_jax`).
- ``"exact"``  — float64 NumPy golden path (`ops.sdf_ref`), bit-exact
                 vs the reference.
- ``"zeros"``  — structurally-correct empty bitmaps (the reference's
                 dummy renderer, `renderer_dummy.rs`), for fast
                 pipeline tests.
- ``"auto"``   — "device" on a GPU, "exact" on a host with no
                 accelerator; the choice is reported on stderr.
"""

from __future__ import annotations

import numpy as np

from ..font.entry import FontFileEntry
from ..proto.pbf import PbfGlyph
from .metrics import GlyphPrep, prepare_glyph

_SURROGATE_LO, _SURROGATE_HI = 0xD800, 0xDFFF


def _valid_cp(cp: int) -> bool:
    """The reference's `char::from_u32` filter (`renderer.rs:104`):
    scalar values only. Shared by `prep_glyph` and the hoisted
    `prep_block` loop so the two paths cannot diverge (their
    equivalence is also locked by tests/test_prep_batch.py)."""
    return cp <= 0x10FFFF and not (_SURROGATE_LO <= cp <= _SURROGATE_HI)

# Device-path counters since the last reset: bytes device_put and
# fetched by single-device groups, groups dispatched, and the number of
# distinct devices that held the result shards of the last mesh round.
RENDER_STATS = {"upload_bytes": 0, "fetch_bytes": 0, "groups": 0, "shard_devices": 0}


def reset_render_stats() -> None:
    RENDER_STATS.update(upload_bytes=0, fetch_bytes=0, groups=0, shard_devices=0)


def _auto_backend() -> str:
    """"device" on a GPU, "exact" on a CPU host (reported on stderr);
    any other platform is an error."""
    import sys

    import jax

    from ..utils.device import default_platform

    platform = default_platform()
    backend = {"gpu": "device", "cpu": "exact"}.get(platform)
    if backend is None:
        raise ValueError(f"renderer 'auto': no backend for platform {platform!r}")
    kind = jax.devices(platform)[0].device_kind
    print(f"renderer: {backend} ({platform}: {kind})", file=sys.stderr)
    return backend


class Renderer:
    def __init__(self, backend: str = "auto", transport: str = "auto"):
        if backend == "auto":
            backend = _auto_backend()
        if backend not in ("device", "jax", "exact", "zeros"):
            raise ValueError(f"unknown renderer backend {backend!r}")
        if transport not in ("auto", "i8", "i16", "f32"):
            raise ValueError(f"unknown point transport {transport!r}")
        self.backend = backend
        # Device point transport: "i8" (default under "auto") ships
        # i8 lane deltas of the q16 fixed-point chain plus a sparse
        # anchor table (~2.1 B/lane; decoded on device to positions
        # bit-identical to "i16", so both share the ±1-byte parity
        # argument — see `GlyphPrep.chain16` and
        # `ops.tiles.reconstruct_delta`); "i16" ships the q16
        # coordinates directly (4 B/lane); "f32" keeps the tighter
        # f32-vs-f64 parity (<0.5% of pixels ±1) at 8 B/lane.
        self.transport = "i8" if transport == "auto" else transport

    # -- per-glyph host prep --------------------------------------------

    def prep_glyph(self, entry: FontFileEntry, codepoint: int) -> GlyphPrep | None:
        """Host metric computation for one codepoint; None when the font
        has no glyph for it (or it is not a valid char — the reference's
        `char::from_u32` filter, `renderer.rs:104`)."""
        if not _valid_cp(codepoint):
            return None
        key = entry.glyph_key(codepoint)
        if key is None:
            return None
        cores = entry.prep_cores
        if cores is not None:
            core = cores.get(key)
            if core is not None:
                # Vectorized font-level prep: metrics + transport caches
                # were computed once for the whole font; codepoints
                # sharing a glyph share the core's arrays.
                return core.make_prep(codepoint)
        # Rare per-glyph fallback (core build failed for this glyph):
        # the fontTools pen path, keyed by name.
        name = entry.glyph_name(codepoint)
        if name is None:
            return None
        rings = entry.outline_rings(name)
        return prepare_glyph(codepoint, rings, entry.units_per_em, entry.hor_advance(name))

    def prep_block(self, sources) -> list[GlyphPrep]:
        """Host prep for a block's (codepoint, entry) pairs — the
        manager's hot loop. Equivalent to `prep_glyph` per pair but
        with the per-call indirection hoisted: consecutive pairs
        sharing an entry reuse its core table and key map directly
        (the e2e profile showed ~11 ms/font of pure call overhead in
        the per-cp path). Returns preps for mapped codepoints only."""
        out: list[GlyphPrep] = []
        cur_entry = None
        cores = gmap = None
        gid_mode = False
        for cp, entry in sources:
            if entry is not cur_entry:
                cur_entry = entry
                cores, mode = entry._cores_and_mode
                gid_mode = mode == "gid" and cores is not None
                gmap = entry._gid_map if gid_mode else None
            if gid_mode and _valid_cp(cp):
                gid = gmap.get(cp)
                if gid is None:
                    continue
                core = cores.get(gid)
                if core is not None:
                    out.append(core.make_prep(cp))
                    continue
            p = self.prep_glyph(entry, cp)
            if p is not None:
                out.append(p)
        return out

    # -- batched bitmap rendering ---------------------------------------

    def start_session(self, parallel: bool = True, progress=None) -> "RenderSession":
        """Open an incremental render session: `RenderSession.add`
        accepts non-empty preps as host prep produces them (dispatching
        device groups as they fill, so uploads and kernels overlap
        later fonts' host prep), and `RenderSession.results` yields
        bitmaps in submit order as group fetches land (so PBF assembly
        overlaps the remaining transfers). This pipelining is the
        device-side reshaping of the reference's render-then-write
        closure per task (`/root/reference/src/font/manager.rs:104-115`)."""
        return RenderSession(self, parallel=parallel, progress=progress)

    def render_bitmaps(
        self,
        preps: list[GlyphPrep],
        parallel: bool = True,
        progress=None,
    ) -> list[np.ndarray]:
        """Quantized uint8 bitmaps (flat, Y-flipped, len w·h) for a list
        of non-empty preps.

        ``parallel=True`` (the default) shards the batch across every
        attached device when more than one is present (`parallel.mesh.
        data_mesh`) — the device-mesh equivalent of the reference's
        rayon fan-out (`manager.rs:117-121`); ``False`` forces the
        single-device path (the reference's `--single-thread`).

        ``progress`` is an optional ``callable(n)`` ticked as glyph
        results land (the reference ticks its bar per rendered block,
        `manager.rs:113`)."""
        if not preps:
            return []
        session = self.start_session(parallel=parallel, progress=progress)
        session.add(preps)
        return list(session.results())

    # Group caps: lanes and tiles per device launch (hard), and the
    # soft caps at which a session closes a group.
    _LANES_MAX = 1_500_000
    _TILES_MAX = 12288
    _LANES_SOFT = 600_000
    _TILES_SOFT = 4096

    @classmethod
    def _canonical_tier(cls, need_lanes: int, need_tiles: int):
        """Pick the smallest canonical device shape (N_pad, T_pad) that
        fits the group. Three compiled variants: a small one sized for
        a typical single font (the session closes groups near it — see
        `_LANES_SOFT`), a mid tier for single fonts with heavy outlines
        (Noto Arabic is ~1.16 M lanes), and the large one. A group that
        fits NO tier returns the large shape; the caller detects the
        lane overflow and takes the per-group bucket fallback (with a
        stderr note — no silent caps)."""
        from .batch import LANE_SLACK, N_BUCKETS, bucket

        tiers = (
            (bucket(640_000, N_BUCKETS), 4096),
            (bucket(1_250_000, N_BUCKETS), 8192),
            (
                bucket(cls._LANES_MAX + 8 * (LANE_SLACK + 256), N_BUCKETS),
                cls._TILES_MAX,
            ),
        )
        for canon_N, canon_T in tiers:
            if need_lanes <= canon_N and need_tiles <= canon_T:
                break
        return canon_N, canon_T

    def _dispatch_group(self, gitems, wire: str, gi: int, TP: int, impl: str):
        """Pack one group and dispatch its device call plus its async
        device→host copy; no result is awaited here. Returns a pending
        tuple (items, starts, device_out). ``wire`` is the group's
        transport: "i8" (delta wire format, the default), "i16", or
        "f32" (the q16-incompatible aux partition); ``impl`` the tile
        field (`utils.device.tile_impl`).

        Canonical device shapes: every group pads to one of a few
        (N_pad, T_pad, G_pad) shapes, so a whole run hits a handful of
        compiled variants instead of one per group.

        Inputs are device_put from arena buffers keyed per GROUP INDEX:
        a later group never rewrites a buffer an earlier group of the
        same session may still read. A slot is only rewritten by a
        later session, after this session's fetches have retired every
        group."""
        import sys

        import jax

        from ..ops.tiles import render_delta, render_pts
        from ..utils.arena import get_array
        from .batch import (
            LANE_SLACK, N_BUCKETS, S_BUCKETS, bucket, pack_points,
            pack_points_delta, plan_tiles, tile_starts,
        )

        gpreps = [p for _, p in gitems]
        dt = np.int16 if wire == "i16" else np.float32
        max_npts = max((p.npts for p in gpreps), default=1)
        n_lanes = sum(p.npts for p in gpreps)
        n_tiles = sum(max(1, -(-(p.width * p.height) // TP)) for p in gpreps)
        # Lane slack after the last glyph: the reference's fixed L_max
        # window must never run past the array (the kernel's loads are
        # masked and need none).
        slack = bucket(max_npts + LANE_SLACK + 256, S_BUCKETS)
        L_max = bucket(max_npts, S_BUCKETS)
        canon_N, canon_T = self._canonical_tier(n_lanes + slack, n_tiles)
        n_pad = canon_N
        overflow = None
        if n_lanes + slack > canon_N:
            overflow = f"{n_lanes + slack} lanes > {canon_N}"
        elif n_tiles > canon_T:
            # Tile overflow takes the same fallback: the i8 path's
            # `derive_tmeta(..., total_repeat_length=T_pad)` would
            # otherwise clip real tiles SILENTLY and assemble bitmaps
            # from wrong offsets.
            overflow = f"{n_tiles} tiles > {canon_T}"
        if overflow is not None:
            # Oversized outlier: per-group buckets, a fresh compiled
            # variant. Never silent: the user should know why this
            # font is slow.
            print(
                f"note: glyph group exceeds the canonical device "
                f"shape ({overflow}); "
                f"compiling a dedicated kernel variant",
                file=sys.stderr,
            )
            n_pad = None
        if wire == "i8" and n_pad is not None:
            deltas, words, anchors, meta_all = pack_points_delta(
                gpreps, N_pad=n_pad, arena_tag=str(gi)
            )
            G = len(gpreps)
            starts, T_used = tile_starts(meta_all, G, TP)
            # The glyph-row axis pads to its own small bucket set
            # (G ≤ tiles ≤ canon_T always): shipping meta instead of the
            # derived tile table pays off because G_pad ≪ T_pad.
            G_pad = min(bucket(G, (512, 2048, 8192)), canon_T)
            meta_p = get_array(f"driver_meta_{gi}_{G_pad}", (G_pad, 8), np.int32)
            meta_p[G:] = 0
            meta_p[:G] = meta_all[:G]
            wbuf = get_array(
                f"driver_words_{gi}_{words.shape[0]}", (words.shape[0],), np.int32
            )
            np.copyto(wbuf, words)
            RENDER_STATS["upload_bytes"] += (
                deltas.nbytes + wbuf.nbytes + anchors.nbytes + meta_p.nbytes
            )
            out = render_delta(
                jax.device_put(deltas),
                jax.device_put(wbuf),
                jax.device_put(anchors),
                jax.device_put(meta_p),
                TP, canon_T, L_max, impl,
            )
        else:
            if wire == "i8":
                dt = np.int16  # outlier/overflow group: plain i16
            pts, words, meta_all, _ = pack_points(
                gpreps, N_pad=n_pad, dtype=dt, arena_tag=str(gi)
            )
            tmeta, starts, T_used = plan_tiles(
                gpreps, meta_all, TP,
                T_pad=canon_T if n_tiles <= canon_T else None,
            )
            wbuf = get_array(
                f"driver_words_{gi}_{words.shape[0]}", (words.shape[0],), np.int32
            )
            np.copyto(wbuf, words)
            tm = get_array(f"driver_tmeta_{gi}_{tmeta.shape[0]}", tmeta.shape, np.int32)
            np.copyto(tm, tmeta)
            RENDER_STATS["upload_bytes"] += pts.nbytes + wbuf.nbytes + tm.nbytes
            out = render_pts(
                jax.device_put(pts), jax.device_put(wbuf), jax.device_put(tm),
                TP, L_max, impl,
            )
        # Fetch only the used tile prefix, rounded to 256 rows to bound
        # the compiled slice variants.
        keep = min(int(out.shape[0]), -(-T_used // 256) * 256)
        if keep < int(out.shape[0]):
            out = out[:keep]
        RENDER_STATS["fetch_bytes"] += keep * TP
        RENDER_STATS["groups"] += 1
        out.copy_to_host_async()
        return (gitems, starts, out)

    def _lpt_rounds(self, items, D: int, TP: int):
        """Balance (index, prep) items across ``D`` devices: greedy
        longest-processing-time bin packing by tile count into ``k·D``
        bins, growing ``k`` until every bin fits the group caps.
        Returns a list of rounds, each a list of D bins (possibly
        empty)."""

        def tiles(p):
            return max(1, -(-(p.width * p.height) // TP))

        order = sorted(items, key=lambda ip: -tiles(ip[1]))
        k = 1
        while True:
            nb = D * k
            bins: list[list] = [[] for _ in range(nb)]
            loads = [0] * nb
            lanes = [0] * nb
            for i, p in order:
                b = loads.index(min(loads))
                bins[b].append((i, p))
                loads[b] += tiles(p)
                lanes[b] += p.npts
            if max(loads) <= self._TILES_MAX and max(lanes) <= self._LANES_MAX:
                return [bins[r * D : (r + 1) * D] for r in range(k)]
            k += 1

    def _render_mesh(
        self, mesh, main, aux, n_total: int, TP: int, progress=None,
    ) -> list[np.ndarray]:
        """Mesh-sharded render: per round, D point-chain groups are
        packed to identical canonical shapes, stacked on a leading
        device axis, device_put with the batch sharding, and rendered by
        one `shard_map`ped call — each device computes its own group,
        no collectives (block rendering is embarrassingly parallel,
        like the reference's rayon tasks).

        The tile field follows the MESH's device platform, not the
        session default: a dry run builds a virtual-CPU mesh on a GPU
        host."""
        import jax

        from ..parallel.mesh import (
            batch_sharding, sharded_delta_render_fn, sharded_pts_render_fn,
        )
        from ..utils.device import tile_impl
        from .batch import (
            LANE_SLACK, N_BUCKETS, S_BUCKETS, T_BUCKETS, bucket, pack_points,
            pack_points_delta, plan_tiles, tile_starts,
        )

        impl = tile_impl(mesh.devices.flat[0].platform)
        D = mesh.devices.size
        sh = batch_sharding(mesh)
        results: list = [None] * n_total

        def tiles(p):
            return max(1, -(-(p.width * p.height) // TP))

        # Wire format per partition: the main (q16-safe) partition
        # follows the session transport — i8-delta by default, exactly
        # as on the single-device path — and the aux partition ships f32.
        main_wire = (
            self.transport if self.transport in ("i8", "i16") else "f32"
        )
        for items, wire in ((main, main_wire), (aux, "f32")):
            if not items:
                continue
            dt = np.int16 if wire == "i16" else np.float32
            for round_bins in self._lpt_rounds(items, D, TP):
                max_lanes = max(
                    (sum(p.npts for _, p in b) for b in round_bins if b),
                    default=1,
                )
                max_npts = max(
                    (p.npts for b in round_bins for _, p in b), default=1
                )
                slack = bucket(max_npts + LANE_SLACK + 256, S_BUCKETS)
                N_pad = bucket(max(max_lanes + slack, 128), N_BUCKETS)
                max_tiles = max(
                    (sum(tiles(p) for _, p in b) for b in round_bins if b),
                    default=1,
                )
                T_pad = bucket(max_tiles, T_BUCKETS)
                L_max = bucket(max_npts, S_BUCKETS)

                bin_starts = []
                if wire == "i8":
                    d8_st = np.zeros((D, 2, N_pad), np.int8)
                    words_st = np.zeros((D, N_pad // 32), np.int32)
                    anc_bins = []
                    meta_bins = []
                    for d, b in enumerate(round_bins):
                        gp = [p for _, p in b]
                        deltas, words, anchors, meta = pack_points_delta(
                            gp, N_pad=N_pad, arena_tag=f"_mesh{d}"
                        )
                        d8_st[d] = deltas
                        words_st[d] = words
                        anc_bins.append(np.array(anchors))
                        meta_bins.append(meta)
                        starts, _ = tile_starts(meta, len(gp), TP)
                        bin_starts.append(starts)
                    # Uniform anchor/glyph axes across shards (padding
                    # anchors are (0, 0, 0) — no-op scatter-adds; zero
                    # meta rows render as skipped 1-tile glyphs).
                    K_rnd = max(a.shape[1] for a in anc_bins)
                    G_rnd = max(m.shape[0] for m in meta_bins)
                    anc_st = np.zeros((D, 3, K_rnd), np.int32)
                    meta_st = np.zeros((D, G_rnd, 8), np.int32)
                    for d in range(len(round_bins)):
                        a, m = anc_bins[d], meta_bins[d]
                        anc_st[d, :, : a.shape[1]] = a
                        meta_st[d, : m.shape[0]] = m
                    fn = sharded_delta_render_fn(mesh, TP, L_max, T_pad, impl)
                    out = fn(
                        jax.device_put(d8_st, sh),
                        jax.device_put(words_st, sh),
                        jax.device_put(anc_st, sh),
                        jax.device_put(meta_st, sh),
                    )
                else:
                    pts_st = np.zeros((D, 2, N_pad), dt)
                    words_st = np.zeros((D, N_pad // 32), np.int32)
                    tm_st = np.zeros((D, T_pad, 8), np.int32)
                    for d, b in enumerate(round_bins):
                        gp = [p for _, p in b]
                        pts, words, meta, _ = pack_points(
                            gp, N_pad=N_pad, dtype=dt, arena_tag=f"_mesh{d}"
                        )
                        tmeta, starts, _ = plan_tiles(gp, meta, TP, T_pad=T_pad)
                        pts_st[d] = pts
                        words_st[d] = words
                        tm_st[d] = tmeta
                        bin_starts.append(starts)
                    fn = sharded_pts_render_fn(mesh, TP, L_max, impl)
                    out = fn(
                        jax.device_put(pts_st, sh),
                        jax.device_put(words_st, sh),
                        jax.device_put(tm_st, sh),
                    )
                RENDER_STATS["shard_devices"] = len(
                    {s.device for s in out.addressable_shards}
                )
                host = np.asarray(out)
                for d, b in enumerate(round_bins):
                    flat = host[d].reshape(-1)
                    starts = bin_starts[d]
                    for g, (i, p) in enumerate(b):
                        results[i] = flat[
                            starts[g] * TP : starts[g] * TP + p.width * p.height
                        ]
                if progress is not None:
                    progress(sum(len(b) for b in round_bins))
        return results

    # -- block assembly --------------------------------------------------

    @staticmethod
    def assemble_glyphs(preps: list[GlyphPrep], bitmap_iter) -> list[PbfGlyph]:
        """Pair preps with rendered bitmaps (consumed from
        ``bitmap_iter`` for each non-empty prep, in order) into
        PbfGlyph messages."""
        out: list[PbfGlyph] = []
        for p in preps:
            if p.empty:
                out.append(PbfGlyph.empty(p.codepoint, p.advance))
            else:
                bm = next(bitmap_iter)
                out.append(
                    PbfGlyph(
                        id=p.codepoint,
                        bitmap=np.asarray(bm, dtype=np.uint8).tobytes(),
                        width=p.pbf_width,
                        height=p.pbf_height,
                        left=p.pbf_left,
                        top=p.pbf_top,
                        advance=p.advance,
                    )
                )
        return out

    def render_block_glyphs(
        self, glyph_sources: list[tuple[int, FontFileEntry]]
    ) -> list[PbfGlyph]:
        """Render a block: (codepoint, font entry) pairs → PbfGlyphs in
        codepoint order. Mirrors `GlyphBlock::render`
        (`src/font/glyph_block.rs:69-80`) with device batching. (The
        manager normally batches across *all* blocks of a run instead —
        see `FontManager.render_glyphs` — this entry point renders one
        block standalone.)"""
        preps: list[GlyphPrep] = []
        for cp, entry in glyph_sources:
            p = self.prep_glyph(entry, cp)
            if p is not None:
                preps.append(p)

        nonempty = [p for p in preps if not p.empty]
        bitmaps = self.render_bitmaps(nonempty)
        return self.assemble_glyphs(preps, iter(bitmaps))


class RenderSession:
    """Incremental batched render (see `Renderer.start_session`).

    Usage::

        s = renderer.start_session(progress=tick)
        for block in blocks:
            s.add(nonempty_preps_of(block))
        for bitmap in s.results():   # yields in add() order
            ...

    Device backend, one device (the same on every platform): preps are
    routed to a q16 "main" buffer (i8-delta or i16 wire format) and an
    f32 "aux" buffer (transport-incompatible outliers,
    `GlyphPrep.q16_ok`); when a buffer reaches the soft group caps it is
    packed, device_put and dispatched as one jit (decode, tile table,
    tile field) on ONE dispatcher thread, and its async device→host
    copy starts right away — so group N+1's host pack overlaps group
    N's upload, kernel and fetch, and the main thread keeps draining
    host prep and encoding blocks meanwhile. `results()` flushes the
    remainder, then yields bitmaps in submit order, blocking one group
    at a time.

    With more than one attached device (`parallel.mesh.data_mesh`),
    dispatch defers to `results()` and the whole batch goes through
    the LPT-balanced mesh path (`Renderer._render_mesh`) — block
    rendering stays embarrassingly parallel across devices, like the
    reference's rayon fan-out (`manager.rs:117-121`).

    Non-device backends ("exact"/"zeros"/"jax") render eagerly inside
    `add`.
    """

    _TP = 256  # == the tile size GlyphPrep.ntiles256 bakes in (asserted below)

    def __init__(self, renderer: Renderer, parallel: bool = True, progress=None):
        self.r = renderer
        self.parallel = parallel
        self.tick = progress or (lambda n: None)
        self._n = 0  # total preps submitted
        self._eager: list[np.ndarray] = []  # non-device backends
        self._pending: list = []  # futures of dispatched, unfetched groups
        # (items, lanes, tiles) accumulation buffers.
        self._main: list = []
        self._aux: list = []
        self._main_sz = [0, 0]
        self._aux_sz = [0, 0]
        self._gi = 0
        self._mesh = None
        self._dispatcher = None
        if renderer.backend == "device":
            from concurrent.futures import ThreadPoolExecutor

            from ..utils.device import default_platform, tile_impl

            self._impl = tile_impl(default_platform())
            if parallel:
                from ..parallel.mesh import data_mesh

                self._mesh = data_mesh()
            if self._mesh is None:
                # One thread keeps the arena-slot and group ordering
                # invariants of `_dispatch_group` without locks.
                self._dispatcher = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="vg-dispatch"
                )

    # -- submission ------------------------------------------------------

    def add(self, preps: list[GlyphPrep]) -> None:
        """Submit non-empty preps; may dispatch filled device groups."""
        r = self.r
        if r.backend == "device":
            w = r.transport
            q16 = w in ("i8", "i16")
            for p in preps:
                item = (self._n, p)
                self._n += 1
                if q16 and not p.q16_ok:
                    # q16-incompatible outlier: f32 aux partition.
                    self._buf_add(self._aux, self._aux_sz, item, "f32")
                else:
                    self._buf_add(self._main, self._main_sz, item, w)
            return
        # Eager backends.
        self._n += len(preps)
        if not preps:
            return
        if r.backend == "zeros":
            self._eager.extend(
                np.zeros(p.width * p.height, dtype=np.uint8) for p in preps
            )
            self.tick(len(preps))
        elif r.backend == "exact":
            # Native multithreaded path when built; bit-identical numpy
            # fallback otherwise. Chunked so progress moves during the
            # long exact render.
            from ..proto import native

            if native.available():
                for i in range(0, len(preps), 512):
                    chunk = preps[i : i + 512]
                    self._eager.extend(native.render_sdf_batch(chunk))
                    self.tick(len(chunk))
            else:
                from ..ops.sdf_ref import render_sdf_exact

                for p in preps:
                    self._eager.append(
                        render_sdf_exact(
                            p.segments, p.width, p.height, p.x0, p.y0
                        )
                    )
                    self.tick(1)
        else:  # "jax": padded-layout batched path (the autodiff twin).
            from ..ops.sdf_jax import render_bitmaps_jax
            from .batch import pack_block

            segs, meta, P = pack_block(preps)
            out = np.asarray(render_bitmaps_jax(segs, meta, P, sequential=True))
            self._eager.extend(
                out[g, : p.width * p.height].copy() for g, p in enumerate(preps)
            )
            self.tick(len(preps))

    def _buf_add(self, buf: list, sz: list, item, wire: str) -> None:
        """Append to an accumulation buffer, dispatching it first if the
        new item would push it past the soft group caps. With a device
        mesh attached, dispatch is deferred wholesale to `results()`
        (the mesh path re-balances the full batch itself)."""
        _, p = item
        gl = p.npts
        assert self._TP == 256  # ntiles256 bakes in this tile size
        gt = p.ntiles256  # == ceil(w·h / _TP)
        if (
            self._mesh is None
            and buf
            and (
                sz[0] + gl > self.r._LANES_SOFT
                or sz[1] + gt > self.r._TILES_SOFT
            )
        ):
            self._dispatch(buf, wire)
            del buf[:]
            sz[0] = sz[1] = 0
        buf.append(item)
        sz[0] += gl
        sz[1] += gt

    def _dispatch(self, items: list, wire: str) -> None:
        self._pending.append(
            self._dispatcher.submit(
                self.r._dispatch_group,
                list(items), wire, self._gi, self._TP, self._impl,
            )
        )
        self._gi += 1

    # -- consumption -----------------------------------------------------

    def results(self):
        """Yield bitmaps in `add` order (a generator; see class doc)."""
        r = self.r
        if r.backend != "device":
            yield from self._eager
            return

        mesh = self._mesh
        if mesh is not None:
            if self._n >= 2 * mesh.devices.size:
                # Whole-batch mesh path (nothing was dispatched above).
                yield from r._render_mesh(
                    mesh, self._main, self._aux, self._n, self._TP,
                    progress=self.tick,
                )
                return
            # Too few glyphs to shard: one device after all.
            from concurrent.futures import ThreadPoolExecutor

            self._dispatcher = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="vg-dispatch"
            )

        if self._main:
            self._dispatch(self._main, r.transport)
        if self._aux:
            self._dispatch(self._aux, "f32")
        self._main = self._aux = None  # further add() is a bug

        placed: list = [None] * self._n
        ptr = 0
        try:
            for pending in self._pending:
                gitems, starts, out = pending.result()
                # Views into the fetched host buffer (freshly allocated
                # per group by the fetch, so they stay valid). Placed by
                # submit index: the q16/aux partition reordered groups.
                flat_host = np.asarray(out).reshape(-1)
                for g, (i, p) in enumerate(gitems):
                    placed[i] = flat_host[
                        starts[g] * self._TP : starts[g] * self._TP
                        + p.width * p.height
                    ]
                self.tick(len(gitems))
                while ptr < self._n and placed[ptr] is not None:
                    yield placed[ptr]
                    placed[ptr] = False  # drop the ref once consumed
                    ptr += 1
        finally:
            # Always reap the dispatcher (a consumer that raises — or a
            # closed generator — must not leak the thread or let a
            # half-dispatched group write into a reused arena slot).
            self._dispatcher.shutdown(wait=True)
            self._dispatcher = None
        assert ptr == self._n, "render session lost results"
