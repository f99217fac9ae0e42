"""Native (C++) host runtime parity: byte-identical PBF encoding and
tar headers, bit-identical f64 SDF rendering, vs the Python reference
implementations. Skipped when g++/the shared object is unavailable."""

import numpy as np
import pytest

from versatiles_glyphs_tpu.proto import native
from versatiles_glyphs_tpu.proto.pbf import PbfGlyph, encode_glyphs_py

if not native.available():
    pytest.skip("native library not built (g++ unavailable)", allow_module_level=True)


def test_encode_block_byte_identical():
    glyphs = [
        PbfGlyph.empty(1, 5),
        PbfGlyph(id=2, bitmap=bytes(range(9)), width=3, height=3, left=-1,
                 top=2, advance=4),
        PbfGlyph(id=70000, bitmap=bytes(500), width=20, height=19, left=-5,
                 top=-30, advance=300),
        PbfGlyph(id=0, bitmap=b"", width=0, height=0, left=0, top=0, advance=0),
    ]
    a = native.encode_glyph_block("Test Font", "0-255", glyphs)
    b = encode_glyphs_py("Test Font", "0-255", glyphs)
    assert a == b


def test_encode_block_empty():
    a = native.encode_glyph_block("F", "0-255", [])
    b = encode_glyphs_py("F", "0-255", [])
    assert a == b


def test_tar_header_byte_identical():
    from versatiles_glyphs_tpu.writer.tar import build_header

    for name, size, mode, tf in [
        ("hello.txt", 5, 0o644, ord("0")),
        ("dir/", 0, 0o755, ord("5")),
        ("x" * 100, 2**30, 0o600, ord("0")),
    ]:
        assert native.tar_header(name, size, mode, tf, 1700000000) == build_header(
            name, size, mode, tf, mtime=1700000000
        )
    with pytest.raises(ValueError):
        native.tar_header("y" * 101, 0, 0o644, ord("0"), 0)


def test_render_sdf_bit_identical(fira_entry):
    from versatiles_glyphs_tpu.ops.sdf_ref import render_sdf_exact
    from versatiles_glyphs_tpu.render.metrics import prepare_glyph

    preps = []
    for cp in [33, 65, 97, 230, 38, 64]:
        name = fira_entry.glyph_name(cp)
        p = prepare_glyph(
            cp,
            fira_entry.outline_rings(name),
            fira_entry.units_per_em,
            fira_entry.hor_advance(name),
        )
        preps.append(p)
    bms = native.render_sdf_batch(preps, n_threads=2)
    for p, bm in zip(preps, bms):
        want = render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0)
        np.testing.assert_array_equal(bm, want)


def test_glyf_rings_bit_identical(fira_entry):
    """Native glyf parse + flatten must equal the fontTools pen +
    RingAccumulator path exactly (f64 bit equality) for every
    cmap-mapped glyph of Fira Sans."""
    from versatiles_glyphs_tpu.font.entry import RingPen
    from versatiles_glyphs_tpu.ops.flatten import RingAccumulator

    cache = fira_entry._native_rings
    assert cache is not None, "native glyf parser unavailable"
    assert len(cache) == 1686
    checked = 0
    for name, rings in cache.items():
        assert rings is not None, f"unexpected pen fallback for {name}"
        acc = RingAccumulator()
        pen = RingPen(fira_entry._glyph_set, acc)
        fira_entry._glyph_set[name].draw(pen)
        want = acc.finish()
        assert len(rings) == len(want), name
        for a, b in zip(rings, want):
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        checked += 1
    assert checked == 1686


def test_prep_cores_native_matches_numpy(fira_entry, monkeypatch):
    """The C++ single-pass glyph prep (vg_prep_cores) must reproduce
    the numpy reference path bit for bit: metrics, transformed points,
    q16 chain, validity bits, delta runs and anchor tables."""
    import versatiles_glyphs_tpu.proto.native as native
    from versatiles_glyphs_tpu.render.metrics import build_cores

    if not native.available():
        pytest.skip("native library unavailable")
    names, pts, ring_lens, glyph_nrings = fira_entry._native_raw
    advances = np.array(
        [fira_entry.hor_advance(n) for n in names], dtype=np.float64
    )
    upem = fira_entry.units_per_em

    fast = build_cores(names, advances, upem, pts, ring_lens, glyph_nrings)
    nat = native.prep_cores_batch(
        pts, ring_lens, glyph_nrings, advances, upem
    )
    monkeypatch.setattr(native, "prep_cores_batch", lambda *a, **k: None)
    ref = build_cores(names, advances, upem, pts, ring_lens, glyph_nrings)

    assert set(fast) == set(ref)
    checked = 0
    for name in names:
        a, b = fast[name], ref[name]
        if b is None:
            assert a is None
            continue
        assert (a.advance, a.dx, a.empty) == (b.advance, b.dx, b.empty), name
        if b.empty:
            continue  # GlyphCore zeroes every metric for empty glyphs
        assert (a.x0, a.y0, a.x1, a.y1, a.npts) == (
            b.x0, b.y0, b.x1, b.y1, b.npts
        ), name
        np.testing.assert_array_equal(a.pts_px, b.pts_px, err_msg=name)
        np.testing.assert_array_equal(a.chain16, b.chain16, err_msg=name)
        np.testing.assert_array_equal(a.valid8, b.valid8, err_msg=name)
        for x, y in zip(a.delta_cache, b.delta_cache):
            np.testing.assert_array_equal(x, y, err_msg=name)
        checked += 1
    assert checked > 1000

    # Raw-layer contract: the native pass emits the SAME bbox values as
    # the numpy fallback's zero-default min/max path for empty glyphs
    # (floor(0)-BUFFER .. ceil(0)+BUFFER), so the two build_cores
    # sources are bit-identical even where consumers zero the metrics.
    empty_rows = np.flatnonzero((nat["empty"] != 0) & (nat["npts"] == 0))
    if empty_rows.size:
        np.testing.assert_array_equal(
            nat["bbox"][empty_rows],
            np.tile(np.array([-3, -3, 3, 3], np.int32), (empty_rows.size, 1)),
        )


def test_native_font_index_matches_fonttools():
    """The native cmap union (record order, first-wins, gid-0 excluded)
    and hmtx advances must equal the fontTools reference path on every
    available test font — this is what licenses the ingest hot path to
    skip the fontTools cmap/post decompile entirely."""
    import glob
    import io
    import os

    from fontTools.ttLib import TTFont

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = sorted(glob.glob(os.path.join(repo, "testdata", "dejavu", "*.ttf")))
    assert len(paths) == 6
    checked = 0
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        font = TTFont(io.BytesIO(data), fontNumber=0, lazy=True)
        e = font.reader.tables["cmap"]
        res = native.cmap_union(
            np.frombuffer(data, np.uint8, count=e.length, offset=e.offset)
        )
        if res is None:
            continue  # uncovered subtable format: fontTools fallback
        cps, gids = res
        union: dict = {}
        for sub in font["cmap"].tables:
            if sub.isUnicode():
                for cp, name in sub.cmap.items():
                    union.setdefault(cp, name)
        gid_of = font.getReverseGlyphMap()
        ft = {cp: gid_of[n] for cp, n in union.items()}
        assert dict(zip(cps.tolist(), gids.tolist())) == ft, path
        assert list(cps) == sorted(cps)

        hh, mp = font.reader.tables["hhea"], font.reader.tables["maxp"]
        hhea = data[hh.offset : hh.offset + hh.length]
        maxp = data[mp.offset : mp.offset + mp.length]
        num_h = (hhea[34] << 8) | hhea[35]
        num_g = (maxp[4] << 8) | maxp[5]
        hm = font.reader.tables["hmtx"]
        adv = native.hmtx_advances(
            np.frombuffer(data, np.uint8, count=hm.length, offset=hm.offset),
            num_h, num_g,
        )
        hmtx = font["hmtx"]
        order = font.getGlyphOrder()
        want = np.array([hmtx[order[g]][0] for g in range(num_g)], np.uint16)
        np.testing.assert_array_equal(adv[:num_g], want, err_msg=path)
        checked += 1
    assert checked == 6  # every DejaVu face takes the native path
