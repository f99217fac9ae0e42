"""CFF/OTF end-to-end coverage.

The reference accepts .otf via ttf-parser (`/root/reference/src/render/
renderer.rs:109-111`, `src/commands/recurse.rs:106-108`); here CFF
outlines flow through the fontTools pen fallback (the native glyf
parser and the vectorized cores only exist for TrueType). A TTF/OTF
twin pair with identical outlines must produce identical metrics AND
identical SDF bitmaps.
"""

import io
import os

import numpy as np
import pytest

from versatiles_glyphs_tpu.font.entry import FontFileEntry
from versatiles_glyphs_tpu.render.driver import Renderer
from versatiles_glyphs_tpu.utils.synth_font import build_otf, build_ttf

N_GLYPHS = 12
FIRST_CP = 65


@pytest.fixture(scope="module")
def twins():
    ttf = FontFileEntry(build_ttf(N_GLYPHS, FIRST_CP, family="Twin Sans"))
    otf = FontFileEntry(build_otf(N_GLYPHS, FIRST_CP, family="Twin Sans"))
    return ttf, otf


def test_otf_fast_path(twins):
    ttf, otf = twins
    # CFF fonts have no glyf table but get their own native fast path
    # (vg_cff_rings) — both twins reach vectorized cores (OTF host
    # prep parity with TTF).
    assert otf._glyf_raw is None
    from versatiles_glyphs_tpu.proto import native

    if native.available():
        assert otf._cff_raw is not None
        assert otf.prep_cores is not None
        assert ttf.prep_cores is not None


def test_otf_metadata(twins):
    _, otf = twins
    md = otf.metadata
    assert md.family == "Twin Sans"
    assert md.codepoints == list(range(FIRST_CP, FIRST_CP + N_GLYPHS))
    assert otf.units_per_em == 1000


def test_otf_metrics_match_ttf(twins):
    ttf, otf = twins
    r = Renderer("zeros")
    for cp in range(FIRST_CP, FIRST_CP + N_GLYPHS):
        pt = r.prep_glyph(ttf, cp)
        po = r.prep_glyph(otf, cp)
        assert (pt.advance, pt.empty) == (po.advance, po.empty)
        assert (pt.x0, pt.y0, pt.x1, pt.y1) == (po.x0, po.y0, po.x1, po.y1)
        assert (pt.pbf_width, pt.pbf_height, pt.pbf_left, pt.pbf_top) == (
            po.pbf_width, po.pbf_height, po.pbf_left, po.pbf_top,
        )


def test_otf_bitmaps_match_ttf_exact(twins):
    ttf, otf = twins
    r = Renderer("exact")
    for cp in range(FIRST_CP, FIRST_CP + N_GLYPHS):
        pt = r.prep_glyph(ttf, cp)
        po = r.prep_glyph(otf, cp)
        if pt.empty:
            assert po.empty
            continue
        bt, bo = r.render_bitmaps([pt, po], parallel=False)
        np.testing.assert_array_equal(bt, bo)


def test_otf_winding_hole(twins):
    # Glyph g1 (cp 66) has a square hole: inside-outline bytes ≥ 192 on
    # the outer ring interior, and the hole interior must be outside
    # (< 192 at its center) — exercises CFF ring orientation through
    # the whole winding path.
    _, otf = twins
    r = Renderer("exact")
    p = r.prep_glyph(otf, 66)
    (bm,) = r.render_bitmaps([p], parallel=False)
    img = np.asarray(bm).reshape(p.height, p.width)
    # glyph pixel space: outline occupies [50, 50+s]×[0, s] font units
    # scaled by 24/1000; find the bitmap center row/col.
    cy, cx = p.height // 2, p.width // 2
    assert img[cy, cx] < 192  # hole center: outside the filled area


def test_otf_cli_end_to_end(tmp_path):
    from versatiles_glyphs_tpu.cli import main

    otf_path = tmp_path / "twin.otf"
    otf_path.write_bytes(build_otf(N_GLYPHS, FIRST_CP, family="Twin Sans"))
    out_dir = tmp_path / "out"
    buf = io.StringIO()
    main(
        ["merge", str(otf_path), "-o", str(out_dir), "--renderer", "exact"],
        stdout=buf,
    )
    files = os.listdir(out_dir / "twin_sans_regular")
    assert files == ["0-255.pbf"]

    dbg = io.StringIO()
    main(["debug", str(out_dir / "twin_sans_regular")], stdout=dbg)
    rows = dbg.getvalue().strip().splitlines()
    assert len(rows) == 1 + N_GLYPHS
    # Same rows as the TTF twin rendered through the fast path.
    ttf_path = tmp_path / "twin.ttf"
    ttf_path.write_bytes(build_ttf(N_GLYPHS, FIRST_CP, family="Twin Sans"))
    out2 = tmp_path / "out2"
    main(
        ["merge", str(ttf_path), "-o", str(out2), "--renderer", "exact"],
        stdout=io.StringIO(),
    )
    dbg2 = io.StringIO()
    main(["debug", str(out2 / "twin_sans_regular")], stdout=dbg2)
    assert dbg.getvalue() == dbg2.getvalue()


def test_recurse_scans_otf(tmp_path):
    from versatiles_glyphs_tpu.cli import main

    (tmp_path / "fonts").mkdir()
    (tmp_path / "fonts" / "a.otf").write_bytes(
        build_otf(4, 65, family="Scan Serif")
    )
    out_dir = tmp_path / "out"
    main(
        ["recurse", str(tmp_path / "fonts"), "-o", str(out_dir), "--dummy"],
        stdout=io.StringIO(),
    )
    assert (out_dir / "scan_serif_regular" / "0-255.pbf").exists()


# -- native Type 2 interpreter parity vs the fontTools pen --------------


@pytest.fixture(scope="module")
def fira_otf(fira_entry):
    """A CFF/OTF rebuilt from Fira Sans outlines (quadratics converted
    to cubics by T2CharStringPen) — real-font charstrings with curves,
    subrs-free, exercising h/v/hh/vv/hv/vh curveto encodings."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.t2CharStringPen import T2CharStringPen

    cps = fira_entry.metadata.codepoints[:220]
    names = sorted({fira_entry.glyph_name(cp) for cp in cps} - {None})
    gs = fira_entry._glyph_set
    fb = FontBuilder(fira_entry.units_per_em, isTTF=False)
    order = [".notdef"] + names
    fb.setupGlyphOrder(order)
    fb.setupCharacterMap(
        {cp: n for cp in cps if (n := fira_entry.glyph_name(cp)) in set(names)}
    )
    charstrings = {}
    metrics = {}
    for n in order:
        width = fira_entry.hor_advance(n) if n != ".notdef" else 600
        pen = T2CharStringPen(width, gs)
        if n != ".notdef":
            gs[n].draw(pen)
        charstrings[n] = pen.getCharString()
        metrics[n] = (width, 0)
    fb.setupCFF("FiraCff-Regular", {"FullName": "Fira Cff"}, charstrings, {})
    fb.setupHorizontalMetrics(metrics)
    fb.setupHorizontalHeader(ascent=935, descent=-265)
    fb.setupNameTable(
        {"familyName": "Fira Cff", "styleName": "Regular",
         "psName": "FiraCff-Regular"}
    )
    fb.setupOS2(sTypoAscender=935, sTypoDescender=-265)
    fb.setupPost()
    buf = io.BytesIO()
    fb.save(buf)
    return FontFileEntry(buf.getvalue())


def test_native_cff_interpreter_matches_pen(fira_otf):
    """The csrc Type 2 interpreter must reproduce the fontTools pen
    walk ring-for-ring, point-for-point on real-font charstrings."""
    from versatiles_glyphs_tpu.ops.flatten import RingAccumulator
    from versatiles_glyphs_tpu.font.entry import RingPen
    from versatiles_glyphs_tpu.proto import native

    if not native.available():
        pytest.skip("native library unavailable")
    cache = fira_otf._native_rings
    assert cache is not None
    n_native = sum(1 for v in cache.values() if v is not None)
    assert n_native >= 0.95 * len(cache), "too many pen fallbacks"

    checked = 0
    for name, rings in cache.items():
        if rings is None:
            continue
        acc = RingAccumulator()
        fira_otf._glyph_set[name].draw(RingPen(fira_otf._glyph_set, acc))
        pen_rings = acc.finish()
        assert len(rings) == len(pen_rings), name
        for a, b in zip(rings, pen_rings):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=name)
        checked += 1
    assert checked >= 100


def test_native_cff_subr_calls(twins):
    """Local + global subr calls (with bias) through the native
    interpreter: inject a subroutine into a synth CFF and route one
    glyph's outline through callsubr/callgsubr."""
    from fontTools.cffLib import GlobalSubrsIndex, SubrsIndex
    from fontTools.misc.psCharStrings import T2CharString
    from fontTools.ttLib import TTFont

    from versatiles_glyphs_tpu.font.entry import RingPen
    from versatiles_glyphs_tpu.ops.flatten import RingAccumulator
    from versatiles_glyphs_tpu.proto import native

    if not native.available():
        pytest.skip("native library unavailable")

    font = TTFont(io.BytesIO(build_otf(3, 65, family="Subr Serif")))
    cff = font["CFF "].cff
    td = cff[0]
    # Local subr: a 200x200 square side pair; global subr: the closing
    # sides. Bias for count < 1240 is 107 → index argument -107.
    lsub = T2CharString(None)
    lsub.program = [200, 0, "rlineto", 0, 200, "rlineto", "return"]
    subrs = SubrsIndex()
    subrs.append(lsub)
    td.Private.Subrs = subrs
    gsub = T2CharString(None)
    gsub.program = [-200, 0, "rlineto", "return"]
    gsubrs = GlobalSubrsIndex()
    gsubrs.append(gsub)
    cff.GlobalSubrs = gsubrs
    cs = td.CharStrings["g0"]
    cs.program = [
        60, 40, "rmoveto",
        -107, "callsubr",
        -107, "callgsubr",
        "endchar",
    ]
    cs.bytecode = None  # else compile() keeps the original bytecode
    cs.globalSubrs = gsubrs  # charstrings cache the (old, empty) index
    buf = io.BytesIO()
    font.save(buf)
    entry = FontFileEntry(buf.getvalue())

    cache = entry._native_rings
    assert cache is not None and cache["g0"] is not None
    acc = RingAccumulator()
    entry._glyph_set["g0"].draw(RingPen(entry._glyph_set, acc))
    pen_rings = acc.finish()
    assert len(cache["g0"]) == len(pen_rings) == 1
    np.testing.assert_allclose(cache["g0"][0], pen_rings[0], atol=1e-9)
    # The square is really there (4 corners + close).
    assert cache["g0"][0].shape[0] == 5


def test_native_cff_malformed_draw_before_move_falls_back(twins):
    """A drawing op with no open ring (rlineto before any moveto) is
    malformed Type 2; the native interpreter must reject the glyph
    (pen fallback) rather than render partially-dropped geometry
    (CubicSink once silently returned)."""
    from fontTools.ttLib import TTFont

    from versatiles_glyphs_tpu.proto import native

    if not native.available():
        pytest.skip("native library unavailable")

    font = TTFont(io.BytesIO(build_otf(3, 65, family="Bad Serif")))
    td = font["CFF "].cff[0]
    cs = td.CharStrings["g0"]
    cs.program = [200, 0, "rlineto", 0, 200, "rlineto", "endchar"]
    cs.bytecode = None  # else compile() keeps the original bytecode
    buf = io.BytesIO()
    font.save(buf)
    entry = FontFileEntry(buf.getvalue())

    cache = entry._native_rings
    assert cache is not None
    assert cache["g0"] is None  # -1: malformed -> pen fallback


def test_cff2_vectorized_cores_match_ttf():
    """CFF2 fonts have no native parser; they must still reach the
    vectorized cores via the pen-walked flat arrays (`_pen_flat`) and
    render identically to the TTF twin."""
    from versatiles_glyphs_tpu.utils.synth_font import build_otf2

    ttf = FontFileEntry(build_ttf(N_GLYPHS, FIRST_CP, family="Two Sans"))
    otf2 = FontFileEntry(build_otf2(N_GLYPHS, FIRST_CP, family="Two Sans"))
    assert otf2._cff_raw is None and otf2._glyf_raw is None
    cores = otf2.prep_cores
    assert cores is not None
    assert all(v is not None for v in cores.values())

    r = Renderer("device")
    for cp in range(FIRST_CP, FIRST_CP + N_GLYPHS):
        pt = r.prep_glyph(ttf, cp)
        po = r.prep_glyph(otf2, cp)
        assert (pt.advance, pt.empty, pt.width, pt.height, pt.x0, pt.y0) == (
            po.advance, po.empty, po.width, po.height, po.x0, po.y0
        )
    pre_t = [p for cp in range(FIRST_CP, FIRST_CP + N_GLYPHS)
             if not (p := r.prep_glyph(ttf, cp)).empty]
    pre_o = [p for cp in range(FIRST_CP, FIRST_CP + N_GLYPHS)
             if not (p := r.prep_glyph(otf2, cp)).empty]
    for a, b in zip(r.render_bitmaps(pre_t), r.render_bitmaps(pre_o)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_forced_pen_fallback_keeps_vectorized_cores(twins):
    """With the native parser unavailable (or rejecting every glyph),
    prep must still flow through `build_cores` — identical metrics and
    transport caches to the native path, one pen walk per NAME."""
    ttf, _ = twins
    fresh = FontFileEntry(build_ttf(N_GLYPHS, FIRST_CP, family="Twin Sans"))
    fresh.__dict__["_native_raw"] = None  # pre-seed the cached_property
    cores = fresh.prep_cores
    assert cores is not None
    ref_cores = ttf.prep_cores
    if ref_cores is None:
        pytest.skip("native library unavailable")
    for name, core in ref_cores.items():
        pen_core = cores[name]
        assert pen_core is not None
        assert (core.advance, core.empty) == (pen_core.advance, pen_core.empty)
        if not core.empty:
            assert (core.x0, core.y0, core.width, core.height) == (
                pen_core.x0, pen_core.y0, pen_core.width, pen_core.height
            )
            np.testing.assert_array_equal(core.chain16, pen_core.chain16)
