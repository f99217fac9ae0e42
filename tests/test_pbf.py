"""PBF wire-format tests: roundtrips + prost size parity."""

from versatiles_glyphs_tpu.proto.pbf import (
    PbfGlyph,
    decode_glyph,
    decode_glyphs,
    encode_glyphs,
    unzigzag32,
    zigzag32,
)


def test_zigzag():
    assert zigzag32(0) == 0
    assert zigzag32(-1) == 1
    assert zigzag32(1) == 2
    assert zigzag32(-7) == 13
    for v in (-5, 0, 7, -2147483648, 2147483647):
        assert unzigzag32(zigzag32(v)) == v


def test_empty_glyph_roundtrip():
    g = PbfGlyph.empty(42, 100)
    d = decode_glyph(g.encode())
    assert (d.id, d.bitmap, d.width, d.height, d.left, d.top, d.advance) == (
        42,
        None,
        0,
        0,
        0,
        0,
        100,
    )


def test_glyph_roundtrip():
    g = PbfGlyph(
        id=99, bitmap=bytes([10, 20, 30, 40]), width=64, height=128, left=-5,
        top=10, advance=70,
    )
    d = decode_glyph(g.encode())
    assert d == g


def test_empty_glyph_wire_size():
    # prost: id(1B key+1B) + width/height/left/top (4×2B) + advance
    # (1B key + varint(100)=1B) = 12 bytes.
    assert len(PbfGlyph.empty(42, 100).encode()) == 12


def test_glyphs_message_roundtrip():
    glyphs = [PbfGlyph.empty(1, 5), PbfGlyph(id=2, bitmap=b"\x00" * 9, width=3,
                                             height=3, left=-1, top=2, advance=4)]
    buf = encode_glyphs("Test Font", "0-255", glyphs)
    out = decode_glyphs(buf)
    assert [g.id for g in out] == [1, 2]
    assert out[1].bitmap == b"\x00" * 9
    assert out[1].left == -1 and out[1].top == 2


def test_glyphs_size_formula():
    # stack = name(2+9) + range(2+5) + glyph entries(2+len each)
    glyphs = [PbfGlyph.empty(1, 5)]
    inner = glyphs[0].encode()
    stack_len = 2 + 9 + 2 + 5 + 2 + len(inner)
    assert len(encode_glyphs("Test Font", "0-255", glyphs)) == 2 + stack_len


def test_encode_block_from_preps_byte_identical():
    """The fused preps→PBF native encode must equal assemble_glyphs +
    encode_glyphs byte for byte (including empty glyphs and bitmap
    ordering)."""
    import pytest

    from versatiles_glyphs_tpu.font.entry import FontFileEntry
    from versatiles_glyphs_tpu.proto import native
    from versatiles_glyphs_tpu.proto.pbf import encode_glyphs
    from versatiles_glyphs_tpu.render.driver import Renderer
    from versatiles_glyphs_tpu.utils.synth_font import build_ttf

    if not native.available():
        pytest.skip("native library unavailable")
    entry = FontFileEntry(build_ttf(10, 60, family="Enc Sans"))
    r = Renderer("device")
    preps = [p for cp in entry.metadata.codepoints
             if (p := r.prep_glyph(entry, cp)) is not None]
    nonempty = [p for p in preps if not p.empty]
    bitmaps = r.render_bitmaps(nonempty)

    glyphs = r.assemble_glyphs(preps, iter(bitmaps))
    ref = encode_glyphs("enc", "0-255", glyphs)
    got = native.encode_block_from_preps("enc", "0-255", preps, iter(bitmaps))
    assert got == ref
