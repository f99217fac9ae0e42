"""The sfnt reader (`font/sfnt.py`) against fontTools, and `merge` and
`recurse` with fontTools and orbax blocked: TrueType and CFF fonts
ingest and render through the native parsers alone."""

import glob
import io
import os
import subprocess
import sys

import pytest

from versatiles_glyphs_tpu.font.sfnt import Sfnt
from versatiles_glyphs_tpu.utils.synth_font import build_otf, build_ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEJAVU = sorted(glob.glob(os.path.join(REPO, "testdata", "dejavu", "*.ttf")))


def _font_bytes(name):
    if name == "synth.ttf":
        return build_ttf()
    if name == "synth.otf":
        return build_otf()
    with open(os.path.join(REPO, "testdata", "dejavu", name), "rb") as f:
        return f.read()


def test_dejavu_faces_present():
    assert [os.path.basename(p) for p in DEJAVU] == [
        "DejaVuSans-Bold.ttf", "DejaVuSans.ttf", "DejaVuSansMono-Bold.ttf",
        "DejaVuSansMono.ttf", "DejaVuSerif-Bold.ttf", "DejaVuSerif.ttf",
    ]


@pytest.mark.parametrize(
    "name", [os.path.basename(p) for p in DEJAVU] + ["synth.ttf", "synth.otf"]
)
def test_sfnt_reader_matches_fonttools(name):
    from fontTools.ttLib import TTFont

    data = _font_bytes(name)
    sfnt = Sfnt(data)
    font = TTFont(io.BytesIO(data), lazy=True)
    assert sfnt.tables == {
        tag: (e.offset, e.length) for tag, e in font.reader.tables.items()
    }
    assert sfnt.units_per_em == font["head"].unitsPerEm
    assert sfnt.index_to_loc_format == font["head"].indexToLocFormat
    for name_id in (1, 2, 4, 6, 16, 17):
        assert sfnt.debug_name(name_id) == font["name"].getDebugName(name_id)


@pytest.mark.parametrize("data", [b"", b"garbage bytes, not an sfnt", b"ttcf"])
def test_sfnt_rejects_non_fonts(data):
    with pytest.raises(ValueError):
        Sfnt(data)


_BLOCKED = r"""
import os, sys
sys.modules["fontTools"] = None
sys.modules["orbax"] = None
from versatiles_glyphs_tpu.cli import main
fonts, out = sys.argv[1], sys.argv[2]
for name in sorted(os.listdir(fonts)):
    main(["merge", os.path.join(fonts, name), "-o", os.path.join(out, name),
          "--renderer", "exact"])
main(["recurse", fonts, "-o", os.path.join(out, "recurse"), "--renderer", "exact"])
assert not any(m.startswith(("fontTools.", "orbax.")) for m in sys.modules)
print("BLOCKED_OK")
"""


def test_merge_and_recurse_without_fonttools_or_orbax(tmp_path):
    from versatiles_glyphs_tpu.proto import native
    from versatiles_glyphs_tpu.proto.pbf import decode_glyphs

    if not native.available():
        pytest.skip("native library unavailable")
    fonts, out = tmp_path / "fonts", tmp_path / "out"
    fonts.mkdir()
    (fonts / "s.ttf").write_bytes(build_ttf())
    (fonts / "s.otf").write_bytes(build_otf())
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(fonts), str(out)],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BLOCKED_OK" in r.stdout
    for run, font_id in (
        ("s.ttf", "synth_sans_regular"), ("s.otf", "synth_serif_regular"),
        ("recurse", "synth_sans_regular"), ("recurse", "synth_serif_regular"),
    ):
        pbf = out / run / font_id / "0-255.pbf"
        glyphs = decode_glyphs(pbf.read_bytes())
        assert sum(1 for g in glyphs if g.bitmap) == 24
