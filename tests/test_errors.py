"""Error-path hardening tests — each failure mode the
reference handles with a clean contextual error must not produce a raw
traceback here: bad font bytes (`wrapper.rs:137-146`), corrupt pbf in
debug (`debug.rs:202-219`), overlong tar entry name through the
pipeline (`tar.rs:179-186`), unreadable input."""

import io
import subprocess
import sys

import pytest

from versatiles_glyphs_tpu.cli import main
from versatiles_glyphs_tpu.utils.synth_font import build_ttf


def test_merge_non_font_bytes(tmp_path):
    bad = tmp_path / "bad.ttf"
    bad.write_bytes(b"this is not a font at all" * 10)
    with pytest.raises(ValueError, match="failed to parse font file"):
        main(["merge", str(bad), "-o", str(tmp_path / "o"), "--dummy"],
             stdout=io.StringIO())


def test_fonts_json_non_font_source(tmp_path):
    d = tmp_path / "fonts"
    d.mkdir()
    (d / "fonts.json").write_text(
        '[{"name": "Broken Sans", "sources": ["junk.ttf"]}]'
    )
    (d / "junk.ttf").write_bytes(b"\x00\x01garbage")
    with pytest.raises(ValueError, match="failed to parse font file.*junk"):
        main(["recurse", str(d), "-o", str(tmp_path / "o"), "--dummy"],
             stdout=io.StringIO())


def test_merge_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        main(["merge", str(tmp_path / "nope.ttf"), "-o", str(tmp_path / "o"),
              "--dummy"], stdout=io.StringIO())


def test_merge_directory_as_font(tmp_path):
    d = tmp_path / "dir.ttf"
    d.mkdir()
    with pytest.raises(OSError):
        main(["merge", str(d), "-o", str(tmp_path / "o"), "--dummy"],
             stdout=io.StringIO())


def test_debug_corrupt_pbf(tmp_path):
    d = tmp_path / "glyphs"
    d.mkdir()
    (d / "0-255.pbf").write_bytes(b"\xff\xfe\xfd not protobuf \x80\x80\x80")
    with pytest.raises(SystemExit, match="Failed to decode"):
        main(["debug", str(d)], stdout=io.StringIO())


def test_debug_truncated_pbf(tmp_path):
    # A message that starts like a valid field then truncates mid-varint.
    d = tmp_path / "glyphs"
    d.mkdir()
    (d / "0-255.pbf").write_bytes(b"\x0a\xff\xff\xff\xff\xff")
    with pytest.raises(SystemExit, match="Failed to decode"):
        main(["debug", str(d)], stdout=io.StringIO())


def test_overlong_tar_name_through_pipeline(tmp_path):
    # A font whose id makes "{id}/{block}.pbf" exceed the 100-byte tar
    # name limit: the hand-rolled ustar encoder must reject it with a
    # clean error, through the real pipeline (`tar.rs:179-186`).
    family = "Very " + "Long " * 22 + "Name"  # id ≈ 117 chars
    font = tmp_path / "long.ttf"
    font.write_bytes(build_ttf(4, 65, family=family))
    out = io.BytesIO()
    with pytest.raises(ValueError, match="tar entry name"):
        main(["merge", str(font), "--tar", "--dummy"], stdout=out)


def test_cli_surface_one_line_error(tmp_path):
    # Through the real CLI surface (subprocess): one clean error line on
    # stderr, nonzero exit, and NO traceback.
    bad = tmp_path / "bad.ttf"
    bad.write_bytes(b"garbage bytes, not an sfnt")
    r = subprocess.run(
        [sys.executable, "-m", "versatiles_glyphs_tpu", "merge", str(bad),
         "-o", str(tmp_path / "o"), "--dummy"],
        capture_output=True, text=True, timeout=120,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode != 0
    assert "Traceback" not in r.stderr
    err_lines = [l for l in r.stderr.splitlines() if l.startswith("error:")]
    assert len(err_lines) == 1
    assert "failed to parse font file" in err_lines[0]
