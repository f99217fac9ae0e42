"""Minimal sfnt container reader: the table directory, two `head`
fields and the debug names — all the merge path needs from a font file
besides what the native parsers read (`proto.native`), so TrueType and
CFF fonts ingest without fontTools.

Name selection follows fontTools' ``getDebugName``: the first record of
the ID (in file order) that decodes, preferring the first English one
(Mac language 0 or Windows 0x409).
"""

from __future__ import annotations

import struct

_SFNT_VERSIONS = (b"\x00\x01\x00\x00", b"OTTO", b"true", b"typ1")

# (platformID, platEncID) -> codec; Mac Roman (1, 0) depends on the
# language (fontTools' `encodingTools` table, limited to the codecs
# Python ships). Records whose encoding is unknown decode as ASCII.
_ENCODINGS = {
    (0, 0): "utf_16_be", (0, 1): "utf_16_be", (0, 2): "utf_16_be",
    (0, 3): "utf_16_be", (0, 4): "utf_16_be", (0, 5): "utf_16_be",
    (0, 6): "utf_16_be",
    (1, 6): "mac_greek", (1, 7): "mac_cyrillic", (1, 29): "mac_latin2",
    (1, 35): "mac_turkish", (1, 37): "mac_iceland",
    (2, 0): "ascii", (2, 1): "utf_16_be", (2, 2): "latin1",
    (3, 0): "utf_16_be", (3, 1): "utf_16_be", (3, 2): "shift_jis",
    (3, 3): "gb2312", (3, 4): "big5", (3, 5): "euc_kr", (3, 6): "johab",
    (3, 10): "utf_16_be",
}
_MAC_ROMAN_BY_LANG = {
    15: "mac_iceland", 17: "mac_turkish", 18: "mac_croatian",
    37: "mac_romanian",
    **{lang: "mac_latin2" for lang in (24, 25, 26, 27, 28, 36, 38, 39, 40)},
}


def _encoding(platform: int, enc: int, lang: int) -> str:
    if (platform, enc) == (1, 0):
        return _MAC_ROMAN_BY_LANG.get(lang, "mac_roman")
    return _ENCODINGS.get((platform, enc), "ascii")


class Sfnt:
    """Table directory of the first font in an sfnt file or collection.

    ``tables`` maps a 4-character tag to ``(offset, length)`` in the
    file's bytes. Raises ValueError for data that is not an sfnt."""

    def __init__(self, data: bytes):
        self.data = data
        base = 0
        if data[:4] == b"ttcf":
            if len(data) < 16:
                raise ValueError("truncated font collection header")
            (base,) = struct.unpack_from(">I", data, 12)
        head = data[base : base + 12]
        if len(head) < 12 or head[:4] not in _SFNT_VERSIONS:
            raise ValueError("Not a TrueType or OpenType font (bad sfntVersion)")
        (num,) = struct.unpack_from(">H", head, 4)
        if base + 12 + 16 * num > len(data):
            raise ValueError("truncated sfnt table directory")
        self.tables: dict[str, tuple[int, int]] = {}
        for k in range(num):
            tag, _, off, length = struct.unpack_from(">4sIII", data, base + 12 + 16 * k)
            self.tables[tag.decode("latin1")] = (off, length)

    def table(self, tag: str) -> bytes:
        """A table's bytes (KeyError when the font has no such table)."""
        off, length = self.tables[tag]
        return self.data[off : off + length]

    def _head(self) -> bytes:
        head = self.table("head")
        if len(head) < 54:
            raise ValueError("truncated 'head' table")
        return head

    @property
    def units_per_em(self) -> int:
        return struct.unpack_from(">H", self._head(), 18)[0]

    @property
    def index_to_loc_format(self) -> int:
        return struct.unpack_from(">h", self._head(), 50)[0]

    def debug_name(self, name_id: int) -> str | None:
        """The name record ``name_id`` as fontTools' ``getDebugName``
        picks it; None when no record of that ID decodes."""
        if "name" not in self.tables:
            return None
        name = self.table("name")
        if len(name) < 6:
            return None
        _, count, string_off = struct.unpack_from(">HHH", name, 0)
        strings = name[string_off:]
        some = None
        for k in range(count):
            rec = 6 + 12 * k
            if rec + 12 > len(name):
                break
            platform, enc, lang, nid, length, off = struct.unpack_from(
                ">HHHHHH", name, rec
            )
            if nid != name_id or off + length > len(strings):
                continue
            raw = strings[off : off + length]
            codec = _encoding(platform, enc, lang)
            if codec == "utf_16_be" and len(raw) % 2 and raw[-1:] == b"\0":
                raw = raw[:-1]
            try:
                text = raw.decode(codec)
            except UnicodeDecodeError:
                continue
            some = text
            if (platform, lang) in ((1, 0), (3, 0x409)):
                return text or None
        return some or None
