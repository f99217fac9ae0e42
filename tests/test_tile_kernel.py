"""The Hopper tile kernel (`ops/sdf_triton.py`) in Pallas interpret
mode against its plain reference (`ops/sdf_jax.py`), and the choice of
tile field by platform (`utils/device.tile_impl`, `ops/tiles.py`).

Interpret mode runs the kernel body on the CPU, dynamic loop bounds and
masked loads included, so the math and the tile bookkeeping are checked
here; the compiled kernel is checked on the card by chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from versatiles_glyphs_tpu.ops import sdf_triton, tiles
from versatiles_glyphs_tpu.ops.sdf_jax import min_field_pts_jax, render_bitmaps_pts_jax
from versatiles_glyphs_tpu.render.batch import (
    S_BUCKETS, bucket, pack_points, pack_points_delta, plan_tiles,
)
from versatiles_glyphs_tpu.render.metrics import Q16_SCALE
from versatiles_glyphs_tpu.utils.device import tile_impl

DEJAVU = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "testdata", "dejavu", "DejaVuSans.ttf",
)
TP = 256
# Small and large outlines in one group ('.', 'A', 'g', 'Ж', '&', '@'),
# so tiles run very different loop trip counts.
CPS = (46, 65, 103, 0x416, 38, 64)


@pytest.fixture(scope="module")
def preps():
    from versatiles_glyphs_tpu.font.entry import FontFileEntry
    from versatiles_glyphs_tpu.render.driver import Renderer

    with open(DEJAVU, "rb") as f:
        entry = FontFileEntry(f.read())
    out = [p for p in Renderer("zeros").prep_block((cp, entry) for cp in CPS)]
    assert all(not p.empty for p in out)
    return out


def _group(preps, wire):
    """(f32 pts, words, tmeta [T_pad, 8], L_max) of one group on the
    given transport, decoded as the device decodes it."""
    if wire == "i8":
        deltas, words, anchors, meta = pack_points_delta(preps, arena_tag="_tk")
        q = np.asarray(jax.jit(tiles.reconstruct_delta)(deltas, anchors))
        pts = q.astype(np.float32) * np.float32(1.0 / Q16_SCALE)
    else:
        dt = np.int16 if wire == "i16" else np.float32
        pts, words, meta, _ = pack_points(preps, dtype=dt, arena_tag="_tk")
        if wire == "i16":
            pts = pts.astype(np.float32) * np.float32(1.0 / Q16_SCALE)
    tmeta, _, T = plan_tiles(preps, meta, TP)
    L_max = bucket(int(meta[:, 4].max()), S_BUCKETS)
    return np.array(pts, np.float32), np.array(words), np.array(tmeta), T, L_max


@pytest.mark.parametrize("wire", ["i8", "i16", "f32"])
def test_render_kernel_interpret_matches_reference(preps, wire):
    pts, words, tmeta, T, L_max = _group(preps, wire)
    want = np.asarray(render_bitmaps_pts_jax(pts, words, tmeta, TP, L_max))
    got = np.asarray(sdf_triton.render_tiles(pts, words, tmeta, TP, interpret=True))
    assert got.dtype == np.uint8 and got.shape == (tmeta.shape[0], TP)
    np.testing.assert_array_equal(got, want)
    assert got[:T].any()


def test_residual_kernel_interpret_matches_reference(preps):
    pts, words, tmeta, _, L_max = _group(preps, "f32")
    want = min_field_pts_jax(pts, words, tmeta, TP, L_max)
    got = sdf_triton.min_field_tiles(pts, words, tmeta, TP, interpret=True)
    for g, w, name in zip(got, want, ("d2", "winding", "argmin")):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def test_skip_and_padding_rows_are_zero(preps):
    """Padding rows (w·h = 0) and rows past a glyph's last pixel store
    zeros in both modes, on the kernel and on the reference."""
    pts, words, tmeta, T, L_max = _group(preps[:2], "f32")
    # A skip row of a real glyph: pix_base at its pixel count.
    skip = tmeta[0].copy()
    skip[6] = skip[2] * skip[3]
    tm = np.concatenate([tmeta[:T], skip[None], np.zeros((3, 8), np.int32)])
    dead = slice(T, T + 4)
    for out in (
        sdf_triton.render_tiles(pts, words, tm, TP, interpret=True),
        render_bitmaps_pts_jax(pts, words, tm, TP, L_max),
        *sdf_triton.min_field_tiles(pts, words, tm, TP, interpret=True),
        *min_field_pts_jax(pts, words, tm, TP, L_max),
    ):
        out = np.asarray(out)
        assert not out[dead].any()
        assert out[:T].any()


def test_tile_impl_by_platform():
    assert tile_impl("gpu") == "kernel"
    assert tile_impl("cpu") == "reference"
    for platform in ("rocm", "metal", "neuron"):
        with pytest.raises(ValueError, match=platform):
            tile_impl(platform)
    with pytest.raises(ValueError, match="unknown tile implementation"):
        tiles.render_field(None, None, None, TP, 0, "interpret")


def test_gpu_request_never_interprets(monkeypatch):
    """The kernel path (what a GPU gets) calls pallas_call on the
    Triton route with interpret off — traced here with a stand-in for
    pallas_call, since the CPU cannot compile Triton."""
    calls = []

    def fake_pallas_call(kernel, *, out_shape, **kw):
        calls.append(kw)
        return lambda *args: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape
        )

    monkeypatch.setattr(sdf_triton.pl, "pallas_call", fake_pallas_call)
    jax.clear_caches()
    try:
        pts = np.zeros((2, 1024), np.float32)
        words = np.zeros(32, np.int32)
        tm = np.zeros((4, 8), np.int32)
        jax.eval_shape(
            lambda: tiles.render_pts(pts, words, tm, TP, 512, "kernel")
        )
        jax.eval_shape(lambda: tiles.min_field(pts, words, tm, TP, 512, "kernel"))
    finally:
        jax.clear_caches()
    assert len(calls) == 2
    for kw in calls:
        assert kw["interpret"] is False
        assert kw["backend"] == "triton"


def test_session_follows_platform(monkeypatch, capsys):
    """A device session on a CPU host renders with the reference; an
    unknown platform is an error, not a fallback; `auto` picks exact on
    a CPU and says so."""
    import versatiles_glyphs_tpu.utils.device as device
    from versatiles_glyphs_tpu.render.driver import Renderer

    s = Renderer("device").start_session(parallel=False)
    assert s._impl == "reference"
    list(s.results())

    assert Renderer("auto").backend == "exact"
    assert "renderer: exact (cpu" in capsys.readouterr().err

    monkeypatch.setattr(device, "default_platform", lambda: "rocm")
    with pytest.raises(ValueError, match="rocm"):
        Renderer("device").start_session(parallel=False)
    with pytest.raises(ValueError, match="rocm"):
        Renderer("auto")


@pytest.mark.parametrize("transport", ["i8", "i16", "f32"])
def test_device_session_matches_exact(preps, transport):
    """The whole single-device session (pack, one jit of decode + tile
    table + field, async fetch, dispatcher thread) against the exact
    f64 renderer: every byte within ±1, on ≤5% of pixels."""
    from versatiles_glyphs_tpu.ops.sdf_ref import render_sdf_exact
    from versatiles_glyphs_tpu.render.driver import Renderer

    got = Renderer("device", transport=transport).render_bitmaps(
        preps, parallel=False
    )
    nbad = total = 0
    for p, bm in zip(preps, got):
        want = render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0)
        d = np.abs(np.asarray(bm, np.int32) - want.astype(np.int32))
        assert d.max(initial=0) <= 1
        nbad += int((d > 0).sum())
        total += d.size
    assert nbad <= 0.05 * total


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the program uses it and sets no
    directory itself."""
    from versatiles_glyphs_tpu.utils.device import enable_compilation_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_checkout(monkeypatch):
    """Unset: a fixed directory inside the checkout, which git ignores."""
    from versatiles_glyphs_tpu.utils.device import CACHE_DIR, enable_compilation_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert enable_compilation_cache() == CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert os.path.dirname(CACHE_DIR) == repo
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
