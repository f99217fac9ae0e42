"""Mesh-sharded production render: parity vs the single-device path.

Runs on the conftest's 8-virtual-CPU-device mesh (the multi-device
test harness; the tile field is the plain reference on a CPU). The sharded path is the
device-mesh equivalent of the reference's rayon fan-out over the flat
block list (`/root/reference/src/font/manager.rs:102-121`), so parity
here is the analogue of its single-thread-vs-parallel determinism.
"""

import os

import numpy as np

from versatiles_glyphs_tpu.utils.synth_font import build_ttf


def _fira_preps(fira_entry, lo=33, hi=126):
    from versatiles_glyphs_tpu.render.driver import Renderer

    r = Renderer("device")
    preps = []
    for cp in range(lo, hi + 1):
        p = r.prep_glyph(fira_entry, cp)
        if p is not None and not p.empty:
            preps.append(p)
    return preps


def test_data_mesh_present():
    from versatiles_glyphs_tpu.parallel.mesh import data_mesh

    mesh = data_mesh()
    assert mesh is not None and mesh.devices.size == 8


def test_mesh_parity_driver(fira_entry):
    """Sharded render over the 8-device mesh == single-device render,
    byte for byte, on real Fira outlines."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps = _fira_preps(fira_entry)
    assert len(preps) >= 90
    r = Renderer("device")
    serial = r.render_bitmaps(preps, parallel=False)
    sharded = r.render_bitmaps(preps, parallel=True)
    assert len(serial) == len(sharded)
    for a, b in zip(serial, sharded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mesh_parity_f32_transport(fira_entry):
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps = _fira_preps(fira_entry, 48, 90)
    r = Renderer("device", transport="f32")
    serial = r.render_bitmaps(preps, parallel=False)
    sharded = r.render_bitmaps(preps, parallel=True)
    for a, b in zip(serial, sharded):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mesh_manager_path(tmp_path):
    """The PRODUCTION path: `FontManager.render_glyphs` with
    parallel=True shards the run across the mesh and writes files
    byte-identical to the single-device run."""
    from versatiles_glyphs_tpu.font.manager import FontManager
    from versatiles_glyphs_tpu.render.driver import Renderer
    from versatiles_glyphs_tpu.writer import Writer

    font_path = tmp_path / "synth.ttf"
    font_path.write_bytes(build_ttf(n_glyphs=40))

    outs = {}
    for parallel in (True, False):
        root = tmp_path / ("par" if parallel else "ser")
        manager = FontManager(parallel=parallel)
        manager.add_path(os.fspath(font_path))
        writer = Writer.new_file(os.fspath(root))
        manager.render_glyphs(writer, Renderer("device"))
        manager.write_index_json(writer)
        manager.write_families_json(writer)
        writer.finish()
        files = {}
        for dirpath, _, names in os.walk(root):
            for n in names:
                p = os.path.join(dirpath, n)
                files[os.path.relpath(p, root)] = open(p, "rb").read()
        outs[parallel] = files

    assert outs[True].keys() == outs[False].keys()
    assert len(outs[True]) >= 3  # pbf + index.json + font_families.json
    for name in outs[True]:
        assert outs[True][name] == outs[False][name], name


def test_mesh_uneven_and_small_batches(fira_entry):
    """Batch sizes around the mesh size: below 2·D the driver falls
    back to single-device; above, every result must still map back to
    its original index (the LPT bins reorder)."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps = _fira_preps(fira_entry, 33, 70)
    r = Renderer("device")
    for n in (3, 16, 17, 29):
        sub = preps[:n]
        serial = r.render_bitmaps(sub, parallel=False)
        sharded = r.render_bitmaps(sub, parallel=True)
        for a, b in zip(serial, sharded):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mesh_exact_golden(fira_entry):
    """Sharded bitmaps still match the exact f64 reference renderer
    within the f32 tolerance (every byte within ±1)."""
    from versatiles_glyphs_tpu.ops.sdf_ref import render_sdf_exact
    from versatiles_glyphs_tpu.render.driver import Renderer

    preps = _fira_preps(fira_entry, 65, 90)
    r = Renderer("device")
    sharded = r.render_bitmaps(preps, parallel=True)
    for p, bm in zip(preps, sharded):
        ref = render_sdf_exact(p.segments, p.width, p.height, p.x0, p.y0)
        diff = np.abs(
            np.asarray(bm, np.int32) - np.asarray(ref, np.int32)
        )
        assert diff.max() <= 1
        assert (diff != 0).mean() <= 0.05
