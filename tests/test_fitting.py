"""Font-fitting tests: optimization convergence (single device) and the
mesh-sharded train step over 8 virtual CPU devices (the multi-chip
emulation strategy — SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from versatiles_glyphs_tpu.models.fitting import FontFitter, make_fit_batch
from versatiles_glyphs_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def fit_batch(fira_entry):
    # Self-fit two glyphs, perturbed start.
    return make_fit_batch(fira_entry, [111, 110])  # 'o', 'n'


def test_fit_recovers_perturbed_outline(fit_batch):
    rng = np.random.default_rng(1)
    batch = fit_batch
    noisy = batch.curves0 + rng.normal(0, 0.35, batch.curves0.shape).astype(
        np.float32
    ) * batch.curve_mask[..., None, None]
    import dataclasses

    noisy_batch = dataclasses.replace(batch, curves0=noisy)

    fitter = FontFitter(depth=2, learning_rate=0.01)
    params, opt_state, dev_batch = fitter.init(noisy_batch)
    losses = []
    for _ in range(200):
        params, opt_state, loss = fitter.step(params, opt_state, dev_batch)
        losses.append(float(loss))
    # The hard-min objective is noisy step-to-step; judge convergence
    # by the best point of the trajectory plus a no-blowup check.
    assert min(losses) < 0.5 * losses[0], (losses[0], min(losses), losses[-1])
    assert losses[-1] < losses[0]
    assert np.isfinite(np.asarray(params["curves"])).all()


def test_fit_sharded_over_cpu_mesh(fit_batch):
    """Full train step jitted over an 8-device mesh: batch sharded on
    'data', scalar gain replicated (its gradient is the all-reduce)."""
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "conftest requests 8 virtual CPU devices"
    mesh = make_mesh(devs[:8])

    # Pad batch to 8 glyphs by tiling.
    import dataclasses

    b = fit_batch
    reps = -(-8 // b.curves0.shape[0])
    batch8 = dataclasses.replace(
        b,
        curves0=np.tile(b.curves0, (reps, 1, 1, 1))[:8],
        curve_mask=np.tile(b.curve_mask, (reps, 1))[:8],
        px=np.tile(b.px, (reps, 1))[:8],
        py=np.tile(b.py, (reps, 1))[:8],
        pix_mask=np.tile(b.pix_mask, (reps, 1))[:8],
        target=np.tile(b.target, (reps, 1))[:8],
    )

    fitter = FontFitter(mesh=mesh, depth=2, learning_rate=0.05)
    params, opt_state, dev_batch = fitter.init(batch8)
    # Verify the intended placements.
    assert len(params["curves"].sharding.device_set) == 8
    assert len(params["log_gain"].sharding.device_set) == 8  # replicated

    p, o, loss1 = fitter.step(params, opt_state, dev_batch)
    p, o, loss2 = fitter.step(p, o, dev_batch)
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))

    # Sharded result must match the single-device run numerically.
    fitter1 = FontFitter(mesh=None, depth=2, learning_rate=0.05)
    p1, o1, db1 = fitter1.init(batch8)
    _, _, loss1_single = fitter1.step(p1, o1, db1)
    np.testing.assert_allclose(float(loss1), float(loss1_single), rtol=1e-5)


def test_checkpoint_roundtrip(tmp_path, fit_batch):
    fitter = FontFitter(depth=2)
    params, opt_state, dev_batch = fitter.init(fit_batch)
    params, opt_state, _ = fitter.step(params, opt_state, dev_batch)
    path = str(tmp_path / "ckpt.npz")
    FontFitter.save_checkpoint(path, params, opt_state)
    fresh_p, fresh_o, _ = FontFitter(depth=2).init(fit_batch)
    params2, opt_state2 = FontFitter.restore_checkpoint(path, like=(fresh_p, fresh_o))
    np.testing.assert_array_equal(
        np.asarray(params["curves"]), np.asarray(params2["curves"])
    )
    # Resume training from the restored state.
    _, _, loss = fitter.step(params2, opt_state2, dev_batch)
    assert np.isfinite(float(loss))


def test_fit_cli_end_to_end(tmp_path):
    """`fit` CLI over 2 codepoints x 10 steps: the fitted/checkpoint/
    history output contract (cli.py cmd_fit)."""
    import io
    import json
    import os

    from versatiles_glyphs_tpu.cli import main

    FIRA = "/root/reference/testdata/Fira Sans - Regular.ttf"
    out = tmp_path / "fit_out"
    main(
        [
            "fit", FIRA, "--codepoints", "110,111", "--steps", "10",
            "--depth", "2", "-o", str(out),
        ],
        stdout=io.StringIO(),
    )
    # fitted.npz: curves + placement params + mask + codepoints.
    data = np.load(out / "fitted.npz")
    assert list(data["codepoints"]) == [110, 111]
    assert data["curves"].shape[0] == 2
    assert data["curves"].shape[2:] == (4, 2)
    assert data["curve_mask"].shape[:1] == (2,)
    assert data["translate"].shape == (2, 2)
    assert data["log_gain"].shape == ()  # global sharpness gain

    # The checkpoint restores to the same params.
    from versatiles_glyphs_tpu.font.entry import FontFileEntry
    from versatiles_glyphs_tpu.models.fitting import FontFitter, make_fit_batch

    with open(FIRA, "rb") as f:
        batch = make_fit_batch(FontFileEntry(f.read()), [110, 111], depth=2)
    like = FontFitter(depth=2).init(batch)[:2]
    params, opt_state = FontFitter.restore_checkpoint(
        str(out / "checkpoint.npz"), like=like
    )
    np.testing.assert_allclose(
        np.asarray(params["curves"]), data["curves"], rtol=0, atol=0
    )

    # history.json: monotone steps, finite losses, final step present.
    hist = json.loads((out / "history.json").read_text())
    steps = [h["step"] for h in hist]
    assert steps == sorted(steps) and steps[-1] == 9
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert os.path.isfile(out / "checkpoint.npz")


def test_step_many_matches_sequential(fit_batch):
    """K scan-chained steps (`step_many`, the production dispatch shape)
    must follow the same trajectory as K individual `step` calls."""
    fitter = FontFitter(depth=2, learning_rate=0.01)
    p1, o1, dev = fitter.init(fit_batch)
    seq = []
    for _ in range(4):
        p1, o1, loss = fitter.step(p1, o1, dev)
        seq.append(float(loss))

    p2, o2, _ = fitter.init(fit_batch)
    p2, o2, losses = fitter.step_many(p2, o2, dev, 4)
    np.testing.assert_allclose(np.asarray(losses), np.asarray(seq), rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(p2["curves"]), np.asarray(p1["curves"]), atol=1e-5
    )


def test_fitted_render_matches_reference_at_init(fira_entry):
    """Identity round trip: rendering the UNFITTED
    parameters (init = the font's own outlines) through the production
    pipeline must reproduce the reference bitmaps up to the fixed-depth
    chord approximation — advance exact, left/top within ±1, bitmap
    bytes close in the mean."""
    from versatiles_glyphs_tpu.models.fitting import init_params
    from versatiles_glyphs_tpu.models.render_fitted import fitted_preps
    from versatiles_glyphs_tpu.ops.sdf_ref import render_sdf_exact
    from versatiles_glyphs_tpu.render.driver import Renderer
    from versatiles_glyphs_tpu.render.metrics import prepare_glyph

    cps = [65, 66, 67, 79, 101]  # A B C O e — straight+curved mix
    batch = make_fit_batch(fira_entry, cps, depth=3)
    params = {
        k: np.asarray(v) for k, v in init_params(batch.curves0).items()
    }
    preps = fitted_preps(params, batch, fira_entry, depth=3)
    assert [p.codepoint for p in preps] == cps

    r = Renderer("exact")
    total = diff = 0
    for p in preps:
        ref = prepare_glyph(
            p.codepoint,
            fira_entry.outline_rings(fira_entry.glyph_name(p.codepoint)),
            fira_entry.units_per_em,
            fira_entry.hor_advance(fira_entry.glyph_name(p.codepoint)),
        )
        assert p.advance == ref.advance
        # Measured: depth-3 chords reproduce the adaptive flattener's
        # metrics exactly on this set (bbox from on-curve points).
        assert (p.pbf_left, p.pbf_top, p.width, p.height) == (
            ref.pbf_left, ref.pbf_top, ref.width, ref.height
        )
        got = r.render_bitmaps([p])[0].reshape(p.height, p.width)
        want = render_sdf_exact(
            ref.segments, ref.width, ref.height, ref.x0, ref.y0
        ).reshape(ref.height, ref.width)
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max(initial=0) <= 1  # measured: ±1 byte at curved edges
        diff += int(d.sum())
        total += d.size
    # Measured mean 0.086 bytes/px over A/B/C/O/e; bound with margin.
    assert diff / total < 0.5, diff / total


def test_fit_render_cli_roundtrip(tmp_path):
    """`fit --render` writes PBF blocks the `debug` command can read
    (the read-back contract, `debug.rs:38-95`), and a short self-fit's
    rendered bitmaps stay close to the font's own SDFs."""
    import io

    from versatiles_glyphs_tpu.cli import main
    from versatiles_glyphs_tpu.font.entry import FontFileEntry
    from versatiles_glyphs_tpu.ops.sdf_ref import render_sdf_exact
    from versatiles_glyphs_tpu.proto.pbf import decode_glyphs
    from versatiles_glyphs_tpu.render.metrics import prepare_glyph

    FIRA = "/root/reference/testdata/Fira Sans - Regular.ttf"
    out = tmp_path / "fit_out"
    main(
        [
            "fit", FIRA, "--codepoints", "65-70", "--steps", "10",
            "--depth", "3", "-o", str(out), "--render",
        ],
        stdout=io.StringIO(),
    )
    glyph_dir = out / "glyphs" / "fira_sans_regular"
    assert (glyph_dir / "0-255.pbf").exists()
    # The full atlas layout: fontstack subdir + index files.
    import json as _json

    idx = _json.loads((out / "glyphs" / "index.json").read_text())
    assert idx == ["fira_sans_regular"]
    fam = _json.loads((out / "glyphs" / "font_families.json").read_text())
    assert fam[0]["faces"][0]["id"] == "fira_sans_regular"

    # debug reads the fontstack directory (sorted rows, one per glyph).
    buf = io.StringIO()
    main(["debug", str(glyph_dir)], stdout=buf)
    rows = buf.getvalue().strip().splitlines()
    ids = [int(r.split(",")[0]) for r in rows[1:]]
    assert ids == list(range(65, 71))

    # Rendered bitmaps ≈ the font's own SDFs (self-fit, few steps).
    with open(FIRA, "rb") as f:
        entry = FontFileEntry(f.read())
    glyphs = decode_glyphs((glyph_dir / "0-255.pbf").read_bytes())
    total = diff = 0
    for g in glyphs:
        name = entry.glyph_name(g.id)
        ref = prepare_glyph(
            g.id, entry.outline_rings(name), entry.units_per_em,
            entry.hor_advance(name),
        )
        assert g.advance == ref.advance
        w, h = g.width + 6, g.height + 6
        got = np.frombuffer(g.bitmap, np.uint8).reshape(h, w)
        want = render_sdf_exact(
            ref.segments, ref.width, ref.height, ref.x0, ref.y0
        ).reshape(ref.height, ref.width)
        hh, ww = min(h, ref.height), min(w, ref.width)
        d = np.abs(
            got[:hh, :ww].astype(np.int32) - want[:hh, :ww].astype(np.int32)
        )
        diff += int(d.sum())
        total += d.size
    assert diff / total < 6.0, diff / total


def test_fit_cli_resume(tmp_path):
    """`fit --resume` continues from the checkpoint: two 5-step
    runs (the second resumed) must land exactly where one 10-step run
    does (same params, same loss trajectory tail)."""
    import io

    from versatiles_glyphs_tpu.cli import main

    FIRA = "/root/reference/testdata/Fira Sans - Regular.ttf"
    base = ["fit", FIRA, "--codepoints", "110,111", "--depth", "2"]

    out10 = tmp_path / "one"
    main(base + ["--steps", "10", "-o", str(out10)], stdout=io.StringIO())

    out5a = tmp_path / "a"
    out5b = tmp_path / "b"
    main(base + ["--steps", "5", "-o", str(out5a)], stdout=io.StringIO())
    main(
        base + [
            "--steps", "5", "-o", str(out5b),
            "--resume", str(out5a / "checkpoint.npz"),
        ],
        stdout=io.StringIO(),
    )

    a = np.load(out10 / "fitted.npz")
    b = np.load(out5b / "fitted.npz")
    np.testing.assert_allclose(
        a["curves"], b["curves"], rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        a["translate"], b["translate"], rtol=0, atol=1e-6
    )
