"""Close the fitting loop into the product: render fitted outlines
through the production SDF pipeline into consumable PBF blocks.

Every reference pipeline terminates in PBFs a map stack can read
(`/root/reference/src/commands/recurse.rs:70-101`); the differentiable
fitting capability (new scope vs the reference) does too: `fit
--render` turns the optimized control points back into
`{output}/glyphs/{start}-{end}.pbf` blocks via the SAME batched device
render + PBF encode used by `recurse`/`merge`, readable by `debug`
(`/root/reference/src/commands/debug.rs:38-95` is the read-back
contract).

The fitted model's geometry is the fixed-depth De Casteljau chain of
its cubic control points (`models.glyph_model.curves_to_segments`);
rendering evaluates the same chain in float64 (the Bernstein rows at
the dyadic parameters, exact at t=0/1) so the rendered outline is the
model's polyline, not a re-flattening — what you fit is what you ship.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import BUFFER, GLYPH_SIZE
from ..render.metrics import GlyphPrep, _round_half_away


def _bernstein_f64(depth: int) -> np.ndarray:
    """[K, 4] float64 Bernstein evaluation matrix at the K = 2^depth+1
    dyadic parameters (twin of `fitting._bernstein_matrix`, kept in f64
    so chain endpoints equal the control points bitwise and consecutive
    curves sharing control points join watertight)."""
    K = (1 << depth) + 1
    t = np.arange(K, dtype=np.float64) / (K - 1)
    return np.stack(
        [(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t * t * (1 - t), t**3],
        axis=1,
    )


def fitted_prep(
    codepoint: int,
    curves: np.ndarray,
    translate: np.ndarray,
    depth: int,
    advance_units: float,
    units_per_em: int,
) -> GlyphPrep:
    """One `GlyphPrep` from fitted parameters.

    ``curves`` [C, 4, 2] are the glyph's LIVE control points in pixel
    space (the fit initialized them scaled + dx-shifted,
    `fitting.make_fit_batch`); ``translate`` [2] is the fitted
    placement. Metrics re-derive from the fitted geometry with the
    reference's exact integer arithmetic (floor/ceil bbox ± BUFFER,
    `renderer.rs:64-91`); advance comes from the source font (fitting
    moves outlines, not horizontal metrics)."""
    scale = float(GLYPH_SIZE) / float(units_per_em)
    advance_float = float(advance_units) * scale * 0.95
    advance = _round_half_away(advance_float)
    dx = (float(advance) - advance_float) / 2.0

    c = np.asarray(curves, np.float64)
    if c.shape[0] == 0:
        return GlyphPrep(codepoint=codepoint, advance=advance, dx=dx, empty=True)
    c = c + np.asarray(translate, np.float64)[None, None, :]

    M = _bernstein_f64(depth)
    chain = np.einsum("kj,cjd->ckd", M, c)  # [C, K, 2]

    # Merge consecutive curves whose endpoints join bitwise into one
    # chain (halves device lanes vs one chain per curve; the Bernstein
    # rows at t=0/1 are exact, so curves that shared control points
    # before fitting still share them after — the optimizer moves the
    # shared point once).
    rings: list[np.ndarray] = []
    cur = [chain[0]]
    for i in range(1, chain.shape[0]):
        if np.array_equal(cur[-1][-1], chain[i][0]):
            cur.append(chain[i][1:])
        else:
            rings.append(np.concatenate(cur, axis=0))
            cur = [chain[i]]
    rings.append(np.concatenate(cur, axis=0))

    pts = chain.reshape(-1, 2)
    min_x = float(pts[:, 0].min())
    min_y = float(pts[:, 1].min())
    max_x = float(pts[:, 0].max())
    max_y = float(pts[:, 1].max())
    # BBox::is_empty semantics (`src/geometry/bbox.rs:56`).
    if max_x <= min_x and max_y <= min_y:
        return GlyphPrep(codepoint=codepoint, advance=advance, dx=dx, empty=True)

    x0 = int(np.floor(min_x)) - BUFFER
    y0 = int(np.floor(min_y)) - BUFFER
    x1 = int(np.ceil(max_x)) + BUFFER
    y1 = int(np.ceil(max_y)) + BUFFER
    return GlyphPrep(
        codepoint=codepoint,
        advance=advance,
        dx=dx,
        empty=False,
        width=x1 - x0,
        height=y1 - y0,
        x0=x0,
        y0=y0,
        x1=x1,
        y1=y1,
        rings_px=rings,
    )


def fitted_preps(params, batch, entry, depth: int) -> list[GlyphPrep]:
    """GlyphPreps for every fitted glyph of a batch.

    ``params`` is the (host-fetched) parameter pytree from
    `FontFitter`; ``batch`` the `FitBatch` it was fitted on (supplies
    ``curve_mask`` and ``codepoints``); ``entry`` the source
    `FontFileEntry` (advance metrics)."""
    curves = np.asarray(params["curves"], np.float64)
    translate = np.asarray(params["translate"], np.float64)
    cps = batch.codepoints
    if cps is None:
        raise ValueError("FitBatch.codepoints missing (rebuild the batch)")
    # A mesh fit pads the params batch to a device multiple inside
    # FontFitter.init; the caller's batch (and cps) may be the UNPADDED
    # original — iterate the common prefix and skip all-False mask rows
    # (padding) so both shapes are accepted.
    B = min(curves.shape[0], len(cps), batch.curve_mask.shape[0])
    preps = []
    for b in range(B):
        mask = batch.curve_mask[b]
        if not mask.any():
            continue  # mesh padding row / empty glyph
        cp = int(cps[b])
        preps.append(
            fitted_prep(
                cp,
                curves[b][mask],
                translate[b],
                depth,
                entry.advance_units(cp),
                entry.units_per_em,
            )
        )
    return preps


def render_fitted_pbfs(
    params,
    batch,
    entry,
    depth: int,
    out_dir: str,
    fontstack_name: str,
    renderer=None,
) -> list[str]:
    """Render fitted glyphs into a COMPLETE glyph atlas under
    ``out_dir`` through the production pipeline (batched device render
    → PBF encode → writer): `{font_id}/{start}-{end}.pbf` blocks plus
    `index.json` / `font_families.json`, the same frontend layout
    `recurse`/`merge` write (`/root/reference/src/commands/
    recurse.rs:70-101`) — drop-in consumable by a maplibre stack (URL
    template `{fontstack}/{range}.pbf`) and by `debug` on the
    `{out_dir}/{font_id}` directory. Returns the written block
    filenames."""
    from ..font.index_files import build_font_families_json, build_index_json
    from ..proto.pbf import encode_glyphs
    from ..render.driver import Renderer
    from ..writer import Writer

    if renderer is None:
        renderer = Renderer("auto")
    preps = fitted_preps(params, batch, entry, depth)
    nonempty = [p for p in preps if not p.empty]
    bitmaps = renderer.render_bitmaps(nonempty)
    glyphs = Renderer.assemble_glyphs(preps, iter(bitmaps))

    blocks: dict[int, list] = {}
    for g in glyphs:
        blocks.setdefault(g.id // 256, []).append(g)

    os.makedirs(out_dir, exist_ok=True)
    writer = Writer.new_file(os.path.abspath(out_dir))
    writer.write_directory(f"{fontstack_name}/")
    written = []
    for s in sorted(blocks):
        start, end = s * 256, s * 256 + 255
        fname = f"{start}-{end}.pbf"
        writer.write_file(
            f"{fontstack_name}/{fname}",
            encode_glyphs(fontstack_name, f"{start}-{end}", blocks[s]),
        )
        written.append(fname)
    writer.write_file("index.json", build_index_json([fontstack_name]))

    class _Wrap:  # build_font_families_json expects (id, wrapper)
        @staticmethod
        def get_metadata():
            return entry.metadata

    writer.write_file(
        "font_families.json",
        build_font_families_json([(fontstack_name, _Wrap)]),
    )
    writer.finish()
    return written
