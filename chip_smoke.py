#!/usr/bin/env python3
"""Smoke test of the atlas build on one GPU, at the size of a real font.

    python chip_smoke.py               # one card: every default phase
    python chip_smoke.py --four-cards  # the four-card mesh paths only

Everything runs in this one process (a JAX process reserves most of a
card's memory, so a second one could not start), through the entry
points a user calls (`cli.main`, `FontFitter`):

1. device   — the platform is a GPU and the native host library loaded;
2. kernels  — DejaVu Sans at full coverage, packed into groups the way
              the render session packs them: the tile kernel against
              its plain reference on the card, the whole device session
              against the native f64 renderer (i8 and f32 transports),
              the kernel's residual mode against its reference, and the
              time of kernel and plain version per group;
3. atlas    — `merge` with the device renderer against the exact one,
              cold and warm, then `recurse` of the six DejaVu faces to
              a tar;
4. fit      — `FontFitter(backend="pallas")` fitting DejaVu Sans A–Z to
              DejaVu Serif, checked against the jnp backend at step 0,
              then rendered back to PBF blocks.

Tolerances are looser than bitwise where XLA and Triton may contract
multiply-adds into FMAs differently on the card:

- kernel vs plain reference: every byte within ±1;
- device render vs the f64 renderer: ±1 on at most 5% of pixels (the
  repo's parity contract, README "Parity");
- residual mode: winding identical, min-d² within rel 1e-6, argmin
  equal except where two segments tie within that tolerance.

Prints the card's name and power limit, the device, each check, and as
its last line one JSON object; exits non-zero on any failed check and
when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tarfile
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FONTS = os.path.join(HERE, "testdata", "dejavu")
SANS = os.path.join(FONTS, "DejaVuSans.ttf")
SERIF = os.path.join(FONTS, "DejaVuSerif.ttf")
TP = 256
# DejaVu Sans coverage, and the faces `recurse` finds.
EXPECT_CPS, EXPECT_BLOCKS, EXPECT_FACES = 5918, 51, 6

# Fit learning rate. The model keeps the two ends that meet at a ring
# vertex as separate parameters, and Adam's first steps move every
# parameter by about the rate: above ~1e-5 px the two copies part, the
# ring opens, and the winding sum of a pixel row through the gap flips
# (both backends alike). 3e-6 keeps ten steps well inside that.
FIT_LR = 3e-6

# Tolerances (see the module docstring).
KERNEL_VS_PLAIN_MAX = 1
PARITY_MAX, PARITY_SHARE = 1, 0.05
RESID_REL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")
    log(f"ok: {msg}")


def median_time(fn, reps: int = 5) -> float:
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# -- comparisons -------------------------------------------------------


def pbf_parity(a: dict, b: dict, what: str):
    """Two atlases as {relative path: bytes}: same files, identical
    non-PBF files, identical glyph ids and integer metrics, bitmaps
    within ±PARITY_MAX on at most PARITY_SHARE of pixels."""
    import numpy as np

    from versatiles_glyphs_tpu.proto.pbf import decode_glyphs

    check(sorted(a) == sorted(b), f"{what}: same {len(a)} files")
    nbad = total = worst = glyphs = 0
    for name in sorted(a):
        if not name.endswith(".pbf"):
            check(a[name] == b[name], f"{what}: {name} identical")
            continue
        ga, gb = decode_glyphs(a[name]), decode_glyphs(b[name])
        if [g.id for g in ga] != [g.id for g in gb]:
            raise SystemExit(f"FAILED: {what}: glyph ids differ in {name}")
        for x, y in zip(ga, gb):
            mx = (x.width, x.height, x.left, x.top, x.advance)
            my = (y.width, y.height, y.left, y.top, y.advance)
            if mx != my:
                raise SystemExit(f"FAILED: {what}: metrics of {x.id} in {name}")
            if bool(x.bitmap) != bool(y.bitmap):
                raise SystemExit(f"FAILED: {what}: bitmap presence of {x.id}")
            if x.bitmap:
                d = np.abs(
                    np.frombuffer(x.bitmap, np.uint8).astype(np.int32)
                    - np.frombuffer(y.bitmap, np.uint8).astype(np.int32)
                )
                worst = max(worst, int(d.max()))
                nbad += int((d > 0).sum())
                total += d.size
            glyphs += 1
    share = nbad / max(total, 1)
    check(
        worst <= PARITY_MAX and share <= PARITY_SHARE,
        f"{what}: {glyphs} glyphs, integer metrics identical, bitmaps max "
        f"|d| {worst}, {share:.4%} of {total} pixels differ",
    )
    return glyphs


def dir_files(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def tar_files(buf: bytes) -> dict:
    out = {}
    with tarfile.open(fileobj=io.BytesIO(buf)) as tf:
        for m in tf.getmembers():
            if m.isdir():
                out[m.name.rstrip("/") + "/"] = b""
            else:
                out[m.name] = tf.extractfile(m).read()
    return out


# -- phases ------------------------------------------------------------


def phase_device(expect_count: int):
    import jax

    from versatiles_glyphs_tpu.proto import native

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"platform gpu ({devs[0].device_kind})")
    check(len(devs) == expect_count, f"{len(devs)} card(s) in use")
    check(native.available(), "native host library built and loaded")


def session_groups(preps):
    """The device groups a single-device render session packs ``preps``
    into, recorded from one session."""
    from versatiles_glyphs_tpu.render.driver import Renderer

    r = Renderer("device")
    groups = []
    dispatch = r._dispatch_group

    def record(gitems, *args):
        groups.append([p for _, p in gitems])
        return dispatch(gitems, *args)

    r._dispatch_group = record
    r.render_bitmaps(preps, parallel=False)
    return groups


def phase_kernels(report):
    import jax
    import numpy as np

    from versatiles_glyphs_tpu.font.entry import FontFileEntry
    from versatiles_glyphs_tpu.ops import sdf_jax, tiles
    from versatiles_glyphs_tpu.proto import native
    from versatiles_glyphs_tpu.render.batch import (
        S_BUCKETS, bucket, pack_points, plan_tiles,
    )
    from versatiles_glyphs_tpu.render.driver import Renderer

    with open(SANS, "rb") as f:
        entry = FontFileEntry(f.read())
    cps = entry.metadata.codepoints
    blocks = {cp // 256 for cp in cps}
    check(len(cps) == EXPECT_CPS and len(blocks) == EXPECT_BLOCKS,
          f"DejaVu Sans: {len(cps)} codepoints over {len(blocks)} blocks")
    preps = [p for p in Renderer("zeros").prep_block((cp, entry) for cp in cps)
             if not p.empty]
    groups = session_groups(preps)
    log(f"{len(preps)} non-empty glyphs in {len(groups)} device groups")

    worst = nbad = total = 0
    t_kernel = t_plain = 0.0
    for gi, g in enumerate(groups):
        pts, words, meta, _ = pack_points(g, arena_tag="_smoke")
        tm, _, T = plan_tiles(g, meta, TP)
        L = bucket(int(meta[:, 4].max()), S_BUCKETS)
        pts_d, words_d, tm_d = (jax.device_put(np.array(a)) for a in (pts, words, tm))
        k = np.asarray(tiles.render_pts(pts_d, words_d, tm_d, TP, L, "kernel"))[:T]
        r = np.asarray(tiles.render_pts(pts_d, words_d, tm_d, TP, L, "reference"))[:T]
        d = np.abs(k.astype(np.int32) - r.astype(np.int32))
        worst = max(worst, int(d.max()))
        nbad += int((d > 0).sum())
        total += d.size
        tk = median_time(lambda: tiles.render_pts(pts_d, words_d, tm_d, TP, L, "kernel"))
        plain = {
            bs: median_time(
                lambda bs=bs: sdf_jax.render_bitmaps_pts_jax(
                    pts_d, words_d, tm_d, TP, L, batch_size=bs
                ),
                reps=3,
            )
            for bs in (8, 32, 128)
        }
        bs_best = min(plain, key=plain.get)
        t_kernel += tk
        t_plain += plain[bs_best]
        log(f"group {gi}: {len(g)} glyphs, {int(meta[:len(g), 4].sum())} lanes, "
            f"{T} tiles, L_max {L}: kernel {tk * 1e3:.3f} ms, plain XLA "
            f"{plain[bs_best] * 1e3:.3f} ms (lax.map batch_size={bs_best}; "
            + ", ".join(f"{b}: {t * 1e3:.3f}" for b, t in plain.items()) + ")")
    check(worst <= KERNEL_VS_PLAIN_MAX,
          f"render kernel vs plain reference on the card: max |d| {worst}, "
          f"{nbad / total:.6%} of {total} pixels differ")
    log(f"render time, all groups: kernel {t_kernel * 1e3:.3f} ms, plain XLA "
        f"{t_plain * 1e3:.3f} ms ({t_plain / t_kernel:.2f}x)")
    report["render_kernel_ms"] = t_kernel * 1e3
    report["render_plain_ms"] = t_plain * 1e3

    exact = native.render_sdf_batch(preps)
    for transport in ("i8", "f32"):
        got = Renderer("device", transport=transport).render_bitmaps(
            preps, parallel=False
        )
        w = bad = tot = 0
        for a, b in zip(got, exact):
            d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
            w = max(w, int(d.max(initial=0)))
            bad += int((d > 0).sum())
            tot += d.size
        check(w <= PARITY_MAX and bad / tot <= PARITY_SHARE,
              f"device session ({transport}) vs native f64: max |d| {w}, "
              f"{bad / tot:.4%} of {tot} pixels differ")

    # Residual mode on the largest-outline group.
    g = max(groups, key=lambda g: max(p.npts for p in g))
    pts, words, meta, _ = pack_points(g, arena_tag="_smoke")
    tm, _, T = plan_tiles(g, meta, TP)
    L = bucket(int(meta[:, 4].max()), S_BUCKETS)
    pts_np = np.array(pts)
    args = [jax.device_put(np.array(a)) for a in (pts, words, tm)]
    kd2, kwn, kam = (np.asarray(x)[:T] for x in tiles.min_field(*args, TP, L, "kernel"))
    rd2, rwn, ram = (np.asarray(x)[:T] for x in tiles.min_field(*args, TP, L, "reference"))
    check(np.array_equal(kwn, rwn), "residual mode: winding identical")
    live = rd2 < 1e30
    rel = np.abs(kd2 - rd2)[live] / np.maximum(rd2[live], 1e-30)
    check(float(rel.max(initial=0)) <= RESID_REL,
          f"residual mode: min-d2 max rel diff {float(rel.max(initial=0)):.3e}")
    diff = np.argwhere(kam != ram)
    ties = 0
    for t, j in diff:
        row = np.array(tm)[t]
        i = int(row[6]) + int(j)
        w_ = max(int(row[2]), 1)
        px = row[0] + i % w_ + 0.5
        py = row[1] + (int(row[3]) - 1 - i // w_) + 0.5

        def d2(lane):
            v, w2 = pts_np[:, lane].astype(np.float64), pts_np[:, lane + 1].astype(np.float64)
            e = w2 - v
            tt = np.clip(((px - v[0]) * e[0] + (py - v[1]) * e[1]) / max(e @ e, 1e-300), 0, 1)
            q = np.array([px, py]) - (v + tt * e)
            return float(q @ q)

        a, b = d2(int(kam[t, j])), d2(int(ram[t, j]))
        if abs(a - b) > RESID_REL * max(a, b, 1e-12):
            raise SystemExit(f"FAILED: residual argmin differs at a unique minimum (tile {t}, px {j})")
        ties += 1
    check(True, f"residual mode: argmin equal except {ties} exact ties")
    tk = median_time(lambda: tiles.min_field(*args, TP, L, "kernel"))
    tp = median_time(
        lambda: sdf_jax.min_field_pts_jax(*args, TP, L, batch_size=32), reps=3
    )
    log(f"residual mode, {T} tiles, L_max {L}: kernel {tk * 1e3:.3f} ms, plain XLA "
        f"{tp * 1e3:.3f} ms (lax.map batch_size=32)")
    report["resid_kernel_ms"] = tk * 1e3
    report["resid_plain_ms"] = tp * 1e3
    return len(preps)


def phase_atlas(tmp: str, report):
    from versatiles_glyphs_tpu.cli import main
    from versatiles_glyphs_tpu.render.driver import RENDER_STATS, reset_render_stats

    n_cps = EXPECT_CPS
    outs = {}
    for tag, renderer in (("device-cold", "device"), ("device-warm", "device"),
                          ("exact", "exact")):
        out = os.path.join(tmp, tag)
        reset_render_stats()
        t0 = time.perf_counter()
        main(["merge", SANS, "-o", out, "--renderer", renderer])
        dt = time.perf_counter() - t0
        outs[tag] = dir_files(out)
        log(f"merge DejaVu Sans --renderer {renderer} ({tag}): {dt:.3f} s, "
            f"{n_cps / dt:.1f} glyphs/s, device groups {RENDER_STATS['groups']}")
        report[f"merge_{tag}_s"] = dt
    check(outs["device-cold"] == outs["device-warm"],
          "two device merges in one process: byte-identical output")
    report["merge_setup_s"] = report["merge_device-cold_s"] - report["merge_device-warm_s"]
    log(f"merge set-up (cold - warm, compile included): {report['merge_setup_s']:.3f} s")
    pbf_parity(outs["device-warm"], outs["exact"], "merge device vs exact")

    tars = {}
    for renderer in ("device", "exact"):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        main(["recurse", FONTS, "--tar", "--renderer", renderer], stdout=buf)
        log(f"recurse six DejaVu faces --tar --renderer {renderer}: "
            f"{time.perf_counter() - t0:.3f} s")
        tars[renderer] = tar_files(buf.getvalue())
    names = tars["device"]
    dirs = sorted(n for n in names if n.endswith("/"))
    check(len(dirs) == EXPECT_FACES and "index.json" in names
          and "font_families.json" in names,
          f"tar lists {len(dirs)} font directories, index.json, font_families.json")
    pbf_parity(tars["device"], tars["exact"], "recurse device vs exact")


def chain_to_points(grad, batch):
    """Sum a [B, C, 4, 2] curves gradient over control points that sit
    at the same position of one glyph (curve ends shared by two
    curves); interior control points stay their own entries."""
    import numpy as np

    acc: dict = {}
    for g in range(grad.shape[0]):
        for c in np.flatnonzero(batch.curve_mask[g]):
            for j in range(4):
                key = (g, *batch.curves0[g, c, j]) if j in (0, 3) else (g, c, j)
                acc[key] = acc.get(key, 0.0) + grad[g, c, j]
    return np.array([acc[k] for k in sorted(acc, key=repr)])


def fit_batch():
    """DejaVu Sans A–Z fitted to DejaVu Serif targets, depth 3.

    fontTools is not installed beside the card, so the initial curves
    are the natively flattened rings as line cubics. They are turned by
    1 mrad and stretched by 3e-4 in y: axis-aligned stems otherwise put
    pixels at EXACT distance ties between unrelated segments, where the
    jnp and tile-field backends pick different valid subgradients and
    the step-0 comparison would measure the tie rule, not the field."""
    import numpy as np

    from versatiles_glyphs_tpu.font.entry import FontFileEntry
    from versatiles_glyphs_tpu.models.fitting import make_fit_batch

    with open(SANS, "rb") as f:
        sans = FontFileEntry(f.read())
    with open(SERIF, "rb") as f:
        serif = FontFileEntry(f.read())
    batch = make_fit_batch(sans, range(65, 91), depth=3, target_entry=serif,
                           line_cubics=True)
    th = 1e-3
    m = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    m = m * np.array([1.0, 1.0003])[:, None]
    batch.curves0 = (batch.curves0.astype(np.float64) @ m.T).astype(np.float32)
    return sans, batch


def phase_fit(tmp: str, report):
    import jax
    import numpy as np

    from versatiles_glyphs_tpu.font.names import name_to_id
    from versatiles_glyphs_tpu.models.fitting import FontFitter, batch_loss
    from versatiles_glyphs_tpu.models.render_fitted import render_fitted_pbfs
    from versatiles_glyphs_tpu.proto.pbf import decode_glyphs
    from versatiles_glyphs_tpu.render.driver import Renderer

    sans, batch = fit_batch()
    B, C = batch.curves0.shape[:2]
    log(f"fit batch: {B} glyphs, {C} curves max, {batch.target.shape[1]} px max")

    fitter = FontFitter(depth=3, learning_rate=FIT_LR, backend="pallas")
    params, opt_state, dev = fitter.init(batch)
    with jax.default_matmul_precision("highest"):
        lk, gk = jax.value_and_grad(fitter._kernel_loss)(params, dev)
        jdev = FontFitter(depth=3, backend="jnp").init(batch)[2]
        lj, gj = jax.value_and_grad(batch_loss)(params, jdev, 3, None)
    lk, lj = float(lk), float(lj)
    check(abs(lk - lj) < 1e-5 * max(lj, 1e-6),
          f"fit step 0: loss {lk:.7f} (pallas) vs {lj:.7f} (jnp)")
    for k in ("translate", "log_gain"):
        a, b = np.asarray(gj[k]), np.asarray(gk[k])
        scale = max(float(np.abs(a).max()), 1e-6)
        check(np.allclose(b, a, rtol=0, atol=1e-4 * scale),
              f"fit step 0: {k} gradient within 1e-4 of its scale")
    # The backends split a hard-min tie differently (jnp.min evenly, the
    # tile field to the first argmin), and with line cubics every ring
    # vertex is a curve end shared by two curves, a tie no turn breaks:
    # compare gradients chained to the shared point, as the fit moves it.
    a = chain_to_points(np.asarray(gj["curves"]), batch)
    b = chain_to_points(np.asarray(gk["curves"]), batch)
    scale = max(float(np.abs(a).max()), 1e-6)
    frac = float((np.abs(a - b) > 1e-3 * scale).mean())
    check(frac < 0.15, f"fit step 0: curves gradient, chained to shared "
          f"points, differs beyond 1e-3 of its scale on {frac:.3%} of entries")
    ga, gb = np.asarray(gj["curves"]), np.asarray(gk["curves"])
    check(np.allclose(gb.sum(axis=(1, 2)), ga.sum(axis=(1, 2)), rtol=0,
                      atol=1e-4 * scale), "fit step 0: per-glyph gradient sums agree")

    t0 = time.perf_counter()
    params, opt_state, losses = fitter.step_many(params, opt_state, dev, 10)
    losses = np.asarray(losses)
    dt = time.perf_counter() - t0
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"10 chained fit steps: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({dt:.3f} s incl. compile)")
    t0 = time.perf_counter()
    params, opt_state, losses = fitter.step_many(params, opt_state, dev, 10)
    np.asarray(losses)
    report["fit_10_steps_warm_s"] = time.perf_counter() - t0
    log(f"10 more chained fit steps, warm: {report['fit_10_steps_warm_s']:.3f} s")

    host = {k: np.asarray(v) for k, v in params.items()}
    out = os.path.join(tmp, "fitted")
    written = render_fitted_pbfs(
        host, batch, sans, 3, out, name_to_id(sans.metadata.generate_name()),
        renderer=Renderer("device"),
    )
    n = 0
    for fname in written:
        with open(os.path.join(out, name_to_id(sans.metadata.generate_name()), fname), "rb") as f:
            n += sum(1 for g in decode_glyphs(f.read()) if g.bitmap)
    check(n == B, f"fitted outlines rendered to {len(written)} PBF block(s), {n} glyphs decode")


def phase_four_cards(tmp: str):
    import jax
    import numpy as np

    from versatiles_glyphs_tpu.cli import main
    from versatiles_glyphs_tpu.models.fitting import FontFitter
    from versatiles_glyphs_tpu.parallel.mesh import make_mesh
    from versatiles_glyphs_tpu.render.driver import RENDER_STATS, reset_render_stats

    tars = {}
    for tag, extra in (("mesh", []), ("one card", ["--single-thread"])):
        buf = io.BytesIO()
        reset_render_stats()
        t0 = time.perf_counter()
        main(["recurse", FONTS, "--tar", "--renderer", "device", *extra], stdout=buf)
        log(f"recurse six DejaVu faces on {tag}: {time.perf_counter() - t0:.3f} s")
        tars[tag] = tar_files(buf.getvalue())
        if tag == "mesh":
            check(RENDER_STATS["shard_devices"] == 4,
                  f"mesh result shards on {RENDER_STATS['shard_devices']} distinct devices")
    check(tars["mesh"] == tars["one card"],
          f"recurse on the 4-card mesh == --single-thread on one card "
          f"({len(tars['mesh'])} tar members, byte-identical)")

    _, batch = fit_batch()
    losses = {}
    for tag, mesh in (("one card", None), ("4-card mesh", make_mesh(jax.devices()[:4]))):
        fitter = FontFitter(mesh=mesh, depth=3, learning_rate=FIT_LR, backend="pallas")
        params, opt_state, dev = fitter.init(batch)
        _, _, loss = fitter.step(params, opt_state, dev)
        losses[tag] = float(loss)
    a, b = losses["one card"], losses["4-card mesh"]
    check(np.isfinite(b) and abs(a - b) < 1e-5 * max(a, 1e-6),
          f"fit step on the 4-card mesh: loss {b:.7f} vs one card {a:.7f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh paths and what they "
                    "are compared with")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    import versatiles_glyphs_tpu

    pkg_dir = os.path.dirname(os.path.abspath(versatiles_glyphs_tpu.__file__))
    if pkg_dir != os.path.join(HERE, "versatiles_glyphs_tpu"):
        print(f"chip_smoke: package found at {pkg_dir}, not beside this script",
              file=sys.stderr)
        return 2

    import jax

    from versatiles_glyphs_tpu.utils.device import enable_compilation_cache

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {platform!r})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__}, {len(jax.devices())} x {jax.devices()[0].device_kind}")
    log(f"compile cache: {enable_compilation_cache()}")

    report: dict = {}
    expect = 4 if args.four_cards else 1
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log("== phase 1: device")
        phase_device(expect)
        if args.four_cards:
            log("== four cards: recurse and fit step on the mesh")
            phase_four_cards(tmp)
        else:
            log("== phase 2: kernels at real widths")
            phase_kernels(report)
            log("== phase 3: atlas")
            phase_atlas(tmp, report)
            log("== phase 4: fit")
            phase_fit(tmp, report)
    log(f"total {time.perf_counter() - t_all:.1f} s; "
        + ", ".join(f"{k} {v:.3f}" for k, v in report.items()))
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
