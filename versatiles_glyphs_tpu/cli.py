"""Command-line interface: recurse / merge / debug.

Same contract as the reference binary (`/root/reference/src/main.rs`,
`src/commands/{recurse,merge,debug}.rs`):

- ``recurse <dirs...> [-o DIR | -t] [--no-families] [--no-index]`` —
  recursively scans for .ttf/.otf; a directory containing ``fonts.json``
  (``[{name, sources[]}]``) configures that subtree (and short-circuits
  recursion into it).
- ``merge <files...>`` — same flags, positional font files; same-name
  fonts merge.
- ``debug <dir> [--format csv|tsv]`` — reads back BMP-range .pbf files
  and prints one metrics row per glyph, sorted by id (the cross-
  implementation parity tool).

Hidden/backend flags: ``--dummy`` (zeros renderer, as the reference),
``--single-thread`` (one device even when several are attached; the
reference's single-threaded mode), and the device addition
``--renderer {auto,device,jax,exact,zeros}``.

stdout is reserved for payload (tar stream / debug CSV); status goes to
stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .font.manager import FontManager
from .proto.pbf import decode_glyphs
from .render.driver import Renderer
from .utils.output_dir import prepare_output_directory
from .writer import Writer


def _add_output_flags(p: argparse.ArgumentParser) -> None:
    # --tar and -o are mutually exclusive at parse time (the reference
    # uses clap's conflicts_with, `recurse.rs:32-37`).
    group = p.add_mutually_exclusive_group()
    group.add_argument("-o", "--output-directory", default=None)
    group.add_argument("-t", "--tar", action="store_true")
    p.add_argument("--no-families", action="store_true")
    p.add_argument("--no-index", action="store_true")
    p.add_argument("--dummy", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--single-thread", action="store_true", help=argparse.SUPPRESS)
    p.add_argument(
        "--renderer",
        choices=("auto", "device", "jax", "exact", "zeros"),
        default="auto",
        help="SDF backend (default: the device kernel on a GPU, exact f64 "
        "on a host without one)",
    )
    p.add_argument(
        "--transport",
        choices=("auto", "i8", "i16", "f32"),
        default="auto",
        help="device point transport: i8 delta wire format (default; "
        "~2.1 B/lane, decodes to positions bit-identical to i16 — "
        "output within ±1 byte of exact), i16 fixed-point (4 B/lane, "
        "same bytes as i8), or f32 (tighter parity: <0.5%% of pixels "
        "±1, twice the bytes)",
    )


def _make_renderer(args) -> Renderer:
    return Renderer(
        "zeros" if args.dummy else args.renderer,
        transport=getattr(args, "transport", "auto"),
    )


def _run_pipeline(args, manager: FontManager, stdout) -> None:
    if args.tar:
        print("Rendering glyphs as tar to stdout.", file=sys.stderr)
        writer = Writer.new_tar(stdout)
    else:
        out_dir = prepare_output_directory(args.output_directory or "output")
        print(f"Rendering glyphs to directory: {out_dir!r}", file=sys.stderr)
        writer = Writer.new_file(os.path.abspath(out_dir))

    renderer = _make_renderer(args)
    manager.render_glyphs(writer, renderer)
    if not args.no_index:
        manager.write_index_json(writer)
    if not args.no_families:
        manager.write_families_json(writer)
    writer.finish()


def scan(path: str, manager: FontManager) -> None:
    """Recursive scan (`recurse.rs:104-133`): font files are added
    directly; a dir with fonts.json is configured by it (no recursion
    past it); other dirs recurse."""
    if os.path.isfile(path):
        ext = os.path.splitext(path)[1].lower().lstrip(".")
        if ext in ("ttf", "otf"):
            manager.add_path(path)
    elif os.path.isdir(path):
        fonts_json = os.path.join(path, "fonts.json")
        if os.path.exists(fonts_json):
            with open(fonts_json, "rb") as f:
                configs = json.load(f)
            for c in configs:
                manager.add_font_with_name(
                    c["name"], [os.path.join(path, src) for src in c["sources"]]
                )
        else:
            for entry in sorted(os.listdir(path)):
                scan(os.path.join(path, entry), manager)


def cmd_recurse(args, stdout) -> None:
    manager = FontManager(parallel=not args.single_thread)
    for d in args.input_directories:
        canonical = os.path.realpath(os.path.abspath(d))
        print(f"Scanning directory: {canonical!r}", file=sys.stderr)
        scan(canonical, manager)
    _run_pipeline(args, manager, stdout)


def cmd_merge(args, stdout) -> None:
    manager = FontManager(parallel=not args.single_thread)
    manager.add_paths([os.path.realpath(os.path.abspath(p)) for p in args.input_files])
    _run_pipeline(args, manager, stdout)


def cmd_debug(args, stdout) -> None:
    d = args.glyph_directory
    if not os.path.exists(d):
        raise SystemExit(f"Directory does not exist: {d!r}")
    sep = "," if args.format == "csv" else "\t"
    out = stdout
    out.write(
        sep.join(
            ["codepoint", "width", "height", "left", "top", "advance", "bitmap_size"]
        )
        + "\n"
    )
    # BMP only: blocks 0..256 (`debug.rs:66-69`).
    for i in range(256):
        start = i * 256
        path = os.path.join(d, f"{start}-{start + 255}.pbf")
        try:
            with open(path, "rb") as f:
                buf = f.read()
        except FileNotFoundError:
            continue
        try:
            glyphs = decode_glyphs(buf)
        except (ValueError, IndexError) as e:
            raise SystemExit(f"Failed to decode {path!r}: {e}")
        glyphs.sort(key=lambda g: g.id)
        for g in glyphs:
            out.write(
                sep.join(
                    str(v)
                    for v in [
                        g.id,
                        g.width,
                        g.height,
                        g.left,
                        g.top,
                        g.advance,
                        len(g.bitmap) if g.bitmap is not None else 0,
                    ]
                )
                + "\n"
            )


def _parse_codepoints(spec: str) -> list[int]:
    """``"65-90,97,0x100-0x17F"`` → sorted codepoint list."""
    out: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part[1:]:
            lo, hi = part.split("-", 1)
            out.update(range(int(lo, 0), int(hi, 0) + 1))
        else:
            out.add(int(part, 0))
    return sorted(out)


def cmd_fit(args, stdout) -> None:
    """Fit a font's outlines to another font's SDF bitmaps by gradient
    descent on control points (the differentiable path — a capability
    the Rust reference does not have)."""
    from .font.entry import FontFileEntry
    from .models.fitting import FontFitter, make_fit_batch

    with open(args.font, "rb") as f:
        entry = FontFileEntry(f.read())
    target_entry = entry
    if args.target_font:
        with open(args.target_font, "rb") as f:
            target_entry = FontFileEntry(f.read())

    cps = _parse_codepoints(args.codepoints)
    batch = make_fit_batch(entry, cps, depth=args.depth, target_entry=target_entry)
    print(
        f"Fitting {batch.curves0.shape[0]} glyphs "
        f"({batch.curves0.shape[1]} curves max, depth {args.depth}) "
        f"for {args.steps} steps",
        file=sys.stderr,
    )

    mesh = None
    if args.mesh:
        import jax

        from .parallel.mesh import make_mesh

        mesh = make_mesh(jax.devices()[: args.mesh] or None)

    fitter = FontFitter(
        mesh=mesh, depth=args.depth, learning_rate=args.lr,
        sharpness=args.sharpness, backend=args.backend,
    )
    params, opt_state, dev_batch = fitter.init(batch)
    if args.resume:
        # Resume from a checkpoint written by a previous run (the fresh
        # init above supplies the pytree template, so optax NamedTuple
        # states restore with their container types; with a mesh,
        # device placement is re-established by the first step).
        params, opt_state = FontFitter.restore_checkpoint(
            args.resume, like=(params, opt_state)
        )
        print(f"Resumed from checkpoint {args.resume!r}", file=sys.stderr)
    import numpy as np

    # Chained stepping: K optimizer steps per device dispatch
    # (`FontFitter.step_many` — lax.scan), so the CLI fit does not pay
    # a host round trip on every step.
    log_every = max(1, args.steps // 20)
    chunk = min(max(fitter.CHUNK, 1), log_every)
    history = []
    done = 0
    while done < args.steps:
        k = min(chunk, args.steps - done)
        params, opt_state, losses = fitter.step_many(
            params, opt_state, dev_batch, k
        )
        host = np.asarray(losses)
        for j in range(k):
            i = done + j
            if i % log_every == 0 or i == args.steps - 1:
                history.append((i, float(host[j])))
                print(f"step {i}: loss {float(host[j]):.6f}", file=sys.stderr)
        done += k

    os.makedirs(args.output, exist_ok=True)
    # A mesh fit pads the params to a device multiple; slice back to the
    # real batch so every array in fitted.npz shares the row mapping.
    B_real = batch.curves0.shape[0]
    np.savez(
        os.path.join(args.output, "fitted.npz"),
        curves=np.asarray(params["curves"])[:B_real],
        translate=np.asarray(params["translate"])[:B_real],
        log_gain=np.asarray(params["log_gain"]),
        curve_mask=batch.curve_mask,
        # The FITTED codepoints (make_fit_batch may skip unfittable
        # entries of the request, so rows map to these, not to `cps`).
        codepoints=np.asarray(batch.codepoints),
    )
    FontFitter.save_checkpoint(
        os.path.join(args.output, "checkpoint.npz"), params, opt_state
    )
    with open(os.path.join(args.output, "history.json"), "w") as f:
        json.dump([{"step": s, "loss": l} for s, l in history], f, indent=2)
    print(f"Wrote fitted parameters to {args.output!r}", file=sys.stderr)

    if args.render:
        # Close the loop into the product: the fitted outlines go back
        # through the production render + PBF path into blocks `debug`
        # (and any maplibre stack) can consume.
        from .font.names import name_to_id
        from .models.render_fitted import render_fitted_pbfs

        host_params = {k: np.asarray(v) for k, v in params.items()}
        glyph_dir = os.path.join(args.output, "glyphs")
        written = render_fitted_pbfs(
            host_params,
            batch,
            entry,
            args.depth,
            glyph_dir,
            name_to_id(entry.metadata.generate_name()),
            renderer=Renderer(args.render_backend),
        )
        print(
            f"Rendered {len(written)} fitted glyph block(s) to "
            f"{glyph_dir!r}",
            file=sys.stderr,
        )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="versatiles_glyphs_tpu",
        description="SDF glyph atlas generator on JAX "
        "(maplibre/mapbox PBF glyphs from TrueType/OpenType fonts)",
    )
    # The reference binary exposes clap's auto `--version`
    # (`/root/reference/src/main.rs:19`).
    from . import __version__

    parser.add_argument(
        "--version", action="version", version=f"%(prog)s {__version__}"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("recurse", help="recursively scan directories for fonts")
    p.add_argument("input_directories", nargs="+")
    _add_output_flags(p)
    p.set_defaults(func=cmd_recurse)

    p = sub.add_parser("merge", help="merge font files into one glyph set")
    p.add_argument("input_files", nargs="+")
    _add_output_flags(p)
    p.set_defaults(func=cmd_merge)

    p = sub.add_parser("debug", help="print glyph metrics of a rendered directory")
    p.add_argument("glyph_directory")
    p.add_argument("--format", "-f", choices=("csv", "tsv"), default="csv")
    p.set_defaults(func=cmd_debug)

    p = sub.add_parser(
        "fit", help="fit outlines to target SDFs by gradient descent"
    )
    p.add_argument("font", help="font whose outlines are optimized")
    p.add_argument("--target-font", default=None,
                   help="font providing target SDF bitmaps (default: self)")
    p.add_argument("--codepoints", default="65-90",
                   help="e.g. '65-90,97,0x100-0x17F'")
    p.add_argument("-o", "--output", default="fit_output")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--depth", type=int, default=3,
                   help="fixed Bezier subdivision depth")
    p.add_argument("--sharpness", type=float, default=None,
                   help="softmin sharpness (default: hard min; jnp backend only)")
    p.add_argument("--backend", choices=("jnp", "pallas"), default="jnp",
                   help="gradient backend: XLA autodiff of the pair-tensor "
                   "model, or the flat tile field with an argmin-recompute "
                   "backward (hard-min only)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the batch over this many devices")
    p.add_argument("--render", action="store_true",
                   help="after fitting, render the fitted outlines "
                   "through the production pipeline into "
                   "{output}/glyphs/*.pbf (readable by `debug`)")
    p.add_argument("--resume", default=None, metavar="CHECKPOINT",
                   help="resume optimization from a previous run's "
                   "{output}/checkpoint.npz")
    p.add_argument("--render-backend",
                   choices=("auto", "device", "jax", "exact", "zeros"),
                   default="auto", help=argparse.SUPPRESS)
    p.set_defaults(func=cmd_fit)

    return parser


def main(argv=None, stdout=None) -> None:
    args = build_parser().parse_args(argv)
    from .utils.device import enable_compilation_cache

    enable_compilation_cache()
    own_stdout = stdout is None
    if own_stdout:
        stdout = sys.stdout.buffer if args.command in ("recurse", "merge") else sys.stdout
    try:
        args.func(args, stdout)
    except BrokenPipeError:
        # Downstream pipe closed early (e.g. `debug ... | head`): exit
        # quietly like a well-behaved unix tool.
        if not own_stdout:
            raise
        try:
            sys.stdout.close()
        except BrokenPipeError:
            pass
        os._exit(0)
    except (ValueError, OSError) as e:
        # Clean one-line errors for expected failure modes — bad font
        # bytes, unreadable files, overlong tar entry names — matching
        # the reference's anyhow-to-stderr behavior (`main.rs:37-45`).
        if not own_stdout:
            raise
        raise SystemExit(f"error: {e}")


if __name__ == "__main__":
    main()
