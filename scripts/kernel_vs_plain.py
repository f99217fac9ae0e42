#!/usr/bin/env python3
"""End-to-end time of the tile kernel against the plain version XLA
compiles, on one GPU, in one process:

    python scripts/kernel_vs_plain.py [--reps 3]

- `merge` of DejaVu Sans (CLI, `--renderer device`): wall time;
- a fit step (`FontFitter(backend="pallas")`, DejaVu Sans A–Z to DejaVu
  Serif, depth 3, 10 chained steps per dispatch): wall time per step.

Each is timed warm with the tile field set to the kernel and to the
plain reference (`ops.sdf_jax`, with the best `lax.map` batch size of
the kernel-vs-plain phase of chip_smoke.py), in turns kernel, plain,
plain, kernel, and reported as medians with the card's name and power
limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

RENDER_BATCH, RESID_BATCH = 128, 32


def use(impl: str) -> None:
    """Route the GPU's tile field to ``impl`` ("kernel" or "plain")."""
    import jax

    from versatiles_glyphs_tpu.ops import sdf_jax, tiles
    from versatiles_glyphs_tpu.utils import device

    if impl == "kernel":
        device.tile_impl = _TILE_IMPL
        tiles.render_bitmaps_pts_jax = _RENDER
        tiles.min_field_pts_jax = _RESID
    else:
        device.tile_impl = lambda p: "reference" if p in ("gpu", "cpu") else _TILE_IMPL(p)
        tiles.render_bitmaps_pts_jax = functools.partial(
            sdf_jax.render_bitmaps_pts_jax, batch_size=RENDER_BATCH
        )
        tiles.min_field_pts_jax = functools.partial(
            sdf_jax.min_field_pts_jax, batch_size=RESID_BATCH
        )
    jax.clear_caches()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        print("kernel_vs_plain: no GPU", file=sys.stderr)
        return 1
    global _TILE_IMPL, _RENDER, _RESID
    from versatiles_glyphs_tpu.cli import main as cli
    from versatiles_glyphs_tpu.ops import tiles
    from versatiles_glyphs_tpu.utils import device

    _TILE_IMPL = device.tile_impl
    _RENDER, _RESID = tiles.render_bitmaps_pts_jax, tiles.min_field_pts_jax

    import chip_smoke
    from versatiles_glyphs_tpu.models.fitting import FontFitter

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    _, batch = chip_smoke.fit_batch()
    times: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl in ("kernel", "plain", "plain", "kernel"):
            use(impl)
            out = os.path.join(tmp, impl)
            cli(["merge", chip_smoke.SANS, "-o", out, "--renderer", "device"])  # warm-up
            for _ in range(args.reps):
                t0 = time.perf_counter()
                cli(["merge", chip_smoke.SANS, "-o", out, "--renderer", "device"])
                times.setdefault(("merge", impl), []).append(time.perf_counter() - t0)
            fitter = FontFitter(depth=3, learning_rate=chip_smoke.FIT_LR, backend="pallas")
            p, o, d = fitter.init(batch)
            p, o, losses = fitter.step_many(p, o, d, 10)
            np.asarray(losses)
            for _ in range(args.reps):
                t0 = time.perf_counter()
                p, o, losses = fitter.step_many(p, o, d, 10)
                np.asarray(losses)
                times.setdefault(("fit step", impl), []).append(
                    (time.perf_counter() - t0) / 10
                )
    for what in ("merge", "fit step"):
        k = float(np.median(times[(what, "kernel")]))
        p_ = float(np.median(times[(what, "plain")]))
        print(f"{what}: kernel {k * 1e3:.3f} ms, plain XLA {p_ * 1e3:.3f} ms "
              f"(median of {len(times[(what, 'kernel')])} each; "
              f"kernel/plain {k / p_:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
