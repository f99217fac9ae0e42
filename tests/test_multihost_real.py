"""REAL two-process `jax.distributed` integration.

Two subprocesses join a localhost coordinator via
`initialize_multihost` (actual `jax.distributed.initialize`, not a
monkeypatched simulation), each runs a full `FontManager.render_glyphs`
over the same fonts, and each writes only its own disjoint partition of
PBF files — the host-local I/O rule (SURVEY §2.7 / `parallel/mesh.py`).
Process 0 alone writes the index JSONs. The union of the two hosts'
outputs must equal a single-process run byte for byte.
"""

import os
import socket
import subprocess
import sys

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)
pid, nproc, coord, outdir, font_path = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
)
from versatiles_glyphs_tpu.parallel.mesh import initialize_multihost
initialize_multihost(coord, num_processes=nproc, process_id=pid)
import jax
assert jax.process_count() == nproc, jax.process_count()
assert jax.process_index() == pid
from versatiles_glyphs_tpu.font.manager import FontManager
from versatiles_glyphs_tpu.render.driver import Renderer
from versatiles_glyphs_tpu.writer import Writer
mgr = FontManager()
mgr.add_path(font_path)
w = Writer.new_file(outdir)
mgr.render_glyphs(w, Renderer("zeros"))
mgr.write_index_json(w)
mgr.write_families_json(w)
w.finish()
jax.distributed.shutdown()
print("WORKER_OK", pid)
"""


def test_two_process_distributed_recurse(tmp_path):
    from versatiles_glyphs_tpu.utils.synth_font import build_ttf

    font_path = tmp_path / "multi.ttf"
    # 3 glyph blocks (cps 64..583) so both hosts get real work.
    font_path.write_bytes(build_ttf(n_glyphs=520, first_cp=64, family="Multi Sans"))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    outs = [tmp_path / f"proc{p}" for p in range(2)]
    # Both workers stay on the CPU: two processes must never both
    # open one accelerator card.
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for p in range(2):
        outs[p].mkdir()
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(p), "2", coord,
                 str(outs[p]), str(font_path)],
                env=env,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    results = []
    for p, proc in enumerate(procs):
        try:
            out, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        results.append((proc.returncode, out, err))
    for p, (rc, out, err) in enumerate(results):
        assert rc == 0, f"process {p} failed:\n{err[-2000:]}"
        assert f"WORKER_OK {p}" in out

    def tree(root):
        found = {}
        for dirpath, _, files in os.walk(root):
            for f in files:
                full = os.path.join(dirpath, f)
                rel = os.path.relpath(full, root)
                with open(full, "rb") as fh:
                    found[rel] = fh.read()
        return found

    t0, t1 = tree(outs[0]), tree(outs[1])
    pbf0 = {k for k in t0 if k.endswith(".pbf")}
    pbf1 = {k for k in t1 if k.endswith(".pbf")}
    # Disjoint partitions, both non-empty.
    assert pbf0 and pbf1
    assert not (pbf0 & pbf1)
    # Index files only from process 0.
    assert "index.json" in t0 and "font_families.json" in t0
    assert "index.json" not in t1 and "font_families.json" not in t1

    # Union == single-process run, byte for byte.
    from versatiles_glyphs_tpu.font.manager import FontManager
    from versatiles_glyphs_tpu.render.driver import Renderer
    from versatiles_glyphs_tpu.writer import Writer

    single = tmp_path / "single"
    single.mkdir()
    mgr = FontManager()
    mgr.add_path(str(font_path))
    w = Writer.new_file(str(single))
    mgr.render_glyphs(w, Renderer("zeros"))
    mgr.write_index_json(w)
    mgr.write_families_json(w)
    w.finish()
    ts = tree(single)

    union = dict(t1)
    union.update(t0)
    assert union == ts
