"""Shard-balance evidence (BASELINE.md: ≥85% scaling efficiency).

Real multi-chip hardware is unavailable in this environment, so the
achievable scaling is bounded by how evenly the static partitions
spread work. These tests measure that balance on the real Noto Sans
Regular multi-font workload — the same inputs as the reference's
timing harness (`/root/reference/scripts/test_merge.sh`) — and assert
max/mean load ≥ 0.9 for both partition layers:

- the single-host device rounds (`Renderer._lpt_rounds`, greedy LPT
  by tile count), and
- the multi-host block partition (`parallel.mesh.partition_tasks`).
"""

import glob
import os

import numpy as np
import pytest

import conftest as C
from versatiles_glyphs_tpu.font.entry import FontFileEntry
from versatiles_glyphs_tpu.render.driver import Renderer

TP = 256


def _tiles(p):
    return max(1, -(-(p.width * p.height) // TP))


@pytest.fixture(scope="module")
def noto_items():
    paths = sorted(
        p for p in glob.glob(os.path.join(C.NOTO_DIR, "*.ttf"))
        if "Regular" in p
    )[:8]
    assert len(paths) >= 4, "expected several Noto Regular files"
    r = Renderer("zeros")
    items = []
    entries = []
    for path in paths:
        with open(path, "rb") as f:
            en = FontFileEntry(f.read())
        entries.append(en)
        for cp in en.metadata.codepoints:
            p = r.prep_glyph(en, cp)
            if p is not None and not p.empty:
                items.append((len(items), p))
    return items, entries


def test_lpt_device_rounds_balance(noto_items):
    """Greedy LPT bins must be ≥90% balanced (mean/max load) in tiles
    AND lanes, on every device round, for 2..8 devices."""
    items, _ = noto_items
    r = Renderer("zeros")
    for D in (2, 4, 8):
        rounds = r._lpt_rounds(items, D, TP)
        for bins in rounds:
            tloads = [sum(_tiles(p) for _, p in b) for b in bins]
            lloads = [sum(p.npts for _, p in b) for b in bins]
            assert max(tloads) > 0
            t_ratio = float(np.mean(tloads)) / max(tloads)
            l_ratio = float(np.mean(lloads)) / max(max(lloads), 1)
            assert t_ratio >= 0.9, (D, tloads)
            assert l_ratio >= 0.85, (D, lloads)


def test_multihost_partition_balance(noto_items):
    """The per-host block partition must spread pixel work within 90%
    of perfectly even across 2..4 hosts (blocks are coarse units, so
    the bound is checked on real multi-font task lists)."""
    from versatiles_glyphs_tpu.font.manager import FontManager
    from versatiles_glyphs_tpu.parallel.mesh import partition_tasks

    _, entries = noto_items
    m = FontManager()
    from versatiles_glyphs_tpu.font.names import name_to_id
    from versatiles_glyphs_tpu.font.wrapper import FontWrapper

    for en in entries:
        fid = name_to_id(en.metadata.generate_name())
        w = m.fonts.get(fid)
        if w is None:
            w = m.fonts[fid] = FontWrapper()
        w.add_file(en)
    tasks = m.collect_tasks()
    r = Renderer("zeros")

    def task_tiles(block):
        n = 0
        for cp, en in block.glyph_sources():
            p = r.prep_glyph(en, cp)
            if p is not None and not p.empty:
                n += _tiles(p)
        return n

    weights = [task_tiles(block) for _, block in tasks]
    by_id = {id(b): w for (_, b), w in zip(tasks, weights)}
    for P in (2, 4):
        loads = []
        seen = 0
        for pi in range(P):
            part = partition_tasks(tasks, pi, P, weights)
            seen += len(part)
            loads.append(sum(by_id[id(b)] for _, b in part))
        assert seen == len(tasks)
        ratio = float(np.mean(loads)) / max(loads)
        assert ratio >= 0.9, (P, loads)


class _FakePrep:
    """LPT only reads width/height/npts; synthetic preps let the test
    force multi-round packing without building 30k real glyphs."""

    __slots__ = ("width", "height", "npts")

    def __init__(self, w, h, n):
        self.width, self.height, self.npts = w, h, n


def test_lpt_multiround_balance_realistic_mix():
    """k>1 rounds (the case that threatens the ≥85% scaling target on
    big workloads): a workload above the group lane caps, with tile/lane distributions shaped like the measured full
    Noto set (tiles p50=2, p99=5, max=11; lanes lognormal, mean ~500),
    must stay ≥90% tile-balanced on EVERY round including the tail."""
    rng = np.random.default_rng(7)
    items = []
    for i in range(30_000):
        t = min(11, max(1, int(rng.lognormal(0.7, 0.55))))
        w = int(np.sqrt(t * TP)) + 1
        h = -(-(t * TP - TP // 2) // w)
        npts = max(16, int(rng.lognormal(6.0, 0.9)))
        items.append((i, _FakePrep(w, h, npts)))

    r = Renderer("zeros")
    total_lanes = sum(p.npts for _, p in items)
    assert total_lanes > 8 * r._LANES_MAX  # k>1 even at D=8

    for D in (2, 4, 8):
        rounds = r._lpt_rounds(items, D, TP)
        assert len(rounds) > 1, D  # the cap really forced multi-round
        # Every item lands exactly once.
        seen = sorted(i for bins in rounds for b in bins for i, _ in b)
        assert seen == list(range(len(items)))
        for bins in rounds:
            tl = [sum(_tiles(p) for _, p in b) for b in bins]
            ll = [sum(p.npts for _, p in b) for b in bins]
            assert max(ll) <= r._LANES_MAX and max(tl) <= r._TILES_MAX
            assert float(np.mean(tl)) / max(tl) >= 0.9, (D, tl)
            assert float(np.mean(ll)) / max(max(ll), 1) >= 0.85, (D, ll)
