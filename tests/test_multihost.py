"""Multi-host partitioning: the per-process block
assignment is deterministic, disjoint, covering, and balanced; a
simulated multi-host run writes disjoint per-host file sets whose union
equals the single-host output, with the index JSONs written once."""

import pytest

from versatiles_glyphs_tpu.font.manager import FontManager
from versatiles_glyphs_tpu.parallel.mesh import partition_tasks
from versatiles_glyphs_tpu.render.driver import Renderer
from versatiles_glyphs_tpu.utils.synth_font import build_ttf
from versatiles_glyphs_tpu.writer import Writer


class _FakeBlock:
    def __init__(self, n):
        self._n = n

    def __len__(self):
        return self._n


def test_partition_disjoint_covering_balanced():
    tasks = [("f", _FakeBlock(n)) for n in (1, 9, 3, 256, 17, 4, 88, 120, 2, 31)]
    P = 3
    parts = [partition_tasks(tasks, p, P) for p in range(P)]
    seen = [t for part in parts for t in part]
    assert len(seen) == len(tasks)
    assert {id(t) for t in seen} == {id(t) for t in tasks}
    loads = [sum(len(b) for _, b in part) for part in parts]
    # Round-robin over size-sorted tasks: max/min spread stays well
    # under the largest single task.
    assert max(loads) - min(loads) <= 256
    # Deterministic: identical on recomputation (every host agrees).
    assert [id(t) for t in partition_tasks(tasks, 1, P)] == [
        id(t) for t in parts[1]
    ]


def test_partition_single_process_identity():
    tasks = [("f", _FakeBlock(5)), ("g", _FakeBlock(6))]
    assert partition_tasks(tasks, 0, 1) == tasks


def test_partition_more_hosts_than_tasks():
    tasks = [("f", _FakeBlock(5))]
    parts = [partition_tasks(tasks, p, 4) for p in range(4)]
    assert sum(len(p) for p in parts) == 1


def _render_files(monkeypatch, tmp_path, process_index, process_count, data):
    import os

    import jax

    monkeypatch.setattr(jax, "process_count", lambda: process_count)
    monkeypatch.setattr(jax, "process_index", lambda: process_index)
    mgr = FontManager()
    for i, d in enumerate(data):
        mgr.add_font_with_name(f"synth {i}", [d])
    root = tmp_path / f"host{process_index}of{process_count}"
    root.mkdir()
    w = Writer.new_file(str(root))
    r = Renderer("zeros")
    mgr.render_glyphs(w, r)
    mgr.write_index_json(w)
    mgr.write_families_json(w)
    w.finish()
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module")
def font_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_fonts")
    paths = []
    for i, (n, cp0) in enumerate([(40, 65), (300, 0x400), (7, 0x2000)]):
        p = d / f"s{i}.ttf"
        p.write_bytes(build_ttf(n, cp0, family=f"Synth {i}"))
        paths.append(str(p))
    return paths


def test_simulated_hosts_write_disjoint_union(monkeypatch, tmp_path, font_paths):
    single = _render_files(monkeypatch, tmp_path, 0, 1, font_paths)
    P = 4
    per_host = [
        _render_files(monkeypatch, tmp_path, p, P, font_paths) for p in range(P)
    ]

    pbf = lambda files: {k for k in files if k.endswith(".pbf")}
    # Disjoint PBF sets...
    for a in range(P):
        for b in range(a + 1, P):
            assert not (pbf(per_host[a]) & pbf(per_host[b]))
    # ...whose union is the single-host set, with identical bytes.
    union = {}
    for files in per_host:
        union.update({k: v for k, v in files.items() if k.endswith(".pbf")})
    assert set(union) == pbf(single)
    for k, v in union.items():
        assert v == single[k]

    # Index JSONs: only host 0, identical to single-host.
    assert "index.json" in per_host[0]
    assert per_host[0]["index.json"] == single["index.json"]
    assert per_host[0]["font_families.json"] == single["font_families.json"]
    for p in range(1, P):
        assert "index.json" not in per_host[p]
        assert "font_families.json" not in per_host[p]


def test_initialize_multihost_noop_without_coordinator():
    from versatiles_glyphs_tpu.parallel.mesh import initialize_multihost

    # Must not touch jax.distributed when no coordinator is configured.
    initialize_multihost(None)
