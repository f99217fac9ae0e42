"""Device meshes and shardings for the glyph pipeline.

The reference's single parallelism axis is rayon data-parallelism over
the flat (font, block) task list (`/root/reference/src/font/manager.rs:
102-121`). The device equivalent: glyph batches sharded over a 1-D
``Mesh(('data',))`` with `NamedSharding`; XLA inserts the collectives.
The mesh follows the algorithm alone (every device of the host reaches
every other). Within a device, the kernel grid over tile-table rows is
the fine-grained axis (the reference has no counterpart — its unit of
work is a whole block on one core).

Multi-host: one process per host via `jax.distributed.initialize`
(standard JAX multi-controller); each host packs and writes only its
own shard's PBFs — the writer-Mutex pattern without any cross-host
traffic. Only fitting gradients cross devices (`models/fitting.py`),
through the `psum` XLA emits for replicated parameters.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    """1-D data mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis,))


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (glyph batch) axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad the batch axis so it divides the mesh size (padding rows are
    zeros — glyph metas with w·h = 0 are skipped by the kernels)."""
    n = arr.shape[axis]
    rem = n % multiple
    if rem == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, multiple - rem)
    return np.pad(arr, widths)


def data_mesh(min_devices: int = 2) -> Mesh | None:
    """The production render mesh: every device of the effective default
    platform, or None when there's nothing to shard over (single
    device). This is what `render.driver.Renderer` consults — the
    device stand-in for the reference's rayon pool size
    (`/root/reference/src/font/manager.rs:117-121`)."""
    from ..utils.device import default_platform

    devices = jax.devices(default_platform())
    if len(devices) < min_devices:
        return None
    return make_mesh(devices)


def sharded_pts_render_fn(mesh: Mesh, TP: int, L_max: int, impl: str):
    """Compiled D-way data-parallel render over the point-chain layout.

    Returns ``fn(pts_st [D,2,N], words_st [D,Nw], tm_st [D,T,8]) ->
    [D, T, TP] uint8`` where every leading axis is sharded over the
    mesh's single axis: each device renders its own glyph group with
    the tile field ``impl`` (`utils.device.tile_impl`) — the
    reference's rayon fan-out over the flat block task list
    (`manager.rs:102-121`) mapped onto devices. No collectives: block
    rendering is embarrassingly parallel; results land sharded and the
    host fetches each shard.
    """
    return _sharded_pts_render_fn(
        mesh, TP, L_max if impl == "reference" else 0, impl
    )


@functools.lru_cache(maxsize=None)
def _sharded_pts_render_fn(mesh: Mesh, TP: int, L_max: int, impl: str):
    from ..ops.tiles import render_pts

    spec = P(mesh.axis_names[0])

    def local(pts, words, tm):
        return render_pts(pts[0], words[0], tm[0], TP, L_max, impl)[None]

    # check_vma=False: pallas_call outputs carry no vma annotation, and
    # the body is per-shard-pure (no collectives).
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_delta_render_fn(
    mesh: Mesh, TP: int, L_max: int, T_pad: int, impl: str
):
    """Compiled D-way data-parallel render over the i8-delta wire
    format (`render.batch.pack_points_delta` per shard, stacked on a
    sharded leading axis): each device decodes its own shard and
    renders it through `ops.tiles.render_delta`, the single-device
    entry point, so the two paths cannot diverge. Returns
    ``fn(deltas [D,2,N] i8, words [D,Nw] i32, anchors [D,3,K] i32,
    meta [D,G,8] i32) -> [D, T_pad, TP] uint8``."""
    return _sharded_delta_render_fn(
        mesh, TP, L_max if impl == "reference" else 0, T_pad, impl
    )


@functools.lru_cache(maxsize=None)
def _sharded_delta_render_fn(
    mesh: Mesh, TP: int, L_max: int, T_pad: int, impl: str
):
    from ..ops.tiles import render_delta

    spec = P(mesh.axis_names[0])

    def local(deltas, words, anchors, meta):
        return render_delta(
            deltas[0], words[0], anchors[0], meta[0], TP, T_pad, L_max, impl
        )[None]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    return jax.jit(fn)


def initialize_multihost(coordinator: str | None = None, **kw) -> None:
    """Join the multi-controller runtime (no-op when no coordinator is
    given — the single-process case).

    On a multi-host cluster each host calls this BEFORE any other
    JAX use (`jax.distributed.initialize` must precede backend init);
    `jax.devices()` then spans the cluster and `make_mesh` shards over
    every device. See the module docstring for the host-local I/O rule:
    after initialization, `FontManager.render_glyphs` partitions the
    block task list by `jax.process_index()` (`partition_tasks`) so
    every host renders and writes a disjoint file set, and only process
    0 writes the two index JSONs.
    """
    if coordinator is None:
        return
    jax.distributed.initialize(coordinator_address=coordinator, **kw)


def partition_tasks(tasks, process_index: int, process_count: int, weights=None):
    """Deterministic per-host partition of the global (font, block) task
    list — the multi-host layer above the per-host device mesh.

    Greedy LPT: tasks sorted by descending ``weights`` (default: glyph
    count) are assigned to the currently lightest host, so host loads
    stay balanced without any cross-host communication (every host
    computes the same partition independently; the reference's rayon
    pool has no multi-process analogue, SURVEY §2.7). With real work
    weights (pixel tiles — `FontManager._host_partition` supplies them)
    the Noto Regular set balances to ≥0.95 mean/max for 2-4 hosts
    (tests/test_balance.py), supporting BASELINE.md's ≥85% scaling
    target. Returns the sub-list for ``process_index``, preserving the
    original relative order. Partitions are disjoint and their union is
    exactly ``tasks``.
    """
    if process_count <= 1:
        return list(tasks)
    if weights is None:
        weights = [len(b) for _, b in tasks]
    order = sorted(range(len(tasks)), key=lambda i: (-weights[i], i))
    loads = [0.0] * process_count
    owner = [0] * len(tasks)
    for i in order:
        h = loads.index(min(loads))
        owner[i] = h
        loads[h] += max(float(weights[i]), 1e-9)
    return [t for i, t in enumerate(tasks) if owner[i] == process_index]
