"""Font fitting: gradient descent on outline control points.

North-star config 5: match target SDF bitmaps (e.g. rendered from a
reference font by the parity pipeline) by optimizing Bezier control
points and per-glyph placement, batched over glyphs and sharded over a
device mesh. Parameters:

- ``curves``    [B, C, 4, 2] — per-glyph cubic control points (sharded
                 over the 'data' mesh axis with the batch)
- ``translate`` [B, 2]      — per-glyph placement (sharded)
- ``log_gain``  []          — a shared global scale (replicated; its
                 gradient forces the cross-device all-reduce that the
                 north star wants overlapped with the backward pass —
                 XLA emits the psum from the sharding alone)

Optimization state is optax Adam; checkpoint/resume via a numpy
``.npz`` of the state's leaves (the reference has no checkpointing — a
render run is restartable — but a fitting run is long-lived training
and gets the standard treatment).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .glyph_model import glyph_field, sdf_loss


@dataclass
class FitBatch:
    """Device-ready fitting workload (see `make_fit_batch`)."""

    curves0: np.ndarray  # [B, C, 4, 2] initial control points
    curve_mask: np.ndarray  # [B, C] bool
    px: np.ndarray  # [B, P] pixel-center x
    py: np.ndarray  # [B, P] pixel-center y
    pix_mask: np.ndarray  # [B, P] f32 (1 = real pixel)
    target: np.ndarray  # [B, P] target signed distances
    meta: np.ndarray | None = None  # [B, 4] i32 (x0, y0, w, h) per glyph
    # (the kernel backend derives pixel coords from meta instead of px/py)
    codepoints: np.ndarray | None = None  # [B] i32 — the FITTED cps
    # (make_fit_batch skips unfittable codepoints, so the caller's
    # request list may be longer than the batch; rows map to these)


def init_params(curves0: np.ndarray) -> dict:
    return {
        "curves": jnp.asarray(curves0, jnp.float32),
        "translate": jnp.zeros((curves0.shape[0], 2), jnp.float32),
        "log_gain": jnp.zeros((), jnp.float32),
    }


def batch_loss(params, batch: dict, depth: int, sharpness):
    def one(curves, cmask, tr, px, py, pmask, target):
        field = glyph_field(
            curves, cmask, tr, px, py, depth=depth, sharpness=sharpness
        )
        return sdf_loss(field * jnp.exp(params["log_gain"]), target, pmask)

    losses = jax.vmap(one)(
        params["curves"],
        batch["curve_mask"],
        params["translate"],
        batch["px"],
        batch["py"],
        batch["pix_mask"],
        batch["target"],
    )
    return jnp.mean(losses)


@dataclass
class FlatKernelPlan:
    """Static launch plan for the FLAT kernel fitting path (see
    `build_flat_plan`): the point-chain/tile-table layout of the
    production render kernel, applied to the differentiable pair —
    no per-glyph [B, Sp] padding, so fwd+bwd does Σ_g s_g·p_g work
    instead of B·S_max·P_max."""

    K: int  # chain points per curve (2^depth + 1)
    N: int  # flat lane count (mult of SC; includes reference slack)
    T: int  # real tiles
    TP: int
    L_max: int  # reference window (bucketized max npts)
    tmeta: np.ndarray  # [T_pad, 8] i32 row-major tile table
    mask_words: np.ndarray  # [N//32] i32 validity bits
    row_map: np.ndarray  # [B, P_pad//TP] i32 field-row gather map
    chunk_map: np.ndarray  # [N//128] i32: lane chunk → source 128-block
    inv_chunk: np.ndarray  # [B·nblk] i32: source block → lane chunk (−1)


def build_flat_plan(
    curve_mask: np.ndarray,
    metas: np.ndarray,
    depth: int,
    P_pad: int,
    TP: int = 256,
) -> FlatKernelPlan:
    """Host-side static plan for `make_flat_kernel_loss`.

    Glyph ``g``'s chain occupies lanes ``[offs_g, offs_g + npts_g)``
    with ``npts_g = ncurves_g·K`` (curve masks are prefix masks) and
    TIGHT SC-aligned offsets — per-glyph padding to the batch-max curve
    count would multiply the lane count ~6× on real fonts.
    ``chunk_map`` maps each 128-lane chunk to a 128-point block of the
    device-built chain tensor, so placement (and its transpose in
    reverse mode) is a gather of whole blocks. Each curve contributes
    its K subdivision points, the last point's validity bit cleared
    (chain break — exactly the production `pack_points` convention).
    Tiles per glyph = ceil(w·h / TP). ``row_map[g, t]`` maps
    loss-layout pixel tiles to field rows (out-of-range tiles point at
    the glyph's last real tile; those pixels are pix_masked).
    """
    from ..render.batch import S_BUCKETS, SC, bucket

    B, C_pad = curve_mask.shape
    K = (1 << depth) + 1
    ncurv = curve_mask.sum(axis=1).astype(np.int64)
    npts = ncurv * K
    runs = -(-np.maximum(npts, 1) // SC) * SC
    offs = np.concatenate([[0], np.cumsum(runs)[:-1]])
    wh = metas[:, 2].astype(np.int64) * metas[:, 3].astype(np.int64)
    ntiles = np.maximum(1, -(-wh // TP))
    tstart = np.concatenate([[0], np.cumsum(ntiles)[:-1]])
    T = int(ntiles.sum())

    tmeta = np.zeros((T, 8), np.int32)
    g_of = np.repeat(np.arange(B), ntiles)
    tmeta[:T, :4] = metas[g_of, :4]
    tmeta[:T, 4] = npts[g_of]
    tmeta[:T, 5] = offs[g_of]
    tmeta[:T, 6] = (np.arange(T) - tstart[g_of]) * TP

    L_max = bucket(int(npts.max(initial=1)), S_BUCKETS)
    N = int(runs.sum()) + -(-(L_max + 1) // SC) * SC

    valid = np.zeros(N, np.uint8)
    CK_pad = -(-(C_pad * K) // SC) * SC
    nblk = CK_pad // 128
    chunk_map = np.zeros(N // 128, np.int32)
    inv_chunk = np.full(B * nblk, -1, np.int32)
    # Within a glyph's run, lane offs_g + c·K + j (c < ncurv_g) is a
    # live segment start iff j < K-1.
    jpat = (np.arange(C_pad * K) % K) < (K - 1)
    for g in range(B):
        n = int(npts[g])
        valid[offs[g] : offs[g] + n] = jpat[:n]
        nb = int(runs[g]) // 128
        c0 = int(offs[g]) // 128
        chunk_map[c0 : c0 + nb] = g * nblk + np.arange(nb)
        inv_chunk[g * nblk : g * nblk + nb] = c0 + np.arange(nb)
    mask_words = (
        np.packbits(valid, bitorder="little").view("<u4").view(np.int32).copy()
    )

    assert P_pad % TP == 0, f"P_pad={P_pad} must be a multiple of TP={TP}"
    t = np.arange(P_pad // TP)[None, :]
    row_map = (
        tstart[:, None] + np.minimum(t, (ntiles - 1)[:, None])
    ).astype(np.int32)
    return FlatKernelPlan(
        K=K, N=N, T=T, TP=TP, L_max=L_max,
        tmeta=tmeta, mask_words=mask_words, row_map=row_map,
        chunk_map=chunk_map, inv_chunk=inv_chunk,
    )


@functools.lru_cache(maxsize=8)
def _bernstein_matrix(depth: int):
    """[K, 4] Bernstein evaluation matrix at the K = 2^depth + 1 dyadic
    parameters — rows at t=0/1 are exact unit vectors, so chain
    endpoints equal the control points bitwise (curve joins stay
    watertight)."""
    K = (1 << depth) + 1
    t = np.arange(K, dtype=np.float64) / (K - 1)
    M = np.stack(
        [(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t * t * (1 - t), t**3],
        axis=1,
    )
    # numpy, not jnp: a cached device constant created inside a trace
    # would leak a tracer out of the transformation.
    return M.astype(np.float32)


@jax.custom_vjp
def _place_chunks(blocks, chunk_map, inv_chunk):
    """Place (2, 128) chain blocks into the plan's lane-chunk layout:
    ``[B·nblk, 2, 128] → [M, 2, 128]`` via a static block gather. The
    map is a BIJECTION on live chunks (slack chunks duplicate block 0,
    but no cotangent ever lands on a slack lane — argmin gathers are
    masked to live segment ranges), so reverse mode is a block gather
    by the inverse map instead of the generic scatter-add XLA would
    emit for `take`."""
    return jnp.take(blocks, chunk_map, axis=0)


def _place_chunks_fwd(blocks, chunk_map, inv_chunk):
    return _place_chunks(blocks, chunk_map, inv_chunk), (inv_chunk,)


def _place_chunks_bwd(res, ct):
    (inv_chunk,) = res
    safe = jnp.clip(inv_chunk, 0, ct.shape[0] - 1)
    d = jnp.take(ct, safe, axis=0)
    d = jnp.where((inv_chunk >= 0)[:, None, None], d, 0.0)
    return d, None, None


_place_chunks.defvjp(_place_chunks_fwd, _place_chunks_bwd)


def flat_chain_points(curves, translate, depth: int, chunk_map, inv_chunk):
    """Device-side flat point chain from padded control points: per
    curve, the K = 2^depth + 1 points at dyadic parameters via ONE
    Bernstein matmul (one fused op instead of a pile of small
    midpoint-subdivision stack/reshape ops; the points differ only by
    f32 rounding), then one static gather into the plan's tight lane
    layout. Returns [2, N] f32; reverse mode is the gather's transpose."""
    B, C_pad = curves.shape[:2]
    K = (1 << depth) + 1
    c = curves + translate[:, None, None, :]
    # HIGHEST precision: a GPU's default f32 matmul runs in TF32, whose
    # ~3 decimal digits would round control points visibly in the
    # loss. The matmul is tiny; full f32 costs nothing.
    chain = jnp.einsum(
        "kj,bcjd->bckd",
        _bernstein_matrix(depth),
        c,
        precision=jax.lax.Precision.HIGHEST,
    )
    from ..render.batch import SC

    CK = C_pad * K
    CK_pad = -(-CK // SC) * SC
    chain = jnp.pad(chain.reshape(B, CK, 2), ((0, 0), (0, CK_pad - CK), (0, 0)))
    nblk = CK_pad // 128
    cb = chain.reshape(B, nblk, 128, 2).transpose(0, 1, 3, 2)
    fb = _place_chunks(cb.reshape(B * nblk, 2, 128), chunk_map, inv_chunk)
    return fb.transpose(1, 0, 2).reshape(2, -1)


def make_flat_kernel_loss(plan: FlatKernelPlan, depth: int, impl: str):
    """Loss over the flat tile field. The plan's arrays ride in the
    device batch (keys ``plan_tmeta``/``plan_words``/``row_map``); its
    static ints are closed over. Gradients: the tile field (``impl``,
    `utils.device.tile_impl`) is an argmin/winding oracle; the
    envelope-theorem recompute in `ops.sdf_grad.signed_field_flat`
    carries the autodiff (gather → O(P) pair math → scatter-add in
    reverse)."""
    from ..ops.sdf_grad import signed_field_flat

    TP, L_max = plan.TP, plan.L_max

    def loss_fn(params, batch):
        flat = flat_chain_points(
            params["curves"], params["translate"], depth,
            batch["chunk_map"], batch["inv_chunk"],
        )
        field = signed_field_flat(
            flat, batch["plan_words"], batch["plan_tmeta"], TP, L_max, impl
        )
        B = params["curves"].shape[0]
        fb = jnp.take(field, batch["row_map"].reshape(-1), axis=0)
        fb = fb.reshape(B, -1)
        losses = jax.vmap(sdf_loss)(
            fb * jnp.exp(params["log_gain"]), batch["target"], batch["pix_mask"]
        )
        return jnp.mean(losses)

    return loss_fn


def _unify_plans(plans: list) -> None:
    """Pad per-shard `FlatKernelPlan`s to common static shapes in place
    (one jitted local fn serves every shard): common L_max/N (mask
    words zero-padded — padding lanes are dead) and common tile-table
    length (extra rows are skip rows, w·h = 0)."""
    L = max(p.L_max for p in plans)
    N = max(p.N - -(-(p.L_max + 1) // 128) * 128 for p in plans)
    N += -(-(L + 1) // 128) * 128
    Tp = max(p.tmeta.shape[0] for p in plans)
    for p in plans:
        p.L_max, p.N = L, N
        words = np.zeros(N // 32, np.int32)
        words[: p.mask_words.shape[0]] = p.mask_words
        p.mask_words = words
        cmap = np.zeros(N // 128, np.int32)
        cmap[: p.chunk_map.shape[0]] = p.chunk_map
        p.chunk_map = cmap  # (inv_chunk needs no padding: source-sized)
        tm = np.zeros((Tp, 8), np.int32)
        tm[: p.tmeta.shape[0]] = p.tmeta
        p.tmeta = tm


def make_sharded_flat_loss(
    mesh, plans: list, depth: int, B_real: int, impl: str
):
    """Mesh-sharded twin of `make_flat_kernel_loss`: one per-shard plan
    each (identical static shapes), plan arrays stacked on a leading
    device axis and sharded with the batch; each shard runs the flat
    tile field on its local glyphs, and the scalar loss is the `psum`
    of per-shard sums over the REAL batch size. Reverse mode transposes
    that psum into the replicated-parameter all-reduce.
    Returns (loss_fn, stacked plan arrays dict)."""
    from jax.sharding import PartitionSpec as P

    from ..ops.sdf_grad import signed_field_flat

    p0 = plans[0]
    TP, L_max = p0.TP, p0.L_max
    axis = mesh.axis_names[0]
    sb = P(axis)

    plan_arrays = {
        "plan_tmeta": np.stack([p.tmeta for p in plans]),
        "plan_words": np.stack([p.mask_words for p in plans]),
        "row_map": np.stack([p.row_map for p in plans]),
        "chunk_map": np.stack([p.chunk_map for p in plans]),
        "inv_chunk": np.stack([p.inv_chunk for p in plans]),
    }

    def local(curves, translate, log_gain, tmeta, words, row_map, cidx,
              iidx, target, pmask):
        flat = flat_chain_points(curves, translate, depth, cidx[0], iidx[0])
        field = signed_field_flat(flat, words[0], tmeta[0], TP, L_max, impl)
        Bl = curves.shape[0]
        fb = jnp.take(field, row_map.reshape(-1), axis=0).reshape(Bl, -1)
        losses = jax.vmap(sdf_loss)(fb * jnp.exp(log_gain), target, pmask)
        return jax.lax.psum(jnp.sum(losses), axis) / B_real

    # check_vma=False: pallas_call outputs carry no vma annotation.
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(sb, sb, P(), sb, sb, sb, sb, sb, sb, sb),
        out_specs=P(),
        check_vma=False,
    )

    def loss_fn(params, batch):
        return fn(
            params["curves"],
            params["translate"],
            params["log_gain"],
            batch["plan_tmeta"],
            batch["plan_words"],
            batch["row_map"],
            batch["chunk_map"],
            batch["inv_chunk"],
            batch["target"],
            batch["pix_mask"],
        )

    return loss_fn, plan_arrays


class FontFitter:
    """Owns the optimizer and the jitted, mesh-sharded train step."""

    def __init__(
        self,
        mesh=None,
        depth: int = 3,
        learning_rate: float = 0.01,
        sharpness: float | None = None,
        backend: str = "jnp",
    ):
        """``backend='jnp'`` autodiffs the pair-tensor model;
        ``backend='pallas'`` runs the forward through the flat tile
        field (the Hopper kernel on a GPU, its plain reference on a
        CPU) and the backward through the argmin recompute
        (`ops.sdf_grad`) — hard-min only (no ``sharpness``), needs
        `FitBatch.meta`. With a mesh, the pallas backend shard_maps
        the field over the batch axis (`make_sharded_flat_loss`); the
        jnp backend leaves sharding to XLA's auto-spmd."""
        import optax

        if backend == "pallas" and sharpness is not None:
            raise ValueError("backend='pallas' supports hard-min only")
        self.mesh = mesh
        self.depth = depth
        self.sharpness = sharpness
        self.backend = backend
        self.opt = optax.adam(learning_rate)
        self._kernel_loss = None  # built by init() (needs the flat plan)

        def _one(params, opt_state, batch):
            if backend == "pallas":
                loss, grads = jax.value_and_grad(self._kernel_loss)(
                    params, batch
                )
            else:
                loss, grads = jax.value_and_grad(batch_loss)(
                    params, batch, self.depth, self.sharpness
                )
            updates, opt_state = self.opt.update(grads, opt_state, params)
            import optax as _optax

            params = _optax.apply_updates(params, updates)
            return params, opt_state, loss

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def _step(params, opt_state, batch):
            return _one(params, opt_state, batch)

        @functools.partial(
            jax.jit, static_argnames=("k",), donate_argnums=(0, 1)
        )
        def _step_k(params, opt_state, batch, k: int):
            # K optimizer steps chained in ONE dispatch (lax.scan), so
            # small fits do not pay a host round trip per step. Loss
            # per step comes back as the scan's stacked ys — one fetch
            # per chunk.
            def body(carry, _):
                p, o = carry
                p, o, loss = _one(p, o, batch)
                return (p, o), loss

            (params, opt_state), losses = jax.lax.scan(
                body, (params, opt_state), None, length=k
            )
            return params, opt_state, losses

        self._step = _step
        self._step_k = _step_k

    # -- state ----------------------------------------------------------

    def init(self, batch: FitBatch):
        """Initial (params, opt_state, device batch). With a mesh, the
        batch axis of every array is sharded over 'data' and the scalar
        gain is replicated — XLA derives the psum for its gradient."""
        from ..utils.device import default_platform, tile_impl

        if self.backend == "pallas" and batch.meta is None:
            raise ValueError("backend='pallas' needs FitBatch.meta")
        plan_arrays = {}
        if self.backend == "pallas" and self.mesh is not None:
            # shard_map needs the batch axis divisible by the mesh;
            # padded glyphs (all-false masks, w=h=0 metas) contribute
            # exactly zero loss and gradient, and the sharded loss
            # normalizes by the REAL batch size.
            import dataclasses

            from ..parallel.mesh import pad_to_multiple

            B_real = batch.curves0.shape[0]
            D = self.mesh.devices.size
            batch = dataclasses.replace(
                batch,
                **{
                    f.name: pad_to_multiple(getattr(batch, f.name), D)
                    for f in dataclasses.fields(batch)
                    if getattr(batch, f.name) is not None
                },
            )
            B = batch.curves0.shape[0]
            Bl = B // D
            P_pad = batch.target.shape[1]
            plans = [
                build_flat_plan(
                    batch.curve_mask[d * Bl : (d + 1) * Bl],
                    batch.meta[d * Bl : (d + 1) * Bl],
                    self.depth,
                    P_pad,
                )
                for d in range(D)
            ]
            _unify_plans(plans)
            # The field follows the MESH's device platform, not the
            # process default: a dry run builds a virtual-CPU mesh on a
            # GPU host.
            impl = tile_impl(self.mesh.devices.flat[0].platform)
            self._kernel_loss, plan_arrays = make_sharded_flat_loss(
                self.mesh, plans, self.depth, B_real, impl
            )
        elif self.backend == "pallas":
            plan = build_flat_plan(
                batch.curve_mask, batch.meta, self.depth,
                batch.target.shape[1],
            )
            self._kernel_loss = make_flat_kernel_loss(
                plan, self.depth, tile_impl(default_platform())
            )
            plan_arrays = {
                "plan_tmeta": plan.tmeta,
                "plan_words": plan.mask_words,
                "row_map": plan.row_map,
                "chunk_map": plan.chunk_map,
                "inv_chunk": plan.inv_chunk,
            }
        params = init_params(batch.curves0)
        dev_batch = {
            "curve_mask": jnp.asarray(batch.curve_mask),
            "px": jnp.asarray(batch.px, jnp.float32),
            "py": jnp.asarray(batch.py, jnp.float32),
            "pix_mask": jnp.asarray(batch.pix_mask, jnp.float32),
            "target": jnp.asarray(batch.target, jnp.float32),
        }
        if self.backend == "pallas":
            dev_batch["meta"] = jnp.asarray(batch.meta, jnp.int32)
            for k, v in plan_arrays.items():
                dev_batch[k] = jnp.asarray(v)
        if self.mesh is not None:
            from ..parallel.mesh import batch_sharding, replicated

            bs = batch_sharding(self.mesh)
            rep = replicated(self.mesh)
            params = {
                k: jax.device_put(v, rep if v.ndim == 0 else bs)
                for k, v in params.items()
            }
            dev_batch = {k: jax.device_put(v, bs) for k, v in dev_batch.items()}
        opt_state = self.opt.init(params)
        return params, opt_state, dev_batch

    def step(self, params, opt_state, dev_batch):
        return self._step(params, opt_state, dev_batch)

    def step_many(self, params, opt_state, dev_batch, k: int):
        """Run ``k`` optimizer steps in one device dispatch; returns
        (params, opt_state, losses[k]). This is how real fits should
        step — see `_step_k` for why."""
        return self._step_k(params, opt_state, dev_batch, k=k)

    # Default dispatch chunk: long enough to amortize the per-dispatch
    # host round trip, short enough that loss logging stays responsive.
    CHUNK = 10

    def fit(self, batch: FitBatch, steps: int = 200, log_every: int = 0):
        params, opt_state, dev_batch = self.init(batch)
        history = []
        chunk = self.CHUNK
        if log_every:
            chunk = min(chunk, log_every)
        i = 0
        while i < steps:
            k = min(chunk, steps - i)
            params, opt_state, losses = self.step_many(
                params, opt_state, dev_batch, k
            )
            if log_every:
                host = np.asarray(losses)
                for j in range(k):
                    s = i + j
                    if s % log_every == 0 or s == steps - 1:
                        history.append((s, float(host[j])))
            i += k
        return params, history

    # -- checkpointing ---------------------------------------------------

    @staticmethod
    def save_checkpoint(path: str, params, opt_state) -> None:
        """Write the state's leaves, fetched to the host, to ``path``
        (a ``.npz``; restore re-establishes any mesh placement by
        `init`/`device_put`)."""
        leaves = jax.tree.leaves({"params": params, "opt_state": opt_state})
        with open(path, "wb") as f:
            np.savez(f, **{f"leaf{i}": np.asarray(x) for i, x in enumerate(leaves)})

    @staticmethod
    def restore_checkpoint(path: str, like):
        """Read a `save_checkpoint` file back into the structure of
        ``like``, a (params, opt_state) template such as a fresh
        `init` gives — optax states come back as their NamedTuples."""
        tree = {"params": like[0], "opt_state": like[1]}
        treedef = jax.tree.structure(tree)
        with np.load(path) as z:
            leaves = [z[f"leaf{i}"] for i in range(treedef.num_leaves)]
            if len(z.files) != treedef.num_leaves:
                raise ValueError(
                    f"checkpoint {path!r} has {len(z.files)} arrays, the "
                    f"fit state {treedef.num_leaves}"
                )
        state = jax.tree.unflatten(treedef, leaves)
        return state["params"], state["opt_state"]


def pixel_grid(prep) -> tuple[np.ndarray, np.ndarray]:
    """Pixel-center coordinates of a `GlyphPrep`'s bitmap in PBF
    (Y-flipped row-major) order — host twin of
    `ops.sdf_jax.pixel_coords`."""
    w, h = prep.width, prep.height
    i = np.arange(w * h)
    x = i % w
    y = h - 1 - i // w
    return (prep.x0 + x + 0.5).astype(np.float32), (prep.y0 + y + 0.5).astype(
        np.float32
    )


def make_fit_batch(
    entry,
    codepoints,
    depth: int = 3,
    target_entry=None,
    line_cubics: bool = False,
) -> FitBatch:
    """Build a FitBatch from a font: initial curves come from
    ``entry``'s outlines (pixel space, with the same scale + sub-pixel
    shift as the parity pipeline), targets from the exact renderer on
    ``target_entry`` (default: the same font — a self-fit, useful for
    validating gradients and as a regularized starting point).

    ``line_cubics=True`` takes the initial curves from the natively
    flattened rings, each segment a line cubic (no fontTools pen);
    otherwise from the cubic outlines (`FontFileEntry.outline_curves`).
    """
    from ..ops.sdf_ref import render_sdf_exact
    from ..render.driver import Renderer
    from .glyph_model import bytes_to_field

    target_entry = target_entry or entry
    prep_of = Renderer("zeros").prep_glyph
    items = []
    for cp in codepoints:
        prep = prep_of(target_entry, cp)
        if prep is None or prep.empty:
            continue
        shift = np.array([prep.dx, 0.0])
        if line_cubics:
            from ..font.entry import line_cubics as _line_cubics

            src = prep_of(entry, cp)
            if src is None or src.empty:
                continue
            # Source rings in pixel space, re-shifted by the TARGET
            # glyph's sub-pixel dx (as the outline path places them).
            curves = _line_cubics(src.rings_px) - np.array([src.dx, 0.0]) + shift
        else:
            name = entry.glyph_name(cp)
            if name is None:
                continue
            curves = entry.outline_curves(name)
            if curves.shape[0] == 0:
                continue
            # Same placement transform as the parity pipeline
            # (renderer.rs:122-131): scale to 24px/EM, shift by dx.
            curves = curves * (24.0 / entry.units_per_em) + shift
        bitmap = render_sdf_exact(
            prep.segments, prep.width, prep.height, prep.x0, prep.y0
        )
        target = np.asarray(bytes_to_field(jnp.asarray(bitmap)))
        px, py = pixel_grid(prep)
        items.append(
            (cp, curves, px, py, target,
             (prep.x0, prep.y0, prep.width, prep.height))
        )

    if not items:
        raise ValueError("no fittable glyphs among the given codepoints")

    B = len(items)
    C_max = max(c.shape[0] for _, c, *_ in items)
    # Pixel axis padded to the flat-kernel tile size (a no-op for the
    # jnp backend beyond a few masked lanes).
    P_max = -(-max(len(px) for _, _, px, *_ in items) // 256) * 256
    curves0 = np.zeros((B, C_max, 4, 2), np.float32)
    curve_mask = np.zeros((B, C_max), bool)
    pxs = np.zeros((B, P_max), np.float32)
    pys = np.zeros((B, P_max), np.float32)
    pix_mask = np.zeros((B, P_max), np.float32)
    targets = np.zeros((B, P_max), np.float32)
    metas = np.zeros((B, 4), np.int32)
    kept = np.zeros(B, np.int32)
    for b, (cp, c, px, py, tg, m) in enumerate(items):
        kept[b] = cp
        curves0[b, : c.shape[0]] = c
        curve_mask[b, : c.shape[0]] = True
        n = len(px)
        pxs[b, :n] = px
        pys[b, :n] = py
        pix_mask[b, :n] = 1.0
        targets[b, :n] = tg
        metas[b] = m
    return FitBatch(
        curves0, curve_mask, pxs, pys, pix_mask, targets, metas, kept
    )
