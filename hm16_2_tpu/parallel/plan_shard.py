"""Row-sharded integer ME for the fused inter frame plan.

Shards stage 1 of encode/inter_plan.py — the dense +-64 integer motion
search (coarse 4x-downsampled SSD pyramid + full-res refinement), the
dominant FLOPs of a P/B frame plan — across a `row` device mesh: each
device computes the ME grids for its 64-multiple band of block rows
while the reference planes ride the interconnect once via `all_gather`
(SURVEY.md section 5's inter exchange set; the TEncSlice.cpp:736-756
WPP row-parallel analogue).  Band boundaries are 64-multiples, so every
coarse-pyramid sum and refinement window is identical to the
single-device computation and the produced grids — and therefore the
plan and the bitstream — are bit-identical (asserted by
__graft_entry__.dryrun_multichip and tests/test_frame_shard.py).

The remaining fused plan stages (subpel planes, fractional refinement,
pricing, residual trials, quadtree DP) run unsharded on the lead device
with the grids passed in (`inter_plan._plan_device(me=..., has_me=True)`),
mirroring how frame_shard.sharded_plan_frame host-materializes the
sharded intra stage-1 grids.
"""

from __future__ import annotations

import numpy as np

from hm16_2_tpu._jaxcache import ensure_cache

ensure_cache()

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from hm16_2_tpu.encode import inter_plan

_STEP_CACHE: dict = {}
# the grids the fused plan takes as `me`: square sizes, (size, part) rects
_SQ = (8, 16, 32, 64)
_RECT = ((16, 1), (16, 2), (32, 1), (32, 2), (64, 1), (64, 2))


def _mesh_key(mesh):
    return tuple(id(d) for d in mesh.devices.flat)


def shardable(mesh, h: int, w: int, parts: bool) -> bool:
    """The banded ME is exact only when every device holds a whole
    number of 64-row CTU bands (and the frame has full 64-columns)."""
    n_dev = mesh.devices.size
    return (parts and n_dev > 1 and h % (n_dev * 64) == 0 and w >= 64)


def sharded_int_me(mesh, cur, refs, mvn16, dists, lam_sqrt, h: int,
                   w: int):
    """Integer-ME grids for the inter plan, row-banded over the mesh.

    cur: (h, w) int32 original luma; refs: (R, h, w) int32 unique
    reference planes (already padded to the plan's fixed R); mvn16:
    (h//8, w//8, 2) POC-normalized motion prior; dists: (R,) signed POC
    distances.  Returns the host pytree (sq, rect) that
    inter_plan._plan_device accepts as its `me` input."""
    n_dev = mesh.devices.size
    R = refs.shape[0]
    band = h // n_dev
    key = (_mesh_key(mesh), R, h, w)
    step = _STEP_CACHE.get(key)
    if step is None:
        def band_me(cur_b, refs_b, mvn_b, dists_, lams_):
            refs_full = jax.lax.all_gather(refs_b, "row", axis=1,
                                           tiled=True)
            idx = jax.lax.axis_index("row")
            y0 = idx * band
            mv_cap = inter_plan.MARGIN - inter_plan.REFINE_R - 8
            mvp_full = jnp.clip(jnp.rint(
                mvn_b[None].astype(jnp.float32) *
                dists_[:, None, None, None].astype(jnp.float32) / 64.0
            ).astype(jnp.int32), -mv_cap, mv_cap)
            sq, rect = inter_plan._int_me_grids(
                cur_b, refs_full, mvp_full, lams_, band, w, True, y0=y0)
            return (tuple(sq[k] for k in _SQ)
                    + tuple(rect[k] for k in _RECT))

        gspec = P(None, "row", None, None)
        step = jax.jit(jax.shard_map(
            band_me, mesh=mesh,
            in_specs=(P("row", None), P(None, "row", None),
                      P("row", None, None), P(None), P()),
            out_specs=(gspec,) * (len(_SQ) + len(_RECT)),
            check_vma=False))
        _STEP_CACHE[key] = step

    args = (
        jax.device_put(jnp.asarray(cur, jnp.int32),
                       NamedSharding(mesh, P("row", None))),
        jax.device_put(jnp.asarray(refs, jnp.int32),
                       NamedSharding(mesh, P(None, "row", None))),
        jax.device_put(jnp.asarray(mvn16, jnp.int32),
                       NamedSharding(mesh, P("row", None, None))),
        jnp.asarray(dists, jnp.int32),
        jnp.float32(lam_sqrt),
    )
    out = [np.asarray(o) for o in step(*args)]
    return dict(zip(_SQ, out)), dict(zip(_RECT, out[len(_SQ):]))


def me_zeros(h: int, w: int, r: int):
    """All-zero grids shaped as sharded_int_me returns them for an (h, w)
    frame with r references: the `me` input for compiling the fused plan
    that consumes banded ME without running it."""
    i32 = jnp.int32
    sq, rect = jax.eval_shape(
        lambda c, rf, mv: inter_plan._int_me_grids(
            c, rf, mv, jnp.float32(0), h, w, True),
        jax.ShapeDtypeStruct((h, w), i32),
        jax.ShapeDtypeStruct((r, h, w), i32),
        jax.ShapeDtypeStruct((r, h // 8, w // 8, 2), i32))
    return ({k: np.zeros(sq[k].shape, sq[k].dtype) for k in _SQ},
            {k: np.zeros(rect[k].shape, rect[k].dtype) for k in _RECT})
