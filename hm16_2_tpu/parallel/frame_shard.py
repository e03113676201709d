"""Row-sharded frame analysis: the real encode pipeline over a device mesh.

Shards stage 1 of the batched intra RD pipeline (encode/intra_rd.py) across
a `row` mesh axis: the luma plane is split into horizontal bands of block
rows, each device evaluates its band's candidate CUs, and the one-row
halo a band needs for its top reference samples arrives from the device
above via `ppermute` — the intra top-row neighbour exchange
listed in SURVEY.md section 5.  (Left/bottom reference extensions are
original-pixel replications that stay band-local.)

The host then runs the (cheap) quadtree DP + z-order commit + CABAC
exactly as in the single-device path, so the produced bitstream is
byte-identical — asserted by tests and by __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from hm16_2_tpu._jaxcache import ensure_cache

ensure_cache()

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hm16_2_tpu.encode import intra_rd
from hm16_2_tpu.ops import analysis


def make_row_mesh(devices):
    return Mesh(np.array(devices).reshape(-1), ("row",))


def _band_rd(plane_band, halo_top, halo_bot, band_first, s, bd, k, qp,
             lam, strong, pic_h):
    """Candidate RD for one band's aligned s-blocks (runs per device).

    plane_band: (B, W) original rows of this band (B = rows per device)
    halo_top:   (1, W) last row of the band above (undefined for band 0 —
                replaced by edge replication below)
    halo_bot:   (s, W) first rows of the band below (bottom-left intra
                reference extension; undefined past the picture bottom,
                where the clip below never reaches it)
    band_first: scalar row index of the band's first picture row
    """
    B, W = plane_band.shape
    nby, nbx = B // s, W // s
    # assemble the (4s+1) reference buffers for every block from the band
    # plus the exchanged halo row (top refs of the first block row)
    ext = jnp.concatenate([halo_top, plane_band], axis=0)   # (B+1, W)
    # top refs of block row r live at band row r*s-1 -> ext row r*s
    x0s = (jnp.arange(nbx) * s)[None, :].repeat(nby, 0).reshape(-1)
    y0s = (jnp.arange(nby) * s)[:, None].repeat(nbx, 1).reshape(-1)
    in_pic_top = (band_first + y0s) > 0
    rng = jnp.arange(-1, 2 * s)
    tops = ext[jnp.clip(y0s, 0, B)[:, None],
               jnp.clip(x0s[:, None] + rng[None, :], 0, W - 1)]
    # top row outside the picture: replicate the block's first row
    row0 = plane_band[y0s[:, None],
                      jnp.clip(x0s[:, None] + rng[None, :], 0, W - 1)]
    tops = jnp.where(in_pic_top[:, None], tops, row0)
    lrng = jnp.concatenate([jnp.array([-1]), jnp.arange(0, 2 * s)])
    # left refs extend down into the next band (halo_bot); clip at the
    # picture bottom exactly like the single-device assembly
    ext2 = jnp.concatenate([plane_band, halo_bot], axis=0)
    max_row = jnp.minimum(B + s - 1, pic_h - 1 - band_first)
    lefts = ext2[jnp.clip(y0s[:, None] + lrng[None, :], 0, max_row),
                 jnp.clip(x0s - 1, 0, None)[:, None]]
    left_col_in_pic = x0s > 0
    col0 = ext2[jnp.clip(y0s[:, None] + lrng[None, :], 0, max_row),
                x0s[:, None]]
    lefts = jnp.where(left_col_in_pic[:, None], lefts, col0)
    # corner comes from the top refs
    lefts = lefts.at[:, 0].set(tops[:, 0])
    n = nby * nbx
    buf_u = jnp.zeros((n, 4 * s + 1), dtype=jnp.int32)
    buf_u = buf_u.at[:, 2 * s].set(tops[:, 0])
    buf_u = buf_u.at[:, 2 * s + 1:].set(tops[:, 1:])
    buf_u = buf_u.at[:, :2 * s].set(lefts[:, 1:][:, ::-1])
    buf_f = buf_u.at[:, 1:-1].set(
        (buf_u[:, 2:] + 2 * buf_u[:, 1:-1] + buf_u[:, :-2] + 2) >> 2)
    if s == 32 and strong:
        thr = 1 << (bd - 5)
        c0, cs_, c2s = buf_u[:, 2 * s], buf_u[:, 3 * s], buf_u[:, 4 * s]
        l0, ls_, l2s = buf_u[:, 2 * s], buf_u[:, s], buf_u[:, 0]
        use = (jnp.abs(c0 + c2s - 2 * cs_) < thr) & \
              (jnp.abs(l0 + l2s - 2 * ls_) < thr)
        i = jnp.arange(1, 2 * s)
        top_bl = ((2 * s - i)[None, :] * c0[:, None]
                  + i[None, :] * c2s[:, None] + s) >> 6
        left_bl = ((2 * s - i)[None, :] * l0[:, None]
                   + i[None, :] * l2s[:, None] + s) >> 6
        sb = buf_u.at[:, 2 * s + 1: 4 * s].set(top_bl)
        sb = sb.at[:, 1: 2 * s].set(left_bl[:, ::-1])
        buf_f = jnp.where(use[:, None], sb, buf_f)
    bufs = jnp.stack([buf_u, buf_f], axis=1)
    blocks = plane_band[:nby * s, :nbx * s].reshape(nby, s, nbx, s) \
        .swapaxes(1, 2).reshape(n, s, s).astype(jnp.int32)
    mode, cost, top3, satd = intra_rd._size_rd(
        bufs, blocks, lam, s, bd, k, qp, True, s == 4, True)
    return (mode.reshape(nby, nbx), cost.reshape(nby, nbx),
            top3.reshape(nby, nbx, 3), satd.reshape(nby, nbx, 35))


_STEP_CACHE: dict = {}


def _mesh_key(mesh):
    return tuple(id(d) for d in mesh.devices.flat)


def sharded_size_rd(mesh: Mesh, plane: np.ndarray, s: int, bd: int, k: int,
                    qp: int, lam: float, strong: bool, pic_h: int):
    """Row-sharded dual of intra_rd's per-size evaluation.

    plane: (H, W) original luma rows, H divisible by (devices * s).
    Returns (mode, cost) numpy arrays of shape (H//s, W//s)."""
    n_dev = mesh.devices.size
    H, W = plane.shape
    assert H % (n_dev * s) == 0, (H, n_dev, s)

    key = (_mesh_key(mesh), H, W, s, bd, k, qp, float(lam), strong, pic_h)
    step = _STEP_CACHE.get(key)
    if step is None:
        # jitted: an eager shard_map dispatches (and compiles) op by op
        @jax.jit
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P("row", None),),
                 out_specs=(P("row", None), P("row", None), P("row", None),
                            P("row", None)),
                 check_vma=False)
        def step(band):
            # halos: last row of the band above moves down one
            # device, the first s rows of the band below move up one
            halo_top = jax.lax.ppermute(
                band[-1:, :], "row", [(i, i + 1) for i in range(n_dev - 1)])
            halo_bot = jax.lax.ppermute(
                band[:s, :], "row", [(i + 1, i) for i in range(n_dev - 1)])
            idx = jax.lax.axis_index("row")
            first = idx * (H // n_dev)
            return _band_rd(band, halo_top, halo_bot, first, s, bd, k, qp,
                            lam, strong, pic_h)
        _STEP_CACHE[key] = step

    arr = jax.device_put(jnp.asarray(plane, jnp.int32),
                         NamedSharding(mesh, P("row", None)))
    return step(arr)


def sharded_plan_frame(mesh, orig, sps, qp, lam, chroma_weight, chroma_qps):
    """plan_frame with the luma per-size stage-1 sweeps sharded over the
    mesh rows where the geometry divides evenly (other sizes run
    unsharded on device 0).  The per-size grids feed the same fused
    _plan_device program as the single-device path; every cross-block
    reduction in stage 1 is integer, so the grids — and therefore the
    plan and the bitstream — are bit-identical either way (asserted by
    tests and __graft_entry__.dryrun_multichip)."""
    n_dev = mesh.devices.size
    h, w = sps.pic_height, sps.pic_width
    bd = sps.bit_depth_luma
    strong = bool(sps.strong_intra_smoothing)

    stage1 = []
    for s in (4, 8, 16, 32):
        k = intra_rd.NUM_RD_CANDS[s]
        rows = (h // s) * s
        if rows and rows % (n_dev * s) == 0:
            mode, cost, top3, satd = sharded_size_rd(
                mesh, np.ascontiguousarray(orig[0][:rows]), s, bd, k,
                int(qp), float(lam), strong, h)
        else:
            bufs, blocks = intra_rd._jnp_ref_buffers(
                jnp.asarray(orig[0], jnp.int32), s, bd, strong, h, w)
            mode, cost, top3, satd = intra_rd._size_rd(
                bufs, blocks, jnp.float32(lam), s, bd, k, int(qp), True,
                s == 4, True)
        # host-materialize: the grids are tiny, and the fused plan jit
        # wants uniformly-placed inputs (the sharded ones live spread
        # over the mesh)
        stage1.append((np.asarray(mode).reshape(-1),
                       np.asarray(cost).reshape(-1),
                       np.asarray(top3).reshape(-1, 3),
                       np.asarray(satd).reshape(-1, 35)))

    packed = intra_rd.submit_plan(orig, sps, qp, lam, chroma_weight,
                                  chroma_qps, stage1=tuple(stage1))
    return intra_rd.fetch_plan(packed, h, w)
