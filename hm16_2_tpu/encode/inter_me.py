"""Frame-batched integer motion estimation on the accelerator.

Replaces the host per-PU +-8 search (the round-2 bottleneck flagged in
VERDICT.md) with a dense two-level search over +-64 for EVERY aligned
block of every CU size in one device dispatch per (frame, reference):

  level 1: 4x-downsampled planes, dense SSD grids for all 8x8-original
           blocks over +-16 coarse offsets (= +-64 full-pel), aggregated
           up the size pyramid (16/32/64) by summing child grids — the
           same-offset sums make every CU size's full +-64 grid free.
  level 2: full-resolution +-3 refinement around each block's best
           coarse offset and around the zero MV.

Costs are SSD + lambda * approximate MV-signalling bits against a
per-block predictor grid (the caller passes the previous frame's motion
field — a TMVP-like prior; the exact AMVP cost is applied at commit).

Reference for WHAT is computed: TEncSearch::xMotionEstimation /
xPatternSearch (TEncSearch.cpp:3816,3932 — full search, range 64) —
re-expressed as dense tensor ops instead of the reference's scalar
spiral scans.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from hm16_2_tpu._jaxcache import ensure_cache

ensure_cache()

import jax
import jax.numpy as jnp

COARSE_R = 16          # coarse-offset radius (x4 = full-pel +-64)
REFINE_R = 3           # full-res refinement radius around each center


def _mv_bits(d):
    """Approximate signalling bits for an MV delta component (full-pel
    domain): ~2*log2+1 like the exp-Golomb abs-mvd binarization."""
    return 2.0 * jnp.log2(jnp.abs(d).astype(jnp.float32) + 1.0) + 1.0


@partial(jax.jit, static_argnames=("h", "w", "full_h"))
def me_frame(cur, refs, mvp8, lam, row0=0, *, h: int, w: int,
             full_h: int | None = None):
    """Dense ME for all aligned blocks of sizes 8/16/32/64.

    cur:  (h, w) int32 current luma (a row band when row0 > 0)
    refs: (R, full_h, w) int32 reference lumas (always the FULL planes —
          the sharded caller all-gathers them over the mesh, SURVEY.md §5's
          reference-window exchange)
    mvp8: (R, h//8, w//8, 2) int32 full-pel per-8x8-block MV predictors
    lam:  f32 sqrt-domain lambda for the MV-bits term
    row0: first picture row of this band (0 for the whole frame)
    Returns {size: (mv (R,N,2) int32 full-pel, cost (R,N) f32)} with
    blocks in raster order per size.  Distortions are exact int32 sums
    (scaled for >8-bit), so band-sharded and whole-frame evaluations are
    bit-identical.
    """
    if full_h is None:
        full_h = h
    R = refs.shape[0]
    hc, wc = h // 4, w // 4
    fhc = full_h // 4
    # 4x box downsample (exact integer mean rounding down)
    cd = cur[: hc * 4, : wc * 4].reshape(hc, 4, wc, 4).sum((1, 3)) // 16
    rd = refs[:, : fhc * 4, : wc * 4].reshape(R, fhc, 4, wc, 4) \
        .sum((2, 4)) // 16
    rc0 = row0 // 4

    # coarse offsets grid
    offs = jnp.stack(jnp.meshgrid(
        jnp.arange(-COARSE_R, COARSE_R + 1),
        jnp.arange(-COARSE_R, COARSE_R + 1), indexing="ij"), -1) \
        .reshape(-1, 2)                                   # (O, 2)
    O = offs.shape[0]
    # edge padding: MVs may legally point into the extended reference
    # border (HM extendPicBorder)
    rdp = jnp.pad(rd, ((0, 0), (COARSE_R, COARSE_R), (COARSE_R, COARSE_R)),
                  mode="edge")
    n8y, n8x = h // 8, w // 8

    def coarse_one_ref(rp):
        def at(o):
            win = jax.lax.dynamic_slice(
                rp, (rc0 + o[0] + COARSE_R, o[1] + COARSE_R), (hc, wc))
            d = (cd - win).astype(jnp.int32)
            return ((d * d)[: n8y * 2, : n8x * 2]
                    .reshape(n8y, 2, n8x, 2).sum((1, 3))
                    .astype(jnp.float32))
        return jax.vmap(at)(offs)                          # (O, n8y, n8x)

    # per-8x8-original-block coarse grids, sequential over refs to bound
    # the (O, hc, wc) transient to one reference at a time
    g8 = jax.lax.map(coarse_one_ref, rdp)                  # (R, O, n8y, n8x)

    out = {}
    grids = {8: g8}
    for s in (16, 32, 64):
        p = grids[s // 2]
        ny, nx = h // s, w // s
        q = p[:, :, : ny * 2, : nx * 2]
        grids[s] = q.reshape(R, O, ny, 2, nx, 2).sum((3, 5))

    # full-res padded refs for the refinement gathers
    P = 4 * COARSE_R + REFINE_R + 64
    refp = jnp.pad(refs, ((0, 0), (P, P), (P, P)), mode="edge")

    lamf = lam.astype(jnp.float32)
    for s in (8, 16, 32, 64):
        ny, nx = h // s, w // s
        if ny == 0 or nx == 0:
            continue
        g = grids[s].reshape(R, O, ny * nx)
        # MV predictor per block at this size (subsample the 8-grid)
        step = s // 8
        mvp = mvp8[:, ::step, ::step][:, :ny, :nx].reshape(R, ny * nx, 2)
        mvb = (_mv_bits(4 * offs[None, :, None, 0]
                        - 4 * mvp[:, None, :, 0])
               + _mv_bits(4 * offs[None, :, None, 1]
                          - 4 * mvp[:, None, :, 1]))       # (R, O, N)
        best_o = jnp.argmin(g + lamf * mvb, axis=1)        # (R, N)
        coarse_mv = 4 * offs[best_o]                       # (R, N, 2)

        # refinement around coarse best and around the zero MV
        ys = jnp.tile(jnp.arange(ny)[:, None] * s, (1, nx)).reshape(-1)
        xs = jnp.tile(jnp.arange(nx)[None, :] * s, (ny, 1)).reshape(-1)
        roffs = jnp.stack(jnp.meshgrid(
            jnp.arange(-REFINE_R, REFINE_R + 1),
            jnp.arange(-REFINE_R, REFINE_R + 1), indexing="ij"), -1) \
            .reshape(-1, 2)                                # (49, 2)
        blocks = cur[: ny * s, : nx * s].reshape(ny, s, nx, s) \
            .swapaxes(1, 2).reshape(ny * nx, s, s)

        def refine(r_idx, centers):
            rp = refp[r_idx]

            def one(by, bx, c):
                win = jax.lax.dynamic_slice(
                    rp, (row0 + by + c[0] + P - REFINE_R,
                         bx + c[1] + P - REFINE_R),
                    (s + 2 * REFINE_R, s + 2 * REFINE_R))
                return win

            wins = jax.vmap(one)(ys, xs, centers)   # (N, s+6, s+6)

            # exact int32 SSD (scaled when 2*bd-16 > 0 would overflow
            # the 64x64 accumulation)
            def eval_offs(win, blk):
                def at(o):
                    sub = jax.lax.dynamic_slice(
                        win, (o[0] + REFINE_R, o[1] + REFINE_R), (s, s))
                    dd = (blk - sub).astype(jnp.int32)
                    sq = dd * dd
                    if s == 64:
                        sq = sq >> 2
                    return sq.sum().astype(jnp.float32)
                return jax.vmap(at)(roffs)          # (49,)
            return jax.vmap(eval_offs)(wins, blocks)  # (N, 49)

        mvs, costs = [], []
        for r_idx in range(R):
            cands = []
            for centers in (coarse_mv[r_idx],
                            jnp.zeros_like(coarse_mv[r_idx])):
                sse = refine(r_idx, centers)        # (N, 49)
                mv_cand = centers[:, None, :] + roffs[None, :, :]
                bits = (_mv_bits(4 * mv_cand[:, :, 0]
                                 - 4 * mvp[r_idx, :, None, 0])
                        + _mv_bits(4 * mv_cand[:, :, 1]
                                   - 4 * mvp[r_idx, :, None, 1]))
                cost = sse + lamf * bits
                k = jnp.argmin(cost, axis=1)
                cands.append((jnp.take_along_axis(
                    mv_cand, k[:, None, None], axis=1)[:, 0],
                    jnp.take_along_axis(cost, k[:, None], axis=1)[:, 0]))
            better = cands[0][1] <= cands[1][1]
            mv = jnp.where(better[:, None], cands[0][0], cands[1][0])
            cost = jnp.where(better, cands[0][1], cands[1][1])
            mvs.append(mv)
            costs.append(cost)
        out[s] = (jnp.stack(mvs).astype(jnp.int32), jnp.stack(costs))
    return out


class MePlan:
    """Fetched per-frame ME grids: (lx, r_idx, size) -> (mv, cost)."""

    __slots__ = ("grids", "h", "w")

    def __init__(self, h, w):
        self.grids = {}
        self.h, self.w = h, w

    def lookup(self, lx, r_idx, size, x0, y0):
        """Full-pel (mvx, mvy) for the aligned size-block at (x0, y0),
        or None (grids store (dy, dx))."""
        g = self.grids.get((lx, r_idx, size))
        if g is None or x0 % size or y0 % size:
            return None
        nx = self.w // size
        bx, by = x0 // size, y0 // size
        if bx >= nx or by >= self.h // size:
            return None
        mv, cost = g
        i = by * nx + bx
        return (int(mv[i, 1]), int(mv[i, 0]))


def submit_me(cur_y, ref_lists, prev_mv8, lam_sqrt, h, w, device):
    """Dispatch me_frame for every reference of both lists; returns a
    callable that fetches the MePlan (one blocking sync)."""
    uniq = []                      # deduplicated reference planes
    keymap = {}                    # (lx, r_idx) -> index into uniq
    for lx, refs in enumerate(ref_lists):
        for r_idx, ref in enumerate(refs):
            key = id(ref)
            for j, (k2, _) in enumerate(uniq):
                if k2 == key:
                    keymap[(lx, r_idx)] = j
                    break
            else:
                keymap[(lx, r_idx)] = len(uniq)
                uniq.append((key, ref.rec[0]))
    if not uniq:
        return lambda: MePlan(h, w)
    with jax.default_device(device):
        refs = jnp.stack([jnp.asarray(p[:h, :w], jnp.int32)
                          for _, p in uniq])
        cur = jnp.asarray(cur_y[:h, :w], jnp.int32)
        if prev_mv8 is None:
            mvp8 = jnp.zeros((refs.shape[0], h // 8, w // 8, 2), jnp.int32)
        else:
            mvp8 = jnp.broadcast_to(
                jnp.asarray(prev_mv8, jnp.int32)[None],
                (refs.shape[0], h // 8, w // 8, 2))
        res = me_frame(cur, refs, mvp8, jnp.float32(lam_sqrt), h=h, w=w)
        for s, (mv, cost) in res.items():
            try:
                mv.copy_to_host_async()
            except Exception:
                pass

    def fetch():
        plan = MePlan(h, w)
        for s, (mv, cost) in res.items():
            mvn = np.asarray(mv)
            costn = np.asarray(cost)
            for (lx, r_idx), j in keymap.items():
                plan.grids[(lx, r_idx, s)] = (mvn[j], costn[j])
        return plan

    return fetch
