"""Frame-level fused inter mode decision (the accelerator P/B encode path).

HM's inter search is a per-CU recursion: merge SATD ranking, per-ref AMVP
motion estimation with fractional refinement, partition trials and RQT
residual coding, all against running CABAC contexts
(TEncSearch::predInterSearch TEncSearch.cpp:3075, xMergeEstimation :2987,
xPatternSearchFracDIF :4386, encodeResAndCalcRdInterCU :4435;
TEncCu::xCompressCU TEncCu.cpp:466).  That walk is wavefront-sequential
and was the round-3 bottleneck (host Python per CU, ~16x slower than the
C++ reference).  Here the whole frame's inter decision runs as ONE device
program per frame, mirroring what intra_rd._plan_device does for I frames:

  stage 1: dense +-64 integer ME for every aligned block of sizes
           8/16/32/64 x every reference (coarse 4x-downsampled SSD
           pyramid + full-res refinement) — all dense tensor ops
  stage 2: 16-phase quarter-pel interpolated planes per reference
           (separable 8-tap, bit-exact with ops.interp_ref.mc_block's
           rounded output), then half+quarter diamond SATD refinement
           around each block's integer MV via phase-plane gathers
  stage 3: candidate pricing per block per size: per-list best reference
           (SATD + exact MVD bin count vs a TMVP-prior predictor),
           bi-prediction, and four approximate merge candidates
           (left / above neighbor motion, TMVP, zero) — MC by gathers
  stage 4: residual trial RD for the winning candidate: forward DCT +
           quant + estimated CABAC bits + reconstruction SSE, plus the
           zero-residual (skip) alternative
  stage 5: intra alternative per block (the intra plan's 35-mode
           candidate RD, reduced candidate count)
  stage 6: bottom-up quadtree DP + dense plan emission

The host commit pass (encode/top.py _commit_planned_inter) maps the
planned motion onto the EXACT merge/AMVP candidate lists derived from
committed neighbors, runs the normative MC + residual coding, and emits
CABAC — so the bitstream stays standard HEVC; the plan only decides.

Approximations (classic HW-encoder tradeoffs, SURVEY.md section 7):
original-pixel SATD with rounded-pixel subpel planes, context-free bit
estimates, TMVP-prior MVD pricing, and approximate merge lists (repaired
at commit against the exact list).
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

from hm16_2_tpu._jaxcache import ensure_cache

ensure_cache()

import jax
import jax.numpy as jnp

from hm16_2_tpu.common.tables import (
    DCT, INV_QUANT_SCALES, LUMA_FILTER, QUANT_SCALES)
from hm16_2_tpu.encode.intra_rd import (
    NUM_RD_CANDS, _bits_estimate, _jnp_ref_buffers, _pad_to, _quad,
    _topk_argmin, _up, batched_inv_transform)
from hm16_2_tpu.ops import analysis

COARSE_R = 16          # coarse-offset radius (x4 = full-pel +-64)
REFINE_R = 3           # full-res int refinement radius
MAXREF_PLAN = 4        # fixed per-list ref-count the plan is compiled for
MARGIN = 80            # subpel-plane padding (covers +-67 int + filter)

# plan-stage bit-cost constants (fractional bins; calibrated on content —
# the commit pass recomputes exact rates for the chosen mode)
MERGE_FLAG_BITS = 1.0
SKIP_EXTRA_BITS = 1.0      # cu_skip_flag vs (pred_mode+part+merge_flag)
UNI_BASE_BITS = 4.0        # inter_dir + mvp flag + part/pred_mode bins
BI_BASE_BITS = 6.0
SPLIT_BITS = 3.0
INTRA_EXTRA_BITS = 3.0     # pred_mode flag + mpm signalling vs I-slice
RECT_PART_BITS = 1.5       # part_mode rect bins + PU1 merge_flag margin


# ---------------------------------------------------------------------------
# exact MVD bin counts (TEncSbac::codeMvd binarization), vectorized
# ---------------------------------------------------------------------------

def _mvd_comp_bits_j(d):
    """Exact bins for one MVD component (quarter-pel domain): greater0,
    greater1, sign + EG1 remainder — matches CtuSearch._mvd_comp_bits."""
    a = jnp.abs(d).astype(jnp.int32)
    eg1 = 5.0 + 2.0 * jnp.floor(jnp.log2(jnp.maximum(a >> 1, 1)
                                         .astype(jnp.float32)))
    return jnp.where(a == 0, 1.0, jnp.where(a == 1, 3.0, eg1))


def _mvd_bits_j(dx, dy):
    return _mvd_comp_bits_j(dx) + _mvd_comp_bits_j(dy)


# ---------------------------------------------------------------------------
# traced-QP quant / dequant (the intra_rd versions bake QP into the jit;
# the inter plan traces QP so the LDP/RA QP ladder shares one program)
# ---------------------------------------------------------------------------

def _quant_t(coeffs, qp, bit_depth: int, log2_tr: int):
    per, rem = qp // 6, qp % 6
    tshift = 15 - bit_depth - log2_tr
    q_bits = 14 + per + tshift
    scale = jnp.asarray(QUANT_SCALES.astype(np.int32))[rem]
    add = 85 << jnp.maximum(q_bits - 9, 0)          # inter rounding offset
    c = coeffs.astype(jnp.int32)
    level = (jnp.abs(c) * scale + add) >> q_bits
    return (jnp.sign(c) * jnp.clip(level, 0, 32767)).astype(jnp.int32)


def _dequant_t(levels, qp, bit_depth: int, log2_tr: int):
    per, rem = qp // 6, qp % 6
    max_dr = 15
    tshift = max_dr - bit_depth - log2_tr
    right_shift = 6 - (tshift + per)
    scale = jnp.asarray(INV_QUANT_SCALES.astype(np.int32))[rem]
    # right_shift is traced: compute both directions and select
    target_bd = jnp.minimum(max_dr + 1, 32 + right_shift - 7)
    imax = (1 << (target_bd - 1)) - 1
    q = jnp.clip(levels.astype(jnp.int32), -imax - 1, imax)
    rs = jnp.maximum(right_shift, 0)
    ls = jnp.maximum(-right_shift, 0)
    pos = (q * scale + (1 << jnp.maximum(rs - 1, 0))
           * jnp.where(rs > 0, 1, 0)) >> rs
    out = jnp.where(right_shift > 0, pos, (q * scale) << ls)
    return jnp.clip(out, -(1 << max_dr), (1 << max_dr) - 1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# stage 1: dense integer ME (me_frame's pyramid, grid-shaped output)
# ---------------------------------------------------------------------------

def _me_shape(cur, refp, P, offs, roffs, grid, mvp_pu, lamf, bh: int,
              bw: int, y0=0):
    """Best full-pel MV per (ref, block) for one block SHAPE (bh, bw):
    coarse-grid argmin with MVD-prior pricing, then full-res +-REFINE_R
    SSE refinement around both the coarse winner and the zero MV.
    grid: (R, O, Ny, Nx) coarse SSD; mvp_pu: (R, Ny, Nx, 2) full-pel
    prior; y0: picture row of cur's first row (nonzero when cur is one
    row-band of a sharded frame and refp covers the whole padded frame).
    Returns (R, Ny, Nx, 2) int32 (dy, dx)."""
    R, O, Ny, Nx = grid.shape
    N = Ny * Nx
    g = grid.reshape(R, O, N)
    mvp = mvp_pu.reshape(R, N, 2)
    mvb = (_mvd_bits_j(
        4 * (offs[None, :, None, 1] - mvp[:, None, :, 1]),
        4 * (offs[None, :, None, 0] - mvp[:, None, :, 0])))
    best_o = jnp.argmin(g + lamf * mvb, axis=1)           # (R, N)
    coarse_mv = 4 * offs[best_o]                          # (R, N, 2)

    ys = jnp.repeat(jnp.arange(Ny) * bh, Nx) + y0
    xs = jnp.tile(jnp.arange(Nx) * bw, Ny)
    blocks = cur[: Ny * bh, : Nx * bw].reshape(Ny, bh, Nx, bw) \
        .swapaxes(1, 2).reshape(N, bh, bw)

    def refine(rp, centers):
        def one(by, bx, c):
            return jax.lax.dynamic_slice(
                rp, (by + c[0] + P - REFINE_R, bx + c[1] + P - REFINE_R),
                (bh + 2 * REFINE_R, bw + 2 * REFINE_R))

        wins = jax.vmap(one)(ys, xs, centers)     # (N, bh+2r, bw+2r)

        # static slicing over the gathered windows: one gather per
        # block, the 49 offsets are compile-time slices (no serial
        # per-offset gather chain on the VPU)
        cols = []
        for dy in range(2 * REFINE_R + 1):
            for dx in range(2 * REFINE_R + 1):
                sub = wins[:, dy:dy + bh, dx:dx + bw]
                dd = (blocks - sub).astype(jnp.int32)
                sq = dd * dd
                if bh * bw >= 4096:
                    sq = sq >> 2          # float32 headroom for 64x64
                cols.append(sq.sum(axis=(-1, -2)).astype(jnp.float32))
        return jnp.stack(cols, axis=1)                    # (N, 49)

    # lax.map over references: traces the refinement body ONCE instead
    # of unrolling it R times (the unrolled HLO made XLA compiles of the
    # widened plan program minutes-long)
    def per_ref(args):
        rp, cmv, mvp_r = args
        cands = []
        for centers in (cmv, jnp.zeros_like(cmv)):
            sse = refine(rp, centers)
            mv_cand = centers[:, None, :] + roffs[None, :, :]
            bits = _mvd_bits_j(
                4 * (mv_cand[:, :, 1] - mvp_r[:, None, 1]),
                4 * (mv_cand[:, :, 0] - mvp_r[:, None, 0]))
            cost = sse + lamf * bits
            k = jnp.argmin(cost, axis=1)
            cands.append((jnp.take_along_axis(
                mv_cand, k[:, None, None], axis=1)[:, 0],
                jnp.take_along_axis(cost, k[:, None], axis=1)[:, 0]))
        better = cands[0][1] <= cands[1][1]
        return jnp.where(better[:, None], cands[0][0], cands[1][0])

    mvs = jax.lax.map(per_ref, (refp, coarse_mv, mvp))
    return mvs.reshape(R, Ny, Nx, 2)


# CU sizes whose rect partitions (2NxN / Nx2N) the plan prices; 8x8 CUs
# would need the 8x4/4x8 small-PU rules and are left 2Nx2N-only
RECT_SIZES = (16, 32, 64)


def _int_me_grids(cur, refs, mvp8, lam_sqrt, h, w, parts: bool, y0=0):
    """Best full-pel MV per (ref, block) for the square CU sizes
    8/16/32/64 AND (when parts) the rect PU shapes of RECT_SIZES.
    mvp8: (R, h//8, w//8, 2) PER-REF full-pel prior (dy, dx).
    When cur is one row-band of a sharded frame, refs still cover the
    WHOLE frame and y0 is the band's first picture row (a multiple of
    64), so every reference window equals the single-device one and the
    resulting grids are bit-identical (SURVEY.md section 5).
    Returns (sq, rect): sq[s]: (R, ny, nx, 2); rect[(s, part)]:
    (R, Ny, Nx, 2) with part 1 = 2NxN (PUs s/2 high, raster (2ny, nx))
    and part 2 = Nx2N (PUs s/2 wide, raster (ny, 2nx))."""
    R = refs.shape[0]
    hc, wc = h // 4, w // 4
    hcf = refs.shape[1] // 4
    cd = cur[: hc * 4, : wc * 4].reshape(hc, 4, wc, 4).sum((1, 3)) // 16
    rd = refs[:, : hcf * 4, : wc * 4].reshape(R, hcf, 4, wc, 4) \
        .sum((2, 4)) // 16

    offs = jnp.stack(jnp.meshgrid(
        jnp.arange(-COARSE_R, COARSE_R + 1),
        jnp.arange(-COARSE_R, COARSE_R + 1), indexing="ij"), -1).reshape(-1, 2)
    O = offs.shape[0]
    rdp = jnp.pad(rd, ((0, 0), (COARSE_R, COARSE_R), (COARSE_R, COARSE_R)),
                  mode="edge")
    n8y, n8x = h // 8, w // 8

    def coarse_one_ref(rp):
        def at(o):
            win = jax.lax.dynamic_slice(
                rp, (y0 // 4 + o[0] + COARSE_R, o[1] + COARSE_R), (hc, wc))
            d = (cd - win).astype(jnp.int32)
            return ((d * d)[: n8y * 2, : n8x * 2]
                    .reshape(n8y, 2, n8x, 2).sum((1, 3)).astype(jnp.float32))
        return jax.vmap(at)(offs)

    g8 = jax.lax.map(coarse_one_ref, rdp)            # (R, O, n8y, n8x)
    grids = {8: g8}
    for s in (16, 32, 64):
        p = grids[s // 2]
        ny, nx = h // s, w // s
        q = p[:, :, : ny * 2, : nx * 2]
        grids[s] = q.reshape(R, O, ny, 2, nx, 2).sum((3, 5))

    P = 4 * COARSE_R + REFINE_R + 64
    refp = jnp.pad(refs, ((0, 0), (P, P), (P, P)), mode="edge")
    roffs = jnp.stack(jnp.meshgrid(
        jnp.arange(-REFINE_R, REFINE_R + 1),
        jnp.arange(-REFINE_R, REFINE_R + 1), indexing="ij"), -1).reshape(-1, 2)
    lamf = lam_sqrt.astype(jnp.float32)

    sq = {}
    for s in (8, 16, 32, 64):
        ny, nx = h // s, w // s
        if ny == 0 or nx == 0:
            sq[s] = jnp.zeros((R, ny, nx, 2), jnp.int32)
            continue
        step = s // 8
        mvp = mvp8[:, ::step, ::step][:, :ny, :nx]
        sq[s] = _me_shape(cur, refp, P, offs, roffs, grids[s], mvp, lamf,
                          s, s, y0)

    rect = {}
    if parts:
        for s in RECT_SIZES:
            ny, nx = h // s, w // s
            if ny == 0 or nx == 0:
                continue
            half = grids[s // 2][:, :, : 2 * ny, : 2 * nx]
            # 2NxN: PU shape (s/2, s) — sum half-grid x-pairs
            gh = half.reshape(R, O, 2 * ny, nx, 2).sum(-1)
            mvp_h = mvp8[:, ::s // 16, ::s // 8][:, : 2 * ny, :nx]
            rect[(s, 1)] = _me_shape(cur, refp, P, offs, roffs, gh, mvp_h,
                                     lamf, s // 2, s, y0)
            # Nx2N: PU shape (s, s/2) — sum half-grid y-pairs
            gv = half.reshape(R, O, ny, 2, 2 * nx).sum(3)
            mvp_v = mvp8[:, ::s // 8, ::s // 16][:, :ny, : 2 * nx]
            rect[(s, 2)] = _me_shape(cur, refp, P, offs, roffs, gv, mvp_v,
                                     lamf, s, s // 2, y0)
    return sq, rect


# ---------------------------------------------------------------------------
# stage 2: 16-phase quarter-pel planes (bit-exact with mc_block)
# ---------------------------------------------------------------------------

def _subpel_planes(refs, bd: int, h: int, w: int):
    """(R, 16, h+2M+1, w+2M+1) int16 planes; plane[ph][y, x] is the
    rounded prediction sample at picture coord (y - M + fy/4, x - M + fx/4)
    with ph = fy*4 + fx.  Matches interp_ref.mc_block's is_last output."""
    M = MARGIN
    R = refs.shape[0]
    taps = np.asarray(LUMA_FILTER, dtype=np.int32)       # (4, 8)
    hr = max(2, 14 - bd)
    sh1 = 6 - hr                                          # may be negative
    OFFS = 1 << 13
    Hp, Wp = h + 2 * M + 1, w + 2 * M + 1
    rp = jnp.pad(refs, ((0, 0), (M + 4, M + 5), (M + 4, M + 5)),
                 mode="edge").astype(jnp.int32)

    def hfilt(fx):
        if fx == 0:
            # copy stage (is_first, not last): keep full rows for vfilt
            return (rp[:, :, 4: 4 + Wp] << hr) - OFFS
        t = taps[fx]
        acc = jnp.zeros((R, rp.shape[1], Wp), jnp.int32)
        for k in range(8):
            acc = acc + int(t[k]) * rp[:, :, 1 + k: 1 + k + Wp]
        if sh1 >= 0:
            return (acc - (OFFS << sh1)) >> sh1
        return (acc << (-sh1)) - OFFS

    planes = []
    hcache = [hfilt(fx) for fx in range(4)]   # hoisted: shared across fy
    for fy in range(4):
        for fx in range(4):
            hh = hcache[fx]                               # (R, Hrows, Wp)
            if fy == 0:
                out = (hh[:, 4: 4 + Hp] + OFFS + (1 << (hr - 1))) >> hr
            else:
                # int32 headroom: |intermediate| < 2^21, sum(|taps|) = 96
                t = taps[fy]
                acc = jnp.zeros((R, Hp, Wp), jnp.int32)
                for k in range(8):
                    acc = acc + int(t[k]) * hh[:, 1 + k: 1 + k + Hp]
                sh2 = 6 + hr
                out = (acc + (1 << (sh2 - 1)) + (OFFS << 6)) >> sh2
            planes.append(jnp.clip(out, 0, (1 << bd) - 1).astype(jnp.int16))
    # (R, 16, Hp, Wp)
    return jnp.stack(planes, axis=1)


def _gather_pred(suball, ys, xs, mv4, uref, bh: int, bw: int = None):
    """Predicted blocks for per-block quarter MVs.  suball: (R*16, Hp, Wp)
    int16 phase planes of ALL references stacked; uref: (N,) unique-ref
    index per block; mv4: (N, 2) quarter-pel (dy, dx); one gather per
    block.  Returns (N, bh, bw) int32."""
    M = MARGIN
    if bw is None:
        bw = bh

    def one(y, x, mv, r):
        ph = r * 16 + (mv[0] & 3) * 4 + (mv[1] & 3)
        iy = y + (mv[0] >> 2) + M
        ix = x + (mv[1] >> 2) + M
        return jax.lax.dynamic_slice(suball, (ph, iy, ix), (1, bh, bw))[0]

    return jax.vmap(one)(ys, xs, mv4, uref).astype(jnp.int32)


# quarter offsets covered by the fractional refinement, (dy, dx) in -3..3
_QOFFS = [(dy, dx) for dy in range(-3, 4) for dx in range(-3, 4)]


def _frac_refine(sub_r, blocks, ys, xs, mv_int, pred4, lam_sqrt, bh: int,
                 bw: int = None):
    """Quarter-pel SATD refinement over the full +-3 quarter window
    around the integer MV (superset of xPatternSearchFracDIF's half+
    quarter diamonds).  ONE (16, bh+2, bw+2) gather per block; the 49
    offsets are static slices of the window.  Returns (mv4 (N,2),
    satd (N,))."""
    M = MARGIN
    if bw is None:
        bw = bh

    def one(y, x, mv):
        # window covering integer offsets {iv-1, iv} on both axes for all
        # 16 phase planes
        return jax.lax.dynamic_slice(
            sub_r, (0, y + mv[0] - 1 + M, x + mv[1] - 1 + M),
            (16, bh + 2, bw + 2))

    wins = jax.vmap(one)(ys, xs, mv_int)          # (N, 16, bh+2, bw+2)

    preds, bits = [], []
    for (qy, qx) in _QOFFS:
        ph = (qy & 3) * 4 + (qx & 3)
        oy = 1 + (qy >> 2)
        ox = 1 + (qx >> 2)
        preds.append(wins[:, ph, oy:oy + bh, ox:ox + bw])
        mv4y = 4 * mv_int[:, 0] + qy
        mv4x = 4 * mv_int[:, 1] + qx
        bits.append(_mvd_bits_j(mv4x - pred4[:, 1], mv4y - pred4[:, 0]))
    pred = jnp.stack(preds, axis=1).astype(jnp.int32)   # (N, 49, s, s)
    satd = analysis.batched_satd(
        blocks[:, None] - pred).astype(jnp.float32)      # (N, 49)
    cost = satd + lam_sqrt * jnp.stack(bits, axis=1)
    k = jnp.argmin(cost, axis=1)
    qoffs = jnp.asarray(_QOFFS, jnp.int32)
    mv4 = 4 * mv_int + qoffs[k]
    return mv4, jnp.take_along_axis(satd, k[:, None], axis=1)[:, 0]


def _frac_refine_any(suball, blocks, ys, xs, mv4_cur, uref, anchor4,
                     lam_sqrt, s: int):
    """Like _frac_refine but with a PER-BLOCK reference index (gathers
    from the stacked all-ref phase planes) and a q-pel starting MV.
    blocks may be a 14-bit-ish bi target (2*orig - other_pred); anchor4
    is the per-block q-pel MVD pricing anchor.  Returns (mv4, satd)."""
    M = MARGIN
    mv_int = mv4_cur >> 2                       # floor toward -inf

    def one(y, x, mv, r):
        return jax.lax.dynamic_slice(
            suball, (r * 16, y + mv[0] - 1 + M, x + mv[1] - 1 + M),
            (16, s + 2, s + 2))

    wins = jax.vmap(one)(ys, xs, mv_int, uref)   # (N, 16, s+2, s+2)
    preds, bits = [], []
    for (qy, qx) in _QOFFS:
        ph = (qy & 3) * 4 + (qx & 3)
        oy = 1 + (qy >> 2)
        ox = 1 + (qx >> 2)
        preds.append(wins[:, ph, oy:oy + s, ox:ox + s])
        mv4y = 4 * mv_int[:, 0] + qy
        mv4x = 4 * mv_int[:, 1] + qx
        bits.append(_mvd_bits_j(mv4x - anchor4[:, 1],
                                mv4y - anchor4[:, 0]))
    pred = jnp.stack(preds, axis=1).astype(jnp.int32)
    satd = analysis.batched_satd(
        blocks[:, None] - pred).astype(jnp.float32)
    cost = satd + lam_sqrt * jnp.stack(bits, axis=1)
    k = jnp.argmin(cost, axis=1)
    qoffs = jnp.asarray(_QOFFS, jnp.int32)
    mv4 = 4 * mv_int + qoffs[k]
    return mv4, jnp.take_along_axis(satd, k[:, None], axis=1)[:, 0]


# ---------------------------------------------------------------------------
# the fused frame program
# ---------------------------------------------------------------------------

SIZES = (8, 16, 32, 64)
KIND_MERGE, KIND_UNI0, KIND_UNI1, KIND_BI = 0, 1, 2, 3


@partial(jax.jit,
         static_argnames=("h", "w", "bd", "is_b", "nmerge", "parts",
                          "has_me"))
def _plan_device(cur, refs, mvn16, dists, lam, lam_sqrt, qp, map0, map1,
                 nref0, nref1, me=None, *, h: int, w: int, bd: int,
                 is_b: bool, nmerge: int, parts: bool = True,
                 has_me: bool = False):
    """One device dispatch deciding the whole inter frame (see module
    docstring).  cur: (h, w) int32; refs: (R, h, w) int32 deduplicated
    reference planes PADDED to a fixed R (so every GOP hierarchy level
    reuses ONE compiled program per slice kind instead of respecializing
    on the ref-list shape); map0/map1: (MAXREF,) int32 device arrays of
    indices into refs with nref0/nref1 live entries; mvn16:
    (h//8, w//8, 2) int32 POC-normalized motion prior (q-pel x16 per POC
    unit, (dy, dx)); dists: (R,) int32 SIGNED POC distance cur - ref of
    each unique reference, so the prior scales per ref like TMVP does
    (an L1 ref in the future gets the opposite sign automatically).
    Returns a packed (16, h4, w4) int16 plan tensor."""
    lamf = lam.astype(jnp.float32)
    lams = lam_sqrt.astype(jnp.float32)
    # per-ref full-pel prior (dy, dx): mvn16 is q-pel*16/poc, so full-pel
    # at distance d is mvn16*d/64; clamp inside the subpel-plane margin
    mv_cap = MARGIN - REFINE_R - 8
    mvp_full = jnp.clip(jnp.rint(
        mvn16[None].astype(jnp.float32) *
        dists[:, None, None, None].astype(jnp.float32) / 64.0
    ).astype(jnp.int32), -mv_cap, mv_cap)        # (R, h8, w8, 2)
    if has_me:
        # integer-ME grids precomputed outside (row-sharded over a mesh
        # by parallel.plan_shard; bit-identical to the in-program path)
        mv_int, mv_rect = me
    else:
        mv_int, mv_rect = _int_me_grids(cur, refs, mvp_full, lams, h, w,
                                        parts)
    sub = _subpel_planes(refs, bd, h, w)
    R = refs.shape[0]
    suball = sub.reshape((R * 16,) + sub.shape[2:])
    lists = [(map0, nref0), (map1, nref1)] if is_b else [(map0, nref0)]

    per_size = {}
    for s in SIZES:
        ny, nx = h // s, w // s
        if ny == 0 or nx == 0:
            per_size[s] = None
            continue
        N = ny * nx
        ys = jnp.repeat(jnp.arange(ny) * s, nx)
        xs = jnp.tile(jnp.arange(nx) * s, ny)
        blocks = cur[: ny * s, : nx * s].reshape(ny, s, nx, s) \
            .swapaxes(1, 2).reshape(N, s, s).astype(jnp.int32)
        step = s // 8
        pred4_all = 4 * mvp_full[:, ::step, ::step][:, :ny, :nx] \
            .reshape(R, N, 2)                             # per-ref q-pel

        # refined quarter MV + SATD per unique reference (lax.map: one
        # traced body for all R refs instead of an unrolled chain)
        def _fr_sq(args):
            sub_r, mv0, p4 = args
            return _frac_refine(sub_r, blocks, ys, xs, mv0, p4, lams, s)

        mvq_all, satd_all = jax.lax.map(
            _fr_sq, (sub, mv_int[s].reshape(R, N, 2), pred4_all))

        # per-list best reference (SATD + MVD/ref/dir bins); the list
        # mapping is a dynamic gather with an nref mask so one compiled
        # program serves every DPB/ref-list shape
        uni = {}
        for lx, (lmap_v, nref_v) in enumerate(lists):
            mr = lmap_v.shape[0]
            mv_sel = jnp.take(mvq_all, lmap_v, axis=0)    # (mr, N, 2)
            satd_sel = jnp.take(satd_all, lmap_v, axis=0)  # (mr, N)
            pred4_sel = jnp.take(pred4_all, lmap_v, axis=0)
            mb = _mvd_bits_j(mv_sel[:, :, 1] - pred4_sel[:, :, 1],
                             mv_sel[:, :, 0] - pred4_sel[:, :, 0])
            ri = jnp.arange(mr)
            rb = jnp.where(nref_v > 1,
                           jnp.minimum(ri + 1, nref_v - 1), 0) \
                .astype(jnp.float32)
            bits_l = mb + rb[:, None] + UNI_BASE_BITS     # (mr, N)
            costs = satd_sel + lams * bits_l
            costs = jnp.where((ri < nref_v)[:, None], costs, jnp.inf)
            k = jnp.argmin(costs, axis=0)                 # (N,)
            uni[lx] = {
                "ridx": k.astype(jnp.int32),
                "uref": lmap_v[k],
                "mv": jnp.take_along_axis(
                    mv_sel, k[None, :, None], axis=0)[0],
                "satd": jnp.take_along_axis(satd_sel, k[None], axis=0)[0],
                "bits": jnp.take_along_axis(bits_l, k[None], axis=0)[0],
                "cost": jnp.min(costs, axis=0),
                # MVD pricing anchor + ref bits of the selected entry
                # (the bi refinement re-prices refined MVs against these)
                "anchor": jnp.take_along_axis(
                    pred4_sel, k[None, :, None], axis=0)[0],
                "rbits": rb[k],
            }

        # per-block predicted blocks for the per-list winners (for bi and
        # the residual trial) — one phase-plane gather per block
        def pred_of(entry):
            return _gather_pred(suball, ys, xs, entry["mv"],
                                entry["uref"], s)

        for lx in uni:
            uni[lx]["pred"] = pred_of(uni[lx])

        cand_costs = []          # per kind: (cost, bits, pred)
        kinds_meta = {}

        # ---- merge candidates (approx list mirroring the A1/B1/B0/A0
        # spatial order + TMVP + zero; the commit pass still maps onto
        # the EXACT list, but a closer plan-side list keeps the quadtree
        # DP honest about merge-heavy regions, TComDataCU.cpp:2309) ----
        def roll2(a, dy_, dx_):
            g = a.reshape((ny, nx) + a.shape[1:])
            if dy_:
                g = jnp.roll(g, dy_, axis=0)
            if dx_:
                g = jnp.roll(g, dx_, axis=1)
            return g.reshape(a.shape)

        ii = jnp.repeat(jnp.arange(ny), nx)
        jj = jnp.tile(jnp.arange(nx), ny)

        def edge_mask(dy_, dx_):
            m = jnp.zeros((N,), bool)
            if dy_ > 0:
                m |= ii == 0
            if dy_ < 0:
                m |= ii == ny - 1
            if dx_ > 0:
                m |= jj == 0
            if dx_ < 0:
                m |= jj == nx - 1
            return m                                     # (N,) True=invalid

        zero_mv = jnp.zeros((N, 2), jnp.int32)
        mcands = []                                       # per candidate
        # B slices carry the full A1/B1/B0/A0 mirror set (merge-heavy
        # hierarchy levels need the diversity); P slices measured BETTER
        # with the tight left/above pair (the extra approximate
        # candidates bias the quadtree toward mispriced merges)
        rolls = ((0, 1), (1, 0), (1, -1), (-1, 1)) if is_b else \
            ((0, 1), (1, 0))
        for dy_, dx_ in rolls:
            ent = {}
            for lx in uni:
                ent[lx] = {
                    "mv": roll2(uni[lx]["mv"], dy_, dx_),
                    "uref": roll2(uni[lx]["uref"], dy_, dx_),
                    "ridx": roll2(uni[lx]["ridx"], dy_, dx_),
                }
            ent["invalid"] = edge_mask(dy_, dx_)
            mcands.append(ent)
        for use_prior in (True, False):
            # TMVP-like candidate: the prior scaled to EACH list's first
            # reference (opposite POC directions get opposite signs, as
            # the real TMVP scaling produces); then the zero-MV pair
            ent = {}
            for lx in uni:
                lmap_v = lists[lx][0]
                ent[lx] = {
                    "mv": jnp.take(pred4_all, lmap_v[0], axis=0)
                    if use_prior else zero_mv,
                    "uref": jnp.broadcast_to(lmap_v[0], (N,)),
                    "ridx": jnp.zeros((N,), jnp.int32),
                }
            ent["invalid"] = jnp.zeros((N,), bool)
            mcands.append(ent)

        m_best = None
        for m_idx, ent in enumerate(mcands):
            preds = []
            for lx in uni:
                preds.append(pred_of(ent[lx]))
            if len(preds) == 2:
                pred = (preds[0] + preds[1] + 1) >> 1
                dirv = 3
            else:
                pred = preds[0]
                dirv = 1 if 0 in uni else 2
            satd = analysis.batched_satd(blocks - pred).astype(jnp.float32)
            bits = float(min(m_idx + 1, nmerge - 1) + 1) + MERGE_FLAG_BITS
            cost = satd + lams * bits + \
                jnp.where(ent["invalid"], jnp.inf, 0.0)
            rec = {"cost": cost, "bits": bits, "pred": pred, "ent": ent,
                   "dir": dirv, "idx": m_idx}
            if m_best is None:
                m_best = {k: (v if k in ("bits", "dir") else v)
                          for k, v in rec.items()}
                m_best["sel"] = jnp.full((N,), m_idx, jnp.int32)
                m_best["bits"] = jnp.full((N,), rec["bits"], jnp.float32)
            else:
                better = cost < m_best["cost"]
                m_best["cost"] = jnp.where(better, cost, m_best["cost"])
                m_best["pred"] = jnp.where(better[:, None, None], pred,
                                           m_best["pred"])
                m_best["sel"] = jnp.where(better, m_idx, m_best["sel"])
                m_best["bits"] = jnp.where(better, rec["bits"],
                                           m_best["bits"])
        # gather merged motion channels by selected source
        def msel(field, lx):
            opts = jnp.stack([e[lx][field] for e in mcands])  # (4, N, ...)
            idx = m_best["sel"]
            if opts.ndim == 3:
                return jnp.take_along_axis(
                    opts, idx[None, :, None], axis=0)[0]
            return jnp.take_along_axis(opts, idx[None], axis=0)[0]

        merge_mv = {lx: msel("mv", lx) for lx in uni}
        merge_ridx = {lx: msel("ridx", lx) for lx in uni}
        merge_dir = 3 if len(uni) == 2 else (1 if 0 in uni else 2)

        # ---- bi-prediction: per-list-winner average, then an iterative
        # two-pass refinement against the bi target (TEncSearch.cpp:3260
        # xMotionEstimation's iterative bi loop).  The refinement finds a
        # SECOND MV on the same reference in the GPB case, which is how
        # HM's anchors win on zoom/divergent motion. ----
        bi = None
        if len(uni) == 2:
            pred = (uni[0]["pred"] + uni[1]["pred"] + 1) >> 1
            satd = analysis.batched_satd(blocks - pred).astype(jnp.float32)
            bits = uni[0]["bits"] + uni[1]["bits"] + \
                (BI_BASE_BITS - 2 * UNI_BASE_BITS)
            cost = satd + lams * bits
            # pass 1: refine list1 against 2*orig - pred0
            tgt1 = 2 * blocks - uni[0]["pred"]
            mv1b, _ = _frac_refine_any(
                suball, tgt1, ys, xs, uni[1]["mv"], uni[1]["uref"],
                uni[1]["anchor"], lams, s)
            pred1b = _gather_pred(suball, ys, xs, mv1b,
                                  uni[1]["uref"], s)
            # pass 2: refine list0 against 2*orig - pred1'
            tgt0 = 2 * blocks - pred1b
            mv0b, _ = _frac_refine_any(
                suball, tgt0, ys, xs, uni[0]["mv"], uni[0]["uref"],
                uni[0]["anchor"], lams, s)
            pred0b = _gather_pred(suball, ys, xs, mv0b,
                                  uni[0]["uref"], s)
            pred_it = (pred0b + pred1b + 1) >> 1
            satd_it = analysis.batched_satd(
                blocks - pred_it).astype(jnp.float32)
            mb_it = _mvd_bits_j(mv0b[:, 1] - uni[0]["anchor"][:, 1],
                                mv0b[:, 0] - uni[0]["anchor"][:, 0]) + \
                _mvd_bits_j(mv1b[:, 1] - uni[1]["anchor"][:, 1],
                            mv1b[:, 0] - uni[1]["anchor"][:, 0])
            bits_it = mb_it + uni[0]["rbits"] + uni[1]["rbits"] + \
                BI_BASE_BITS
            cost_it = satd_it + lams * bits_it
            it_wins = cost_it < cost
            bi = {
                "cost": jnp.where(it_wins, cost_it, cost),
                "bits": jnp.where(it_wins, bits_it, bits),
                "pred": jnp.where(it_wins[:, None, None], pred_it, pred),
                "mv0": jnp.where(it_wins[:, None], mv0b, uni[0]["mv"]),
                "mv1": jnp.where(it_wins[:, None], mv1b, uni[1]["mv"]),
            }

        # ---- kind selection (SATD domain) ----
        kind_list = [(KIND_MERGE, m_best["cost"], m_best["bits"],
                      m_best["pred"])]
        if 0 in uni:
            kind_list.append((KIND_UNI0, uni[0]["cost"], uni[0]["bits"],
                              uni[0]["pred"]))
        if 1 in uni:
            kind_list.append((KIND_UNI1, uni[1]["cost"], uni[1]["bits"],
                              uni[1]["pred"]))
        if bi is not None:
            kind_list.append((KIND_BI, bi["cost"], bi["bits"], bi["pred"]))
        costs = jnp.stack([c for _, c, _, _ in kind_list])
        ksel = jnp.argmin(costs, axis=0)                  # (N,) index into list
        kind = jnp.asarray([k for k, _, _, _ in kind_list],
                           jnp.int32)[ksel]
        bits_motion = jnp.take_along_axis(
            jnp.stack([jnp.broadcast_to(b, (N,)).astype(jnp.float32)
                       for _, _, b, _ in kind_list]), ksel[None], axis=0)[0]
        pred_best = jnp.take_along_axis(
            jnp.stack([p for _, _, _, p in kind_list]),
            ksel[None, :, None, None], axis=0)[0]

        # final motion channels by kind
        def pick(kidx, merge_v, uni0_v, uni1_v, default):
            k = kind[:, None] if jnp.ndim(default) == 2 else kind
            out = default
            out = jnp.where(k == KIND_MERGE, merge_v, out)
            out = jnp.where(k == KIND_UNI0, uni0_v, out)
            out = jnp.where(k == KIND_UNI1, uni1_v, out)
            return out

        zero2 = jnp.zeros((N, 2), jnp.int32)
        zeroN = jnp.zeros((N,), jnp.int32)
        negN = jnp.full((N,), -1, jnp.int32)
        u0mv = uni[0]["mv"] if 0 in uni else zero2
        u1mv = uni[1]["mv"] if 1 in uni else zero2
        u0r = uni[0]["ridx"] if 0 in uni else zeroN
        u1r = uni[1]["ridx"] if 1 in uni else zeroN
        m0mv = merge_mv.get(0, zero2)
        m1mv = merge_mv.get(1, zero2)
        m0r = merge_ridx.get(0, zeroN)
        m1r = merge_ridx.get(1, zeroN)
        bi_valid = bi is not None
        mv0 = pick(kind, m0mv, u0mv, zero2,
                   bi["mv0"] if bi_valid else zero2)
        mv1 = pick(kind, m1mv, zero2, u1mv,
                   bi["mv1"] if bi_valid else zero2)
        ref0 = pick(kind, jnp.where(merge_dir & 1, m0r, negN),
                    u0r, negN, u0r if bi_valid else negN)
        ref1 = pick(kind, jnp.where(merge_dir & 2, m1r, negN),
                    negN, u1r, u1r if bi_valid else negN)
        dirv = pick(kind, jnp.full((N,), merge_dir, jnp.int32),
                    jnp.full((N,), 1, jnp.int32),
                    jnp.full((N,), 2, jnp.int32),
                    jnp.full((N,), 3, jnp.int32))

        # ---- residual trial (SSE domain) ----
        def _trial(pred_b):
            """fwd DCT + quant + bit estimate + recon SSE for one CU-size
            prediction; returns (sse_rec, bits_r, sse_zero)."""
            resi = blocks - pred_b
            if s <= 32:
                log2_tr = s.bit_length() - 1
                fwd = analysis.batched_fwd_transform(resi, bd, False)
                lvl = _quant_t(fwd, qp, bd, log2_tr)
                br = _bits_estimate(lvl)
                deq = _dequant_t(lvl, qp, bd, log2_tr)
                rres = batched_inv_transform(deq, bd, False)
            else:
                tu = resi.reshape(N, 2, 32, 2, 32).swapaxes(2, 3) \
                    .reshape(N * 4, 32, 32)
                fwd = analysis.batched_fwd_transform(tu, bd, False)
                lvl = _quant_t(fwd, qp, bd, 5)
                br = _bits_estimate(lvl).reshape(N, 4).sum(axis=1)
                deq = _dequant_t(lvl, qp, bd, 5)
                rres = batched_inv_transform(deq, bd, False) \
                    .reshape(N, 2, 2, 32, 32).swapaxes(2, 3) \
                    .reshape(N, 64, 64)
            rec = jnp.clip(pred_b + rres, 0, (1 << bd) - 1)
            d = (blocks - rec)
            sr = (d * d).sum(axis=(-1, -2)).astype(jnp.float32)
            pz = jnp.clip(pred_b, 0, (1 << bd) - 1)
            dz = (blocks - pz)
            sz = (dz * dz).sum(axis=(-1, -2)).astype(jnp.float32)
            return sr, br, sz

        sse_rec, bits_r, sse_zero = _trial(pred_best)
        cost_coded = sse_rec + lamf * (bits_r + bits_motion + 2.0)
        is_merge = (kind == KIND_MERGE)
        bits_zero = bits_motion + jnp.where(is_merge, 0.0, 1.0) \
            - jnp.where(is_merge, MERGE_FLAG_BITS - SKIP_EXTRA_BITS, 0.0)
        cost_zero = sse_zero + lamf * bits_zero
        skip_hint = cost_zero <= cost_coded
        inter_cost = jnp.minimum(cost_coded, cost_zero)

        # ---- rect partitions 2NxN / Nx2N: per-PU uni pricing on the
        # rect-shape ME + a residual trial per shape, competing with the
        # 2Nx2N cost in the same SSE domain (TEncCu.cpp:702-812 tests
        # part modes as siblings; the commit pass may still re-map each
        # planned PU to an exact merge candidate) ----
        zeroN = jnp.zeros((N,), jnp.int32)
        part_ch = zeroN
        pu_ch = {f: zeroN for f in (
            "p0dir", "p0mvy", "p0mvx", "p0ref",
            "p1dir", "p1mvy", "p1mvx", "p1ref")}
        if (s, 1) in mv_rect:
            shapes = []
            for part in (1, 2):
                bh = s // 2 if part == 1 else s
                bw = s if part == 1 else s // 2
                mvr = mv_rect[(s, part)]
                Ny, Nx = mvr.shape[1], mvr.shape[2]
                Np = Ny * Nx
                pys = jnp.repeat(jnp.arange(Ny) * bh, Nx)
                pxs = jnp.tile(jnp.arange(Nx) * bw, Ny)
                pu_blocks = cur[: Ny * bh, : Nx * bw] \
                    .reshape(Ny, bh, Nx, bw).swapaxes(1, 2) \
                    .reshape(Np, bh, bw).astype(jnp.int32)
                ppred4 = 4 * mvp_full[:, ::bh // 8, ::bw // 8][:, :Ny, :Nx] \
                    .reshape(R, Np, 2)
                def _fr_pu(args, _bh=bh, _bw=bw, _pys=pys, _pxs=pxs,
                           _blocks=pu_blocks):
                    sub_r, mv0, p4 = args
                    return _frac_refine(sub_r, _blocks, _pys, _pxs, mv0,
                                        p4, lams, _bh, _bw)

                mvq_all_p, satd_all_p = jax.lax.map(
                    _fr_pu, (sub, mvr.reshape(R, Np, 2), ppred4))
                lsel = []
                for lx, (lmap_v, nref_v) in enumerate(lists):
                    mr = lmap_v.shape[0]
                    mv_sel = jnp.take(mvq_all_p, lmap_v, axis=0)
                    satd_sel = jnp.take(satd_all_p, lmap_v, axis=0)
                    p4_sel = jnp.take(ppred4, lmap_v, axis=0)
                    mb = _mvd_bits_j(mv_sel[:, :, 1] - p4_sel[:, :, 1],
                                     mv_sel[:, :, 0] - p4_sel[:, :, 0])
                    ri = jnp.arange(mr)
                    rb = jnp.where(nref_v > 1,
                                   jnp.minimum(ri + 1, nref_v - 1), 0) \
                        .astype(jnp.float32)
                    bits_l = mb + rb[:, None] + UNI_BASE_BITS
                    costs = satd_sel + lams * bits_l
                    costs = jnp.where((ri < nref_v)[:, None], costs,
                                      jnp.inf)
                    k = jnp.argmin(costs, axis=0)
                    lsel.append({
                        "cost": jnp.min(costs, axis=0),
                        "bits": jnp.take_along_axis(
                            bits_l, k[None], axis=0)[0],
                        "mv": jnp.take_along_axis(
                            mv_sel, k[None, :, None], axis=0)[0],
                        "uref": lmap_v[k],
                        "ridx": k.astype(jnp.int32),
                    })
                if len(lsel) == 2:
                    use1 = lsel[1]["cost"] < lsel[0]["cost"]
                    pu_cost = jnp.minimum(lsel[0]["cost"],
                                          lsel[1]["cost"])
                    pu_bits = jnp.where(use1, lsel[1]["bits"],
                                        lsel[0]["bits"])
                    pu_mv = jnp.where(use1[:, None], lsel[1]["mv"],
                                      lsel[0]["mv"])
                    pu_uref = jnp.where(use1, lsel[1]["uref"],
                                        lsel[0]["uref"])
                    pu_ridx = jnp.where(use1, lsel[1]["ridx"],
                                        lsel[0]["ridx"])
                    pu_dir = jnp.where(use1, 2, 1).astype(jnp.int32)
                else:
                    e = lsel[0]
                    pu_cost, pu_bits = e["cost"], e["bits"]
                    pu_mv, pu_uref, pu_ridx = e["mv"], e["uref"], e["ridx"]
                    pu_dir = jnp.ones((Np,), jnp.int32)
                pred_pu = _gather_pred(suball, pys, pxs, pu_mv, pu_uref,
                                       bh, bw)
                if part == 1:
                    A = pred_pu.reshape(ny, 2, nx, bh, bw)
                    predc = jnp.concatenate([A[:, 0], A[:, 1]], axis=-2)
                else:
                    A = pred_pu.reshape(ny, nx, 2, bh, bw)
                    predc = jnp.concatenate([A[:, :, 0], A[:, :, 1]],
                                            axis=-1)
                predc = predc.reshape(N, s, s)

                def cu_split(a, _part=part):
                    if _part == 1:
                        g = a.reshape((ny, 2, nx) + a.shape[1:])
                        return (g[:, 0].reshape((N,) + a.shape[1:]),
                                g[:, 1].reshape((N,) + a.shape[1:]))
                    g = a.reshape((ny, nx, 2) + a.shape[1:])
                    return (g[:, :, 0].reshape((N,) + a.shape[1:]),
                            g[:, :, 1].reshape((N,) + a.shape[1:]))

                bits0, bits1 = cu_split(pu_bits)
                bits_cu = bits0 + bits1 + RECT_PART_BITS
                sr, br, sz = _trial(predc)
                cost_r = jnp.minimum(
                    sr + lamf * (br + bits_cu + 2.0),
                    sz + lamf * (bits_cu + 1.0))
                dir0, dir1 = cu_split(pu_dir)
                mv0p, mv1p = cu_split(pu_mv)
                r0p, r1p = cu_split(pu_ridx)
                shapes.append({
                    "part": part, "cost": cost_r,
                    "p0dir": dir0, "p0mvy": mv0p[:, 0],
                    "p0mvx": mv0p[:, 1], "p0ref": r0p,
                    "p1dir": dir1, "p1mvy": mv1p[:, 0],
                    "p1mvx": mv1p[:, 1], "p1ref": r1p,
                })
            a, b = shapes
            use_b = b["cost"] < a["cost"]
            rect_cost = jnp.minimum(a["cost"], b["cost"])
            rect_better = rect_cost < inter_cost
            part_ch = jnp.where(rect_better,
                                jnp.where(use_b, 2, 1), 0)
            for f in pu_ch:
                pu_ch[f] = jnp.where(use_b, b[f], a[f])
            inter_cost = jnp.minimum(inter_cost, rect_cost)

        # ---- intra alternative (8/16/32 luma) ----
        intra_flag = jnp.zeros((N,), bool)
        imode = jnp.zeros((N,), jnp.int32)
        icands = jnp.zeros((N, 3), jnp.int32)
        if s <= 32:
            bufs, iblocks = _jnp_ref_buffers(cur, s, bd, True, h, w)
            im, icost, ic3 = _intra_size_rd_t(
                bufs, iblocks, lamf, s, bd, min(NUM_RD_CANDS[s], 3), qp)
            icost = icost + lamf * INTRA_EXTRA_BITS
            intra_flag = icost < inter_cost
            imode = im
            icands = ic3
            cu_cost = jnp.minimum(inter_cost, icost)
        else:
            cu_cost = inter_cost

        per_size[s] = {
            "cost": cu_cost.reshape(ny, nx),
            "kind": kind, "dir": dirv, "mv0": mv0, "mv1": mv1,
            "ref0": ref0, "ref1": ref1, "msrc": m_best["sel"],
            "skip": skip_hint, "intra": intra_flag, "imode": imode,
            "icands": icands, "ny": ny, "nx": nx,
            "part": part_ch, **pu_ch,
        }

    return _emit_plan(per_size, lamf, h, w)


def _intra_size_rd_t(bufs, blocks, lamf, s: int, bd: int, k: int, qp):
    """Traced-QP twin of intra_rd._size_rd (reduced: no satd export)."""
    preds = analysis.predict_all_modes(bufs, s, True, bd)
    diffs = preds.astype(jnp.int32) - blocks[:, None].astype(jnp.int32)
    satd = analysis.batched_satd(diffs)
    topk = _topk_argmin(satd.astype(jnp.float32), k)
    cand = jnp.take_along_axis(preds, topk[:, :, None, None], axis=1)
    resi = blocks[:, None].astype(jnp.int32) - cand
    log2 = s.bit_length() - 1
    fwd = analysis.batched_fwd_transform(resi, bd, s == 4)
    # intra rounding offset (171) — _quant_t uses the inter offset; the
    # delta is a sub-LSB rounding difference acceptable for ranking
    lvl = _quant_t(fwd, qp, bd, log2)
    deq = _dequant_t(lvl, qp, bd, log2)
    rres = batched_inv_transform(deq, bd, s == 4)
    rec = jnp.clip(cand + rres, 0, (1 << bd) - 1)
    d = blocks[:, None] - rec
    dist = (d * d).sum(axis=(-1, -2)).astype(jnp.float32)
    bits = _bits_estimate(lvl) + 6.0
    cost = dist + lamf * bits
    rd_order = _topk_argmin(cost, 3)
    top3 = jnp.take_along_axis(topk, rd_order, axis=1)
    best_cost = jnp.take_along_axis(cost, rd_order[:, :1], axis=1)[:, 0]
    return top3[:, 0], best_cost, top3


# ---------------------------------------------------------------------------
# quadtree DP + dense emission
# ---------------------------------------------------------------------------

def _emit_plan(per_size, lamf, h: int, w: int):
    h4, w4 = h // 4, w // 4
    shape_s = {s: (h // s, w // s) for s in SIZES}

    cost = {s: (per_size[s]["cost"] if per_size[s] is not None
                else jnp.zeros(shape_s[s], jnp.float32)) for s in SIZES}
    cu8 = cost[8]
    nby16, nbx16 = shape_s[16]
    cu16 = cost[16]
    split16 = jnp.zeros((nby16, nbx16), bool)
    if nby16 and cu8.size:
        quad = _quad(cu8)[:nby16, :nbx16] + lamf * SPLIT_BITS
        split16 = quad < cu16
        cu16 = jnp.minimum(cu16, quad)
    nby32, nbx32 = shape_s[32]
    cu32 = cost[32]
    split32 = jnp.zeros((nby32, nbx32), bool)
    if nby32 and cu16.size:
        quad = _quad(cu16)[:nby32, :nbx32] + lamf * SPLIT_BITS
        split32 = quad < cu32
        cu32 = jnp.minimum(cu32, quad)
    nby64, nbx64 = shape_s[64]
    cu64 = cost[64]
    split64 = jnp.zeros((nby64, nbx64), bool)
    if nby64 and cu32.size:
        quad = _quad(cu32)[:nby64, :nbx64] + lamf * SPLIT_BITS
        split64 = quad < cu64

    leaf64 = ~split64
    desc64 = split64
    r32 = np.arange(nby32)[:, None]
    c32 = np.arange(nbx32)[None, :]
    border32 = jnp.asarray((r32 >= 2 * nby64) | (c32 >= 2 * nbx64))
    active32 = _pad_to(_up(desc64, 2), nby32, nbx32, False) | border32
    leaf32 = active32 & ~split32
    desc32 = active32 & split32
    r16 = np.arange(nby16)[:, None]
    c16 = np.arange(nbx16)[None, :]
    border16 = jnp.asarray((r16 >= 2 * nby32) | (c16 >= 2 * nbx32))
    active16 = _pad_to(_up(desc32, 2), nby16, nbx16, False) | border16
    leaf16 = active16 & ~split16
    desc16 = active16 & split16
    nby8, nbx8 = shape_s[8]
    r8 = np.arange(nby8)[:, None]
    c8 = np.arange(nbx8)[None, :]
    border8 = jnp.asarray((r8 >= 2 * nby16) | (c8 >= 2 * nbx16))
    leaf8 = _pad_to(_up(desc16, 2), nby8, nbx8, False) | border8

    m64 = _pad_to(_up(leaf64, 16), h4, w4, False)
    m32 = _pad_to(_up(leaf32, 8), h4, w4, False)
    m16 = _pad_to(_up(leaf16, 4), h4, w4, False)
    m8 = _pad_to(_up(leaf8, 2), h4, w4, False)

    neg = jnp.full((h4, w4), -1, jnp.int32)
    depth = jnp.where(m64, 0, jnp.where(m32, 1, jnp.where(
        m16, 2, jnp.where(m8, 3, neg))))
    cov = m64 | m32 | m16 | m8

    def chan(field, default, signed=True):
        out = jnp.full((h4, w4), default, jnp.int32)
        for s, m_, f in ((64, m64, 16), (32, m32, 8), (16, m16, 4),
                         (8, m8, 2)):
            ps = per_size[s]
            if ps is None:
                continue
            v = ps.get(field)
            if v is None:
                continue
            if v.ndim == 1:
                g = v.reshape(ps["ny"], ps["nx"]).astype(jnp.int32)
            else:
                g = v.astype(jnp.int32)
            gu = _pad_to(_up(g, f), h4, w4, default)
            out = jnp.where(m_, gu, out)
        return out

    def chan_mv(field, comp):
        out = jnp.zeros((h4, w4), jnp.int32)
        for s, m_, f in ((64, m64, 16), (32, m32, 8), (16, m16, 4),
                         (8, m8, 2)):
            ps = per_size[s]
            if ps is None:
                continue
            g = ps[field][:, comp].reshape(ps["ny"], ps["nx"]) \
                .astype(jnp.int32)
            out = jnp.where(m_, _pad_to(_up(g, f), h4, w4, 0), out)
        return out

    def chan_cand(i):
        out = jnp.full((h4, w4), -1, jnp.int32)
        for s, m_, f in ((32, m32, 8), (16, m16, 4), (8, m8, 2)):
            ps = per_size[s]
            if ps is None:
                continue
            g = ps["icands"][:, i].reshape(ps["ny"], ps["nx"]) \
                .astype(jnp.int32)
            out = jnp.where(m_, _pad_to(_up(g, f), h4, w4, -1), out)
        return out

    kind = chan("kind", 0)
    msrc = chan("msrc", 0)
    dirv = chan("dir", 1)
    skip = chan("skip", 0)
    intra = chan("intra", 0)
    if per_size[64] is not None:
        # 64x64 CUs have no intra alternative in the plan
        intra = jnp.where(m64, 0, intra)
    imode = chan("imode", 0)
    mv0x = chan_mv("mv0", 1)
    mv0y = chan_mv("mv0", 0)
    mv1x = chan_mv("mv1", 1)
    mv1y = chan_mv("mv1", 0)
    ref0 = chan("ref0", -1)
    ref1 = chan("ref1", -1)
    c0, c1, c2 = chan_cand(0), chan_cand(1), chan_cand(2)
    part = chan("part", 0)
    pu = [chan(f, 0) for f in ("p0dir", "p0mvy", "p0mvx", "p0ref",
                               "p1dir", "p1mvy", "p1mvx", "p1ref")]

    flags = (cov.astype(jnp.int32) | (intra << 1) | (skip << 2))
    return jnp.stack([
        depth, flags, kind, msrc, dirv, mv0x, mv0y, mv1x, mv1y,
        ref0, ref1, imode, c0, c1, c2, part, *pu,
    ]).astype(jnp.int16)


# ---------------------------------------------------------------------------
# host interface
# ---------------------------------------------------------------------------

class InterPlan:
    """Dense frame plan for a P/B frame.  Field names shared with
    intra_rd.IntraPlan so the intra commit path works unchanged on the
    plan's intra CUs."""

    __slots__ = ("depth", "nxn", "mode", "cov", "tusplit", "cmode",
                 "cands", "h4", "w4", "is_inter_plan", "pred_inter",
                 "skip_hint", "kind", "msrc", "dir", "mv", "ref",
                 "part", "pu")

    def __init__(self, h4, w4):
        self.h4, self.w4 = h4, w4
        self.is_inter_plan = True


def fetch_plan(packed, h, w):
    p = np.asarray(packed).astype(np.int32)
    h4, w4 = h // 4, w // 4
    plan = InterPlan(h4, w4)
    plan.depth = p[0].astype(np.int8)
    flags = p[1]
    plan.cov = (flags & 1) != 0
    plan.pred_inter = ((flags & 2) == 0) & plan.cov
    plan.skip_hint = (flags & 4) != 0
    plan.kind = p[2].astype(np.int8)
    plan.msrc = p[3].astype(np.int8)
    plan.dir = p[4].astype(np.int8)
    plan.mv = np.stack([np.stack([p[5], p[6]], axis=-1),
                        np.stack([p[7], p[8]], axis=-1)]).astype(np.int32)
    plan.ref = np.stack([p[9], p[10]]).astype(np.int8)
    plan.mode = p[11].astype(np.int8)
    plan.cands = np.stack([p[12], p[13], p[14]], axis=-1).astype(np.int8)
    plan.part = p[15].astype(np.int8)
    # pu[pu_idx] = (dir, mvy, mvx, ref) per planned rect PU
    plan.pu = np.stack([p[16:20], p[20:24]]).astype(np.int32)
    plan.nxn = np.zeros((h4, w4), dtype=bool)
    plan.tusplit = np.zeros((h4, w4), dtype=bool)
    plan.cmode = np.full((h4, w4), 4, dtype=np.int8)
    return plan


_REF_CACHE: dict = {}     # id(plane) -> (weakref(plane), device array)


def _device_ref(plane, h, w, device):
    """Device-resident copy of a reference plane, cached across frames.

    References live in the DPB for many pictures; re-uploading every
    ref every frame dominates the 1080p plan wall-time over the host
    link.  Keyed by object identity with a weakref guard (a recycled id
    after gc cannot alias a new plane).  Evicts LRU beyond 24 entries.
    WP-weighted planes are NOT cached (the caller passes derived arrays
    it just built; identity has no reuse)."""
    import weakref
    key = id(plane)
    ent = _REF_CACHE.get(key)
    if ent is not None:
        ref_w, arr = ent
        if ref_w() is plane and arr.shape == (h, w) \
                and device in arr.devices():
            _REF_CACHE[key] = _REF_CACHE.pop(key)   # LRU bump
            return arr
        del _REF_CACHE[key]
    import jax
    with jax.default_device(device):
        arr = jnp.asarray(plane[:h, :w], jnp.int32)
    try:
        ref_w = weakref.ref(plane)
    except TypeError:
        return arr                                  # uncacheable type
    _REF_CACHE[key] = (ref_w, arr)
    while len(_REF_CACHE) > 24:
        _REF_CACHE.pop(next(iter(_REF_CACHE)))
    return arr


def zero_inputs(h, w, bd, is_b, qp=32):
    """(args, kwargs) of `_plan_device` for an all-zero frame at one
    geometry, as plan_frame passes them (in-program ME): for lowering or
    compiling the program without an encode."""
    r = MAXREF_PLAN
    z = jnp.zeros((r,), jnp.int32)
    args = (jnp.zeros((h, w), jnp.int32), jnp.zeros((r, h, w), jnp.int32),
            jnp.zeros((h // 8, w // 8, 2), jnp.int32),
            jnp.ones((r,), jnp.int32), jnp.float32(50.0), jnp.float32(7.0),
            jnp.int32(qp + 6 * (bd - 8)), z, z, jnp.int32(1),
            jnp.int32(1 if is_b else 0), None)
    return args, dict(h=h, w=w, bd=bd, is_b=is_b, nmerge=5, parts=True,
                      has_me=False)


def plan_frame(orig_y, sps, sh, rc, prev_mv8, lam, lam_sqrt, device,
               mesh=None, fetch=True):
    """Dispatch + fetch the fused inter plan for one frame.
    rc: mvpred.RefCtx with the frame's reference lists.  When a `row`
    mesh is given (and the geometry allows exact 64-row banding), the
    integer-ME stage runs row-sharded across it (parallel.plan_shard)
    and the fused plan consumes the precomputed grids bit-identically."""
    h, w = sps.pic_height, sps.pic_width
    bd = sps.bit_depth_luma
    is_b = sh.slice_type == 0
    uniq, keymap = [], {}
    nlists = 2 if is_b else 1
    for lx in range(nlists):
        nref = min(sh.num_ref_idx[lx], len(rc.ref_lists[lx]))
        for r_idx in range(nref):
            ref = rc.ref_lists[lx][r_idx]
            key = id(ref)
            for j, (k2, _) in enumerate(uniq):
                if k2 == key:
                    keymap[(lx, r_idx)] = j
                    break
            else:
                keymap[(lx, r_idx)] = len(uniq)
                uniq.append((key, ref.rec[0]))
    if not uniq:
        return None
    map0 = [keymap[(0, i)] for i in range(len(
        [k for k in keymap if k[0] == 0]))]
    map1 = [keymap[(1, i)] for i in range(len(
        [k for k in keymap if k[0] == 1]))] if is_b else []
    # Pad the unique-ref stack to a fixed R and the list maps to a fixed
    # MAXREF so every GOP hierarchy level / DPB fill state hits the SAME
    # compiled program (one per slice kind) — ref-shape respecialization
    # used to recompile on the first B of each level.
    R_PAD = max(len(uniq), MAXREF_PLAN)
    pad_plane = uniq[0][1]
    planes_u = [p for _, p in uniq] + \
        [pad_plane] * (R_PAD - len(uniq))
    # WP-aware pricing: fold each reference's explicit luma weight and
    # offset into its plane so the plan's SATD/SSE sees what the
    # normative weighted MC will produce on fades — otherwise every
    # candidate is systematically mispriced when weighted_pred is on
    # (TComWeightPrediction.h:64-81; uni-pred pixel-domain form, sub-LSB
    # rounding vs the 14-bit path is irrelevant for ranking).
    if getattr(sh, "pred_weights", None):
        wmap = {}
        for (lx2, r2), j in keymap.items():
            wp = sh.pred_weights.get((lx2, r2, 0))
            if wp is not None and wp.present and j not in wmap:
                wmap[j] = wp
        if any(w.weight != (1 << w.log2_denom) or w.offset
               for w in wmap.values()):
            maxv = (1 << bd) - 1
            off_scale = 1 << max(bd - 8, 0)
            out_planes = []
            for j, p in enumerate(planes_u):
                wp = wmap.get(j)
                if wp is None or (wp.weight == (1 << wp.log2_denom)
                                  and not wp.offset):
                    out_planes.append(p)
                    continue
                rnd = (1 << (wp.log2_denom - 1)) if wp.log2_denom else 0
                q = ((p.astype(np.int64) * wp.weight + rnd)
                     >> wp.log2_denom) + wp.offset * off_scale
                out_planes.append(np.clip(q, 0, maxv).astype(np.int32))
            planes_u = out_planes
    map0 = (map0 + [0] * MAXREF_PLAN)[:MAXREF_PLAN]
    map1 = (map1 + [0] * MAXREF_PLAN)[:MAXREF_PLAN]
    nref0 = min(len([k for k in keymap if k[0] == 0]), MAXREF_PLAN)
    nref1 = min(len([k for k in keymap if k[0] == 1]), MAXREF_PLAN)
    qp_luma = sh.qp + 6 * (bd - 8)
    # SIGNED POC distance of each unique reference (scales the
    # POC-normalized motion prior per ref, like TMVP scaling)
    poc_of = {}
    for lx in range(nlists):
        for r_idx in range(min(sh.num_ref_idx[lx], len(rc.ref_lists[lx]))):
            poc_of[keymap[(lx, r_idx)]] = rc.ref_lists[lx][r_idx].poc
    dists = [sh.poc - poc_of.get(j, sh.poc - 1)
             for j in range(len(planes_u))]
    parts_on = not os.environ.get("HM16_NO_PLAN_PARTS")
    mvn16_np = (np.zeros((h // 8, w // 8, 2), np.int32)
                if prev_mv8 is None else np.asarray(prev_mv8, np.int32))
    me = None
    if mesh is not None:
        from hm16_2_tpu.parallel import plan_shard
        if plan_shard.shardable(mesh, h, w, parts_on):
            me = plan_shard.sharded_int_me(
                mesh, np.ascontiguousarray(orig_y[:h, :w]),
                np.stack([np.ascontiguousarray(p[:h, :w])
                          for p in planes_u]),
                mvn16_np, np.asarray(dists, np.int32), float(lam_sqrt),
                h, w)
    cacheable = not getattr(sh, "pred_weights", None)
    with jax.default_device(device):
        refs = jnp.stack([_device_ref(p, h, w, device) if cacheable
                          else jnp.asarray(p[:h, :w], jnp.int32)
                          for p in planes_u])
        cur = jnp.asarray(orig_y[:h, :w], jnp.int32)
        mvn16 = jnp.asarray(mvn16_np, jnp.int32)
        packed = _plan_device(
            cur, refs, mvn16, jnp.asarray(dists, jnp.int32),
            jnp.float32(lam), jnp.float32(lam_sqrt),
            jnp.int32(qp_luma),
            jnp.asarray(map0, jnp.int32), jnp.asarray(map1, jnp.int32),
            jnp.int32(nref0), jnp.int32(nref1), me,
            h=h, w=w, bd=bd, is_b=is_b, nmerge=sh.max_num_merge_cand,
            parts=parts_on, has_me=me is not None)
        try:
            packed.copy_to_host_async()
        except Exception:
            pass
    if not fetch:
        return lambda: fetch_plan(packed, h, w)
    return fetch_plan(packed, h, w)
