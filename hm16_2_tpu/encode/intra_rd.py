"""Frame-level batched intra RD decision (the accelerator encode path).

HM's encoder walks the CU quadtree depth-first, trial-encoding every
candidate against running CABAC contexts (TEncCu.cpp:466 xCompressCU,
TEncSearch.cpp:2289 estIntraPredQT).  That search is wavefront-sequential
and cannot batch.  Here the whole frame's candidate CUs are evaluated at
once per size on the accelerator:

  stage 1 (jitted, per TU size 4/8/16/32):
      reference assembly from ORIGINAL pixels -> all-35-mode prediction
      (gather tables) -> SATD -> top-K candidate modes -> forward
      transform + quant + dequant + inverse transform (integer matmuls)
      -> true SSE distortion + estimated CABAC bits
  stage 2 (host, numpy): bottom-up quadtree DP — leaf-vs-split argmin per
      node, including the 8x8 2Nx2N-vs-NxN (4x4 PU) decision
  stage 3 (caller): z-order commit pass reconstructs the chosen CUs
      bit-exactly with reconstructed-pixel references and emits CABAC.

The candidate evaluation uses original-pixel references and estimated
(context-free) bit costs — the classic hardware-encoder tradeoff flagged
in SURVEY.md section 7; the commit pass keeps the bitstream and the
reconstruction normative.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from hm16_2_tpu._jaxcache import ensure_cache

ensure_cache()

import jax
import jax.numpy as jnp

from hm16_2_tpu.common.tables import DCT, DST4, INV_QUANT_SCALES, QUANT_SCALES
from hm16_2_tpu.ops import analysis

TRANSFORM_MATRIX_SHIFT = 6


# ---------------------------------------------------------------------------
# batched integer transform pipeline (duals of ops.transforms_ref)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("bit_depth", "log2_tr", "qp"))
def batched_dequant(levels, qp: int, bit_depth: int, log2_tr: int):
    """Flat-matrix dequant (transforms_ref.dequant, scaling list None)."""
    per, rem = qp // 6, qp % 6
    max_dr = 15
    tshift = max_dr - bit_depth - log2_tr
    right_shift = 6 - (tshift + per)
    scale = int(INV_QUANT_SCALES[rem])
    target_bd = min(max_dr + 1, 32 + right_shift - 7)
    imin, imax = -(1 << (target_bd - 1)), (1 << (target_bd - 1)) - 1
    q = jnp.clip(levels.astype(jnp.int32), imin, imax)
    if right_shift > 0:
        out = (q * scale + (1 << (right_shift - 1))) >> right_shift
    else:
        out = (q * scale) << (-right_shift)
    return jnp.clip(out, -(1 << max_dr), (1 << max_dr) - 1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("bit_depth", "use_dst"))
def batched_inv_transform(coeffs, bit_depth: int, use_dst: bool):
    """Inverse 2-D transform with HM's intermediate clamps (xITrMxN)."""
    s = coeffs.shape[-1]
    t = jnp.asarray((DST4 if (use_dst and s == 4) else DCT[s]).astype(np.int32))
    max_dr = 15
    s1 = TRANSFORM_MATRIX_SHIFT + 1
    s2 = (TRANSFORM_MATRIX_SHIFT + max_dr - 1) - bit_depth
    lo, hi = -(1 << max_dr), (1 << max_dr) - 1
    c = coeffs.astype(jnp.int32)
    stage1 = jnp.clip(
        (jnp.einsum("ji,...jk->...ik", t, c) + (1 << (s1 - 1))) >> s1, lo, hi)
    out = jnp.clip(
        (jnp.einsum("...ij,jk->...ik", stage1, t) + (1 << (s2 - 1))) >> s2,
        -32768, 32767)
    return out.astype(jnp.int32)


# ---------------------------------------------------------------------------
# estimated residual bits (context-free CABAC cost model)
# ---------------------------------------------------------------------------

BITS_SCALE = 1.0          # residual-bits model scale (calibrated)
NXN_OVERHEAD_BITS = 4.0   # part_size flag + extra cbf/TU flags vs 2Nx2N
                          # (per-PU mode bits are counted per 4x4 candidate)
SPLIT_OVERHEAD_BITS = 3.0  # split flag + per-child mode overhead delta
# intra RQT level-1 candidates; empty by default: with the high split
# price below, the TU-split almost never wins (measured 5.07% vs 5.2%
# AI BD-rate) and its fixed-mode child evaluation costs ~30% of the
# frame-plan compute.  64x64 CUs still force-split to four TU32s.
TUSPLIT_SIZES = ()
TUSPLIT_EXTRA_BITS = 16.0  # subdiv flag + extra per-TU cbf/last overhead;
                           # deliberately high: the children are scored on
                           # original-pixel references at the TU boundary,
                           # which flatters the split (measured on-content)
# plan-stage candidate counts per TU size (HM uses 8/8/3/3 for its one
# full-RD stage, TEncSearch.cpp:2306; here the commit pass re-ranks the
# top-3 + MPMs on true references, so a smaller plan-stage k measures
# BETTER: 4.8% vs 5.2% AI BD-rate — and is faster)
NUM_RD_CANDS = {4: 4, 8: 4, 16: 3, 32: 3}


def _bits_estimate(lvl):
    """Approximate CABAC bits for (..., s, s) int32 level blocks.

    Context-free model of HM's residual syntax: per-coefficient sig /
    greater1 / greater2 / sign / Golomb-Rice escape plus last-position and
    coded-group overhead.  Constants are average fractional-bit costs of
    the corresponding bins; accurate enough to rank candidates (the real
    bits are produced by the final CABAC pass)."""
    a = jnp.abs(lvl)
    s = lvl.shape[-1]
    nz = (a > 0)
    nnz = nz.sum(axis=(-1, -2))
    # bounding box of significant coefficients ~ coded region
    ys = jnp.arange(s)
    row_any = nz.any(axis=-1)
    col_any = nz.any(axis=-2)
    last_y = jnp.max(jnp.where(row_any, ys, -1), axis=-1)
    last_x = jnp.max(jnp.where(col_any, ys, -1), axis=-1)
    bbox = (last_x + 1) * (last_y + 1)
    n_zero_coded = jnp.maximum(bbox - nnz, 0)
    # escape (remaining-level) bits: k=0 Rice baseline on level-1
    esc = jnp.maximum(a - 1, 0)
    esc_bits = jnp.where(a > 1, 2.0 * jnp.ceil(jnp.log2(esc + 1.0)) + 1.0,
                         0.0).sum(axis=(-1, -2))
    gt1 = (a > 1).sum(axis=(-1, -2))
    # last-position prefix ~ 2*log2(pos)
    lastpos_bits = jnp.where(
        nnz > 0,
        2.0 * (jnp.log2(jnp.maximum(last_x, 0) + 1.5)
               + jnp.log2(jnp.maximum(last_y, 0) + 1.5)) + 2.0, 0.0)
    n_cgs = jnp.maximum((last_x // 4 + 1) * (last_y // 4 + 1) - 1, 0)
    # weights regressed against exact CabacCounter fractional bits over
    # 519 real content TUs at QP 22..42 (R^2 = 0.99); zeros inside the
    # coded region are nearly free under the adaptive contexts, nonzero
    # coefficients dominate at ~3.8 bits apiece.  Regenerate with
    # `python -m hm16_2_tpu.tools.fit_bits_model` (same oracle: counting
    # coder on fresh slice-init contexts)
    bits = (-0.089 * n_zero_coded
            + 3.798 * nnz
            - 0.648 * gt1
            + 0.616 * esc_bits
            + 2.275 * lastpos_bits
            + 1.173 * n_cgs
            - 12.817 + 1.0)              # fit constant + cbf
    return jnp.where(nnz > 0, jnp.maximum(bits, 2.0), 0.8)


# ---------------------------------------------------------------------------
# per-size candidate evaluation
# ---------------------------------------------------------------------------

def _topk_argmin(x, k):
    """Indices of the k smallest entries per row, ascending — iterative
    masked argmin (XLA's general sort is pathologically slow on CPU for
    these tiny rows; k reductions are far cheaper)."""
    cols = jnp.arange(x.shape[1])[None, :]
    idxs = []
    for _ in range(k):
        i = jnp.argmin(x, axis=1)
        idxs.append(i)
        x = jnp.where(cols == i[:, None], jnp.inf, x)
    return jnp.stack(idxs, axis=1)


@partial(jax.jit, static_argnames=("s", "bd", "k", "qp", "is_luma",
                                   "use_dst", "want_satd"))
def _size_rd(bufs, blocks, lam, s: int, bd: int, k: int,
             qp: int, is_luma: bool = True, use_dst: bool = False,
             want_satd: bool = False):
    """Best mode + RD cost for N blocks of one size (fused kernel: one
    35-mode prediction pass feeds both the SATD preselection and the
    top-k candidate RD).

    bufs: (N, 2, 4s+1) refs; blocks: (N, s, s) originals.  Candidate
    preselection by SATD (HM's Hadamard cost stage), final choice by
    dist + lam*(estimated residual bits + flat mode bits).
    Returns (best_mode (N,), cost (N,), top3 (N, 3), satd (N,35)|None).

    Distortion is accumulated as exact int32 (fits for bit depth <= 10:
    1023^2 * 1024 < 2^31) so results are bit-identical between program
    variants (sharded / unsharded / fused) regardless of XLA reduction
    order."""
    preds = analysis.predict_all_modes(bufs, s, is_luma, bd)
    diffs = preds.astype(jnp.int32) - blocks[:, None].astype(jnp.int32)
    satd = analysis.batched_satd(diffs)
    topk = _topk_argmin(satd.astype(jnp.float32), k)        # (N, k)
    cand = jnp.take_along_axis(preds, topk[:, :, None, None], axis=1)
    resi = blocks[:, None].astype(jnp.int32) - cand
    log2 = s.bit_length() - 1
    fwd = analysis.batched_fwd_transform(resi, bd, use_dst)
    lvl = analysis.batched_quant(fwd, qp, bd, log2, True)
    deq = batched_dequant(lvl, qp, bd, log2)
    rres = batched_inv_transform(deq, bd, use_dst)
    rec = jnp.clip(cand + rres, 0, (1 << bd) - 1)
    d = blocks[:, None] - rec
    dist = (d * d).sum(axis=(-1, -2)).astype(jnp.float32)
    bits = BITS_SCALE * _bits_estimate(lvl) + 6.0           # + mode bits
    cost = dist + lam * bits
    rd_order = _topk_argmin(cost, 3)
    top3 = jnp.take_along_axis(topk, rd_order, axis=1)      # RD-ranked
    best_cost = jnp.take_along_axis(cost, rd_order[:, :1], axis=1)[:, 0]
    return (top3[:, 0], best_cost, top3, satd if want_satd else None)


def _chroma_rd5(bufs, blocks, modes5, lam, s: int, bd: int, qp: int):
    """Per-candidate (dist, bits) for 5 chroma modes per block.

    modes5: (N, 5) actual prediction modes.  One fused call evaluates all
    candidates (the predictions for all 35 modes are shared)."""
    preds = analysis.predict_all_modes(bufs, s, False, bd)
    cand = jnp.take_along_axis(preds, modes5[:, :, None, None], axis=1)
    resi = blocks[:, None].astype(jnp.int32) - cand
    log2 = s.bit_length() - 1
    fwd = analysis.batched_fwd_transform(resi, bd, False)
    lvl = analysis.batched_quant(fwd, qp, bd, log2, True)
    deq = batched_dequant(lvl, qp, bd, log2)
    rres = batched_inv_transform(deq, bd, False)
    rec = jnp.clip(cand + rres, 0, (1 << bd) - 1)
    d = blocks[:, None] - rec
    dist = (d * d).sum(axis=(-1, -2)).astype(jnp.float32)
    bits = _bits_estimate(lvl)
    return dist, bits


@partial(jax.jit, static_argnames=("s", "bd", "qp", "is_luma", "use_dst"))
def _size_rd_fixed_mode(bufs, blocks, modes, lam, s: int, bd: int, qp: int,
                        is_luma: bool = False, use_dst: bool = False):
    """RD cost with a given mode per block (chroma DM / shared-mode TU
    split evaluation)."""
    preds = analysis.predict_all_modes(bufs, s, is_luma, bd)
    cand = jnp.take_along_axis(
        preds, modes[:, None, None, None], axis=1)[:, 0]
    resi = blocks.astype(jnp.int32) - cand
    log2 = s.bit_length() - 1
    fwd = analysis.batched_fwd_transform(resi, bd, use_dst)
    lvl = analysis.batched_quant(fwd, qp, bd, log2, True)
    deq = batched_dequant(lvl, qp, bd, log2)
    rres = batched_inv_transform(deq, bd, use_dst)
    rec = jnp.clip(cand + rres, 0, (1 << bd) - 1)
    d = blocks - rec
    dist = (d * d).sum(axis=(-1, -2)).astype(jnp.float32)
    bits = _bits_estimate(lvl)
    return dist, bits


def _ref_buffers(plane, s, bd, strong, h, w):
    """(N, 2, 4s+1) original-pixel reference buffers for all aligned s-blocks
    fully inside (h, w); mirrors CtuSearch._premodes assembly."""
    nby, nbx = h // s, w // s
    ph, pw = plane.shape
    x0s = (np.arange(nbx) * s)[None, :].repeat(nby, 0).ravel()
    y0s = (np.arange(nby) * s)[:, None].repeat(nbx, 1).ravel()
    rng = np.arange(-1, 2 * s)
    tops = plane[np.clip(y0s - 1, 0, None)[:, None],
                 np.clip(x0s[:, None] + rng[None, :], 0, pw - 1)]
    lrng = np.concatenate([[-1], np.arange(0, 2 * s)])
    lefts = plane[np.clip(y0s[:, None] + lrng[None, :], 0, ph - 1),
                  np.clip(x0s - 1, 0, None)[:, None]]
    lefts[:, 0] = tops[:, 0]
    n = len(x0s)
    tops = tops.astype(np.int32, copy=False)
    lefts = lefts.astype(np.int32, copy=False)
    buf_u = np.zeros((n, 4 * s + 1), dtype=np.int32)
    buf_u[:, 2 * s] = tops[:, 0]
    buf_u[:, 2 * s + 1:] = tops[:, 1:]
    buf_u[:, :2 * s] = lefts[:, 1:][:, ::-1]
    buf_f = buf_u.copy()
    buf_f[:, 1:-1] = (buf_u[:, 2:] + 2 * buf_u[:, 1:-1]
                      + buf_u[:, :-2] + 2) >> 2
    if s == 32 and strong:
        log2 = 5
        thr = 1 << (bd - 5)
        c0, cs_, c2s = buf_u[:, 2 * s], buf_u[:, 3 * s], buf_u[:, 4 * s]
        l0, ls_, l2s = buf_u[:, 2 * s], buf_u[:, s], buf_u[:, 0]
        use = (np.abs(c0 + c2s - 2 * cs_) < thr) & \
              (np.abs(l0 + l2s - 2 * ls_) < thr)
        i = np.arange(1, 2 * s)
        top_bl = ((2 * s - i)[None, :] * c0[:, None]
                  + i[None, :] * c2s[:, None] + s) >> (log2 + 1)
        left_bl = ((2 * s - i)[None, :] * l0[:, None]
                   + i[None, :] * l2s[:, None] + s) >> (log2 + 1)
        sb = buf_u.copy()
        sb[:, 2 * s + 1: 4 * s] = top_bl
        sb[:, 1: 2 * s] = left_bl[:, ::-1]
        buf_f = np.where(use[:, None], sb, buf_f)
    blocks = plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s) \
        .swapaxes(1, 2).reshape(n, s, s).astype(np.int32)
    return np.stack([buf_u, buf_f], axis=1), blocks, nby, nbx


class IntraPlan:
    """Dense frame plan: per-4x4-part depth / NxN flag / luma mode."""

    __slots__ = ("depth", "nxn", "mode", "h4", "w4", "cov", "tusplit",
                 "cmode", "cands")

    def __init__(self, h4, w4):
        self.h4, self.w4 = h4, w4
        self.depth = np.full((h4, w4), -1, dtype=np.int8)
        self.nxn = np.zeros((h4, w4), dtype=bool)      # at 8x8 origins
        self.mode = np.full((h4, w4), -1, dtype=np.int8)
        self.cov = np.zeros((h4, w4), dtype=bool)      # plan covers part
        self.tusplit = np.zeros((h4, w4), dtype=bool)  # at CU origins
        self.cmode = np.full((h4, w4), 4, dtype=np.int8)  # chroma cand idx
        # RD-ranked top-3 luma mode candidates at CU/PU origins, for the
        # commit pass's true-reference re-ranking
        self.cands = np.full((h4, w4, 3), -1, dtype=np.int8)


def _jnp_ref_buffers(plane, s: int, bd: int, strong: bool, h: int, w: int):
    """Device twin of _ref_buffers: (N, 2, 4s+1) reference buffers plus
    (N, s, s) original blocks for all aligned s-blocks fully inside
    (h, w), assembled with gathers so the whole plan stays on-device."""
    nby, nbx = h // s, w // s
    ph, pw = plane.shape
    x0s = jnp.tile(jnp.arange(nbx) * s, nby)
    y0s = jnp.repeat(jnp.arange(nby) * s, nbx)
    rng = jnp.arange(-1, 2 * s)
    tops = plane[jnp.clip(y0s - 1, 0, None)[:, None],
                 jnp.clip(x0s[:, None] + rng[None, :], 0, pw - 1)]
    lrng = jnp.concatenate([jnp.array([-1]), jnp.arange(0, 2 * s)])
    lefts = plane[jnp.clip(y0s[:, None] + lrng[None, :], 0, ph - 1),
                  jnp.clip(x0s - 1, 0, None)[:, None]]
    lefts = lefts.at[:, 0].set(tops[:, 0])
    n = nby * nbx
    tops = tops.astype(jnp.int32)
    lefts = lefts.astype(jnp.int32)
    buf_u = jnp.concatenate(
        [lefts[:, 1:][:, ::-1], tops[:, :1], tops[:, 1:]], axis=1)
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
    blocks = plane[:nby * s, :nbx * s].reshape(nby, s, nbx, s) \
        .swapaxes(1, 2).reshape(n, s, s).astype(jnp.int32)
    return jnp.stack([buf_u, buf_f], axis=1), blocks


def _up(a, f):
    """Upsample a grid by f x f (nearest)."""
    return jnp.repeat(jnp.repeat(a, f, axis=0), f, axis=1)


def _pad_to(a, hh, ww, fill):
    return jnp.pad(a, ((0, hh - a.shape[0]), (0, ww - a.shape[1])),
                   constant_values=fill)


def _quad(a):
    """Sum 2x2 neighbourhoods (truncating odd edges)."""
    hh, ww = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
    q = a[:hh, :ww]
    return q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]


@partial(jax.jit, static_argnames=("h", "w", "bd", "cbd", "strong", "qp",
                                   "cqp0", "cqp1", "chroma", "use_stage1"))
def _plan_device(y, cb, cr, lam, cweight, stage1, *, h: int, w: int,
                 bd: int, cbd: int, strong: bool, qp: int, cqp0: int,
                 cqp1: int, chroma: bool, use_stage1: bool):
    """The whole frame plan as ONE device program: per-size candidate RD
    (ref assembly + 35-mode prediction + SATD + top-k transform RD),
    chroma mode RD, the 64x64 level, the bottom-up quadtree DP, and the
    dense plan emission.  One dispatch per frame; only the compact plan
    arrays come back to the host.

    stage1: optional per-size (mode, cost, top3, satd32) grids computed
    elsewhere (the row-sharded multi-device path) — must be numerically
    identical to the in-program evaluation, which holds because every
    cross-block reduction is integer."""
    lamf = lam.astype(jnp.float32)
    sizes = (4, 8, 16, 32)
    mode_s, cost_s, cand_s = {}, {}, {}
    satd32 = None
    shape_s = {s: (h // s, w // s) for s in (4, 8, 16, 32, 64)}
    for i, s in enumerate(sizes):
        nby, nbx = shape_s[s]
        if nby == 0 or nbx == 0:
            mode_s[s] = jnp.zeros((nby, nbx), jnp.int32)
            cost_s[s] = jnp.zeros((nby, nbx), jnp.float32)
            cand_s[s] = jnp.zeros((nby, nbx, 3), jnp.int32)
            continue
        if use_stage1:
            m, c, c3, sa = stage1[i]
            m = m.reshape(nby, nbx)
            c = c.reshape(nby, nbx).astype(jnp.float32)
            c3 = c3.reshape(nby, nbx, 3)
            if s == 32:
                satd32 = sa.reshape(nby, nbx, 35)
        else:
            bufs, blocks = _jnp_ref_buffers(y, s, bd, strong, h, w)
            m, c, c3, sa = _size_rd(bufs, blocks, lamf, s, bd,
                                    NUM_RD_CANDS[s], qp, True, s == 4,
                                    s == 32)
            m = m.reshape(nby, nbx)
            c = c.reshape(nby, nbx)
            c3 = c3.reshape(nby, nbx, 3)
            if s == 32:
                satd32 = sa.reshape(nby, nbx, 35)
        mode_s[s], cost_s[s], cand_s[s] = m, c, c3

    # chroma mode RD folded into each luma CU size: the five HEVC chroma
    # candidates {planar, ver, hor, dc, DM} shared between Cb and Cr
    # (estIntraPredChromaQT TEncSearch.cpp:2698)
    cmode_s, chroma_add = {}, {}
    if chroma:
        for s in (8, 16, 32):
            cs = s // 2
            nby, nbx = shape_s[s]
            if nby == 0 or nbx == 0:
                continue
            dm = mode_s[s].reshape(-1)
            base = (0, 26, 10, 1)
            cols = [jnp.where(dm == m, 34, m) for m in base] + [dm]
            modes5 = jnp.stack(cols, axis=1)
            mode_bits = jnp.asarray([4.0, 4.0, 4.0, 4.0, 1.0], jnp.float32)
            tot = lamf * mode_bits[None, :]
            for comp, cplane, cqp in ((1, cb, cqp0), (2, cr, cqp1)):
                bufs, blocks = _jnp_ref_buffers(cplane, cs, cbd, False,
                                                h // 2, w // 2)
                d, b = _chroma_rd5(bufs, blocks, modes5, lamf, cs, cbd, cqp)
                tot = tot + d * cweight + lamf * b
            best = jnp.argmin(tot, axis=1)
            add = jnp.take_along_axis(tot, best[:, None], axis=1)[:, 0] \
                .reshape(nby, nbx)
            cost_s[s] = cost_s[s] + add
            chroma_add[s] = add
            cmode_s[s] = best.reshape(nby, nbx).astype(jnp.int32)

    # 64x64 intra CUs: one shared mode, TU forced-split to four TU32s.
    # Mode from the summed child SATD; cost via fixed-mode TU32 eval.
    nby64, nbx64 = shape_s[64]
    cost64 = mode64 = None
    if nby64 and nbx64 and satd32 is not None:
        ss = satd32[:nby64 * 2, :nbx64 * 2]
        quad_satd = (ss[0::2, 0::2] + ss[0::2, 1::2]
                     + ss[1::2, 0::2] + ss[1::2, 1::2])
        mode64 = jnp.argmin(quad_satd, axis=2).astype(jnp.int32)
        bufs32, blocks32 = _jnp_ref_buffers(y, 32, bd, strong, h, w)
        cby, cbx = shape_s[32]
        idx = (jnp.arange(2 * nby64)[:, None] * cbx
               + jnp.arange(2 * nbx64)[None, :]).reshape(-1)
        pm64 = _up(mode64, 2)
        d, b = _size_rd_fixed_mode(
            bufs32[idx], blocks32[idx], pm64.reshape(-1), lamf, 32, bd,
            qp, True, False)
        cc = (d + lamf * b).reshape(2 * nby64, 2 * nbx64)
        cost64 = _quad(cc) + lamf * 8.0
        if 32 in chroma_add:
            cost64 = cost64 + _quad(chroma_add[32][:nby64 * 2, :nbx64 * 2])

    # ---- bottom-up quadtree DP ----
    nby8, nbx8 = shape_s[8]
    nby16, nbx16 = shape_s[16]
    nby32, nbx32 = shape_s[32]
    cu8 = cost_s[8]
    nxn_g = jnp.zeros((nby8, nbx8), bool)
    if nby8 and cost_s[4].size:
        quad4 = _quad(cost_s[4])[:nby8, :nbx8] + lamf * NXN_OVERHEAD_BITS
        nxn_g = quad4 < cu8
        cu8 = jnp.minimum(cu8, quad4)
    cu16 = cost_s[16]
    split16 = jnp.zeros((nby16, nbx16), bool)
    if nby16 and cu8.size:
        quad = _quad(cu8)[:nby16, :nbx16] + lamf * SPLIT_OVERHEAD_BITS
        split16 = quad < cu16
        cu16 = jnp.minimum(cu16, quad)
    cu32 = cost_s[32]
    split32 = jnp.zeros((nby32, nbx32), bool)
    if nby32 and cu16.size:
        quad = _quad(cu16)[:nby32, :nbx32] + lamf * SPLIT_OVERHEAD_BITS
        split32 = quad < cu32
        cu32 = jnp.minimum(cu32, quad)
    if cost64 is not None:
        c64_chosen = cost64 < (_quad(cu32)[:nby64, :nbx64]
                               + lamf * SPLIT_OVERHEAD_BITS)
    else:
        c64_chosen = jnp.zeros((nby64, nbx64), bool)

    # ---- dense plan emission (the recursion of the old host `mark`
    # expressed as per-level masks + upsampling) ----
    h4, w4 = h // 4, w // 4
    covered64_32 = _pad_to(_up(c64_chosen, 2), nby32, nbx32, False)
    leaf32 = ~covered64_32 & ~split32
    desc32 = ~covered64_32 & split32
    r16 = np.arange(nby16)[:, None]
    c16 = np.arange(nbx16)[None, :]
    border16 = jnp.asarray((r16 >= 2 * nby32) | (c16 >= 2 * nbx32))
    active16 = _pad_to(_up(desc32, 2), nby16, nbx16, False) | border16
    leaf16 = active16 & ~split16
    desc16 = active16 & split16
    r8 = np.arange(nby8)[:, None]
    c8 = np.arange(nbx8)[None, :]
    border8 = jnp.asarray((r8 >= 2 * nby16) | (c8 >= 2 * nbx16))
    active8 = _pad_to(_up(desc16, 2), nby8, nbx8, False) | border8
    leaf8 = active8 & ~nxn_g
    leafN = active8 & nxn_g

    m64 = _pad_to(_up(c64_chosen, 16), h4, w4, False)
    m32 = _pad_to(_up(leaf32, 8), h4, w4, False)
    m16 = _pad_to(_up(leaf16, 4), h4, w4, False)
    m8 = _pad_to(_up(leaf8, 2), h4, w4, False)
    mN = _pad_to(_up(leafN, 2), h4, w4, False)

    def up_val(grid, f, fill):
        return _pad_to(_up(grid, f), h4, w4, fill)

    neg = jnp.full((h4, w4), -1, jnp.int32)
    depth = jnp.where(m64, 0, jnp.where(m32, 1, jnp.where(
        m16, 2, jnp.where(m8 | mN, 3, neg))))
    mode4p = _pad_to(mode_s[4], h4, w4, -1) if cost_s[4].size else neg
    mode = neg
    if cost64 is not None:
        mode = jnp.where(m64, up_val(mode64, 16, -1), mode)
    mode = jnp.where(m32, up_val(mode_s[32], 8, -1), mode)
    mode = jnp.where(m16, up_val(mode_s[16], 4, -1), mode)
    mode = jnp.where(m8, up_val(mode_s[8], 2, -1), mode)
    mode = jnp.where(mN, mode4p, mode)
    cov = m64 | m32 | m16 | m8 | mN
    iy = np.arange(h4)[:, None]
    ix = np.arange(w4)[None, :]

    def origin(f):
        return jnp.asarray((iy % f == 0) & (ix % f == 0))

    nxn_plan = mN & origin(2)
    tusplit = m64 & origin(16)
    # RD-ranked top-3 candidates at CU/PU origins for commit-time
    # re-ranking (at 4x4 granularity the grid IS the part grid)
    cands = jnp.full((h4, w4, 3), -1, jnp.int32)
    for s, m_, f in ((32, m32, 8), (16, m16, 4), (8, m8, 2)):
        if not cost_s[s].size:
            continue
        c3u = jnp.repeat(jnp.repeat(cand_s[s], f, axis=0), f, axis=1)
        c3u = jnp.pad(c3u, ((0, h4 - c3u.shape[0]),
                            (0, w4 - c3u.shape[1]), (0, 0)),
                      constant_values=-1)
        sel = (m_ & origin(f))[:, :, None]
        cands = jnp.where(sel, c3u, cands)
    if cost_s[4].size:
        c4u = jnp.pad(cand_s[4], ((0, h4 - cand_s[4].shape[0]),
                                  (0, w4 - cand_s[4].shape[1]), (0, 0)),
                      constant_values=-1)
        cands = jnp.where(mN[:, :, None], c4u, cands)
    cmode = jnp.full((h4, w4), 4, jnp.int32)
    for s, m_, f in ((32, m32, 8), (16, m16, 4), (8, m8, 2)):
        if s in cmode_s:
            cmode = jnp.where(m_, up_val(cmode_s[s], f, 4), cmode)

    flags = (nxn_plan.astype(jnp.int8) | (cov.astype(jnp.int8) << 1)
             | (tusplit.astype(jnp.int8) << 2))
    return jnp.stack(
        [depth.astype(jnp.int8), mode.astype(jnp.int8),
         cmode.astype(jnp.int8), cands[:, :, 0].astype(jnp.int8),
         cands[:, :, 1].astype(jnp.int8), cands[:, :, 2].astype(jnp.int8),
         flags])


def submit_plan(orig, sps, qp, lam, chroma_weight, chroma_qps, device=None,
                stage1=None):
    """Dispatch the fused frame-plan program; returns the packed device
    array WITHOUT blocking (JAX async dispatch) so the accelerator can
    compute this frame's plan while the host commits the previous one."""
    bd = sps.bit_depth_luma
    strong = bool(sps.strong_intra_smoothing)
    h, w = sps.pic_height, sps.pic_width
    if device is None:
        device = _pick_device()
    chroma = len(orig) > 1 and sps.chroma_format_idc == 1
    with jax.default_device(device):
        y = jnp.asarray(orig[0], jnp.int32)
        if chroma:
            cbp = jnp.asarray(orig[1], jnp.int32)
            crp = jnp.asarray(orig[2], jnp.int32)
        else:
            cbp = crp = jnp.zeros((1, 1), jnp.int32)
        packed = _plan_device(
            y, cbp, crp, jnp.float32(lam), jnp.float32(chroma_weight),
            stage1, h=h, w=w, bd=bd, cbd=sps.bit_depth_chroma,
            strong=strong, qp=int(qp), cqp0=int(chroma_qps[0]),
            cqp1=int(chroma_qps[1]), chroma=chroma,
            use_stage1=stage1 is not None)
        # start the device->host copy in the background: by fetch time the
        # result is already host-side instead of a blocking copy per frame
        try:
            packed.copy_to_host_async()
        except Exception:
            pass
        return packed


def zero_inputs(h, w, bd, qp=32):
    """(args, kwargs) of `_plan_device` for an all-zero 4:2:0 frame at one
    geometry and slice QP (no chroma QP offsets), as submit_plan passes
    them: for lowering or compiling the program without an encode."""
    from hm16_2_tpu.common.tables import CHROMA_QP_SCALE
    qpl = qp + 6 * (bd - 8)
    cqp = int(CHROMA_QP_SCALE[1][int(np.clip(qp, 0, 57))]) + 6 * (bd - 8)
    y = jnp.zeros((h, w), jnp.int32)
    c = jnp.zeros((h // 2, w // 2), jnp.int32)
    return (y, c, c, jnp.float32(50.0), jnp.float32(1.0), None), dict(
        h=h, w=w, bd=bd, cbd=bd, strong=True, qp=qpl, cqp0=cqp, cqp1=cqp,
        chroma=True, use_stage1=False)


def fetch_plan(packed, h, w):
    """Materialize a submitted plan (one blocking fetch per frame)."""
    pi8 = np.asarray(packed)
    plan = IntraPlan(h // 4, w // 4)
    plan.depth[:] = pi8[0]
    plan.mode[:] = pi8[1]
    plan.cmode[:] = pi8[2]
    plan.cands[:] = np.moveaxis(pi8[3:6], 0, -1)
    flags = pi8[6]
    plan.nxn[:] = (flags & 1) != 0
    plan.cov[:] = (flags & 2) != 0
    plan.tusplit[:] = (flags & 4) != 0
    return plan


def plan_frame(orig, sps, qp, lam, chroma_weight, chroma_qps, device=None,
               stage1=None):
    """Stage 1 + 2 of the batched frame pipeline as a single device
    dispatch (see _plan_device).  orig: [Y, Cb, Cr] int32 planes.
    Returns an IntraPlan covering every part whose CTU is fully inside
    the picture; uncovered parts fall back to the caller's per-CU path.

    stage1: optional per-size (mode, cost, top3, satd) device grids from
    the row-sharded multi-device path (parallel/frame_shard.py)."""
    packed = submit_plan(orig, sps, qp, lam, chroma_weight, chroma_qps,
                         device, stage1)
    return fetch_plan(packed, sps.pic_height, sps.pic_width)


def _pick_device():
    """The device the plan programs run on: JAX's own default, i.e. the
    device of an enclosing `jax.default_device(...)` block if any, else
    `jax.devices()[0]` (the GPU on a GPU host, the CPU under
    JAX_PLATFORMS=cpu)."""
    d = jax.config.jax_default_device
    if d is None:
        return jax.devices()[0]
    if isinstance(d, str):
        return jax.devices(d)[0]
    return d
