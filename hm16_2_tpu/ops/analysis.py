"""Batched accelerator analysis kernels (JAX): the encoder's hot path.

HM evaluates intra modes sequentially per PU (TEncSearch.cpp:2289-2697); here
all 35 modes x N blocks are evaluated at once:

  - mode prediction = one gather with static per-mode index/weight tables
    (angular two-tap interpolation, planar bilinear, DC) — no control flow
  - SATD = Hadamard via integer matmuls over (N, 35, s, s) difference tensors
  - forward DCT + quantization = integer matmuls + shifts

The per-mode tables bake in: filtered-vs-unfiltered reference selection,
horizontal-mode transposition, negative-angle main-reference extension, and
the DC/vertical/horizontal edge filters, so the jitted function is pure
gather/matmul — exactly reproducing ops.intra_ref per sample.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from hm16_2_tpu._jaxcache import ensure_cache

ensure_cache()

from hm16_2_tpu.common.tables import ANG_TABLE, INV_ANG_TABLE, DCT, DST4, QUANT_SCALES
from hm16_2_tpu.ops.intra_ref import (
    DC_IDX, HOR_IDX, PLANAR_IDX, VER_IDX, should_filter)

# ref buffer layout: buf[i] for i in 0..4s:  left[2s-i] for i<2s ... i.e.
#   buf[0] = left[2s] (bottom-most), buf[2s] = corner, buf[2s + i] = top[i]
BUF = lambda s: 4 * s + 1


def _corner(s):
    return 2 * s


@lru_cache(maxsize=None)
def angular_tables(s: int, is_luma: bool):
    """Static (mode, y, x) gather/weight tables for modes 2..34.

    Returns dict of numpy arrays:
      g0, g1: indices into the ref buffer, shape (33, s, s)
      w0, w1: interpolation weights (sum 32), shape (33, s, s)
      plane:  0 = unfiltered refs, 1 = filtered refs, shape (33,)
    """
    g0 = np.zeros((33, s, s), dtype=np.int32)
    w0 = np.zeros((33, s, s), dtype=np.int32)
    plane = np.zeros(33, dtype=np.int32)
    corner = _corner(s)

    for mode in range(2, 35):
        mi = mode - 2
        is_ver = mode >= 18
        ang_mode = (mode - VER_IDX) if is_ver else -(mode - HOR_IDX)
        abs_ang = int(ANG_TABLE[abs(ang_mode)])
        inv_angle = int(INV_ANG_TABLE[abs(ang_mode)])
        angle = (-1 if ang_mode < 0 else 1) * abs_ang
        plane[mi] = 1 if should_filter(mode, s, is_luma) else 0

        # refMain as buffer indices, local index base s (k in -s..2s)
        ref_idx = np.zeros(3 * s + 1, dtype=np.int32)
        if is_ver:
            def main(i): return corner + i          # top
            def side(i): return corner - i          # left
        else:
            def main(i): return corner - i          # left
            def side(i): return corner + i          # top
        if angle < 0:
            for k in range(0, s + 1):
                ref_idx[s + k] = main(k)
            inv_sum = 128
            k = -1
            while k > (s * angle) >> 5:
                inv_sum += inv_angle
                ref_idx[s + k] = side(inv_sum >> 8)
                k -= 1
        else:
            for k in range(0, 2 * s + 1):
                ref_idx[s + k] = main(k)

        for y in range(s):
            delta = (y + 1) * angle
            i_int = delta >> 5
            frac = delta & 31
            for x in range(s):
                j = s + 1 + i_int + x
                if is_ver:
                    g0[mi, y, x] = ref_idx[j]
                    # g1 handled as ref_idx[j+1]
                    w0[mi, y, x] = 32 - frac
                else:
                    g0[mi, x, y] = ref_idx[j]
                    w0[mi, x, y] = 32 - frac
        # store also the +1 neighbor index table
    # neighbor index: for frac==0, g1 unused (w1=0)
    g1 = np.zeros_like(g0)
    for mode in range(2, 35):
        mi = mode - 2
        is_ver = mode >= 18
        ang_mode = (mode - VER_IDX) if is_ver else -(mode - HOR_IDX)
        abs_ang = int(ANG_TABLE[abs(ang_mode)])
        inv_angle = int(INV_ANG_TABLE[abs(ang_mode)])
        angle = (-1 if ang_mode < 0 else 1) * abs_ang
        corner = _corner(s)
        if is_ver:
            def main(i): return corner + i
            def side(i): return corner - i
        else:
            def main(i): return corner - i
            def side(i): return corner + i
        ref_idx = np.zeros(3 * s + 2, dtype=np.int32)
        if angle < 0:
            for k in range(0, s + 1):
                ref_idx[s + k] = main(k)
            inv_sum = 128
            k = -1
            while k > (s * angle) >> 5:
                inv_sum += inv_angle
                ref_idx[s + k] = side(inv_sum >> 8)
                k -= 1
            for k in range(s + 1, 2 * s + 2):
                ref_idx[s + k] = main(min(k, 2 * s))
        else:
            for k in range(0, 2 * s + 2):
                ref_idx[s + k] = main(min(k, 2 * s))
        for y in range(s):
            delta = (y + 1) * angle
            i_int = delta >> 5
            frac = delta & 31
            for x in range(s):
                j = s + 1 + i_int + x
                if is_ver:
                    g1[mi, y, x] = ref_idx[j + 1]
                else:
                    g1[mi, x, y] = ref_idx[j + 1]
    w1 = 32 - w0
    w1[w0 == 32] = 0
    w0[w1 == 0] = 32
    return {"g0": g0, "g1": g1, "w0": w0, "w1": w1, "plane": plane}


@lru_cache(maxsize=None)
def _planar_consts(s):
    shift = s.bit_length() - 1
    return shift


@partial(jax.jit, static_argnames=("s", "is_luma", "bit_depth"))
def predict_all_modes(bufs, s: int, is_luma: bool = True, bit_depth: int = 8):
    """All 35 intra predictions for a batch of blocks.

    bufs: (N, 2, 4s+1) int32 — [unfiltered, filtered] reference buffers
          (layout: left bottom-up, corner at 2s, then top left-to-right)
    returns (N, 35, s, s) int32
    """
    lead = bufs.shape[:-2]
    bufs = bufs.reshape((-1,) + bufs.shape[-2:])
    t = angular_tables(s, is_luma)
    g0, g1 = jnp.asarray(t["g0"]), jnp.asarray(t["g1"])
    w0, w1 = jnp.asarray(t["w0"]), jnp.asarray(t["w1"])
    plane = jnp.asarray(t["plane"])
    n = bufs.shape[0]
    corner = 2 * s

    # angular: gather (N, 33, s, s)
    sel = bufs[:, plane, :]                       # (N, 33, 4s+1)
    v0 = jnp.take_along_axis(
        sel, g0.reshape(1, 33, s * s), axis=2).reshape(n, 33, s, s)
    v1 = jnp.take_along_axis(
        sel, g1.reshape(1, 33, s * s), axis=2).reshape(n, 33, s, s)
    ang = (w0[None] * v0 + w1[None] * v1 + 16) >> 5

    # edge filters for pure vertical (26) / horizontal (10), luma small blocks
    unf = bufs[:, 0, :]
    top = unf[:, corner + 1: corner + 1 + s]          # top[1..s], (N, s)
    left = unf[:, corner - s: corner][:, ::-1]        # left[1..s]
    if is_luma and s <= 16:
        maxv = (1 << bit_depth) - 1
        corner_v = unf[:, corner]
        # mode 26 (index 24): first column corrected
        ang = ang.at[:, 24, :, 0].set(
            jnp.clip(top[:, 0][:, None] + ((left - corner_v[:, None]) >> 1), 0, maxv))
        # mode 10 (index 8): first row corrected
        ang = ang.at[:, 8, 0, :].set(
            jnp.clip(left[:, 0][:, None] + ((top - corner_v[:, None]) >> 1), 0, maxv))

    # planar (mode 0)
    f = bufs[:, 0, :]   # planar uses filtered refs when luma & should_filter
    pl_plane = 1 if should_filter(PLANAR_IDX, s, is_luma) else 0
    fp = bufs[:, pl_plane, :]
    topf = fp[:, corner + 1: corner + 1 + s]
    leftf = fp[:, corner - s: corner][:, ::-1]
    tr = fp[:, corner + s + 1]
    bl = fp[:, corner - s - 1]
    shift = _planar_consts(s)
    xs = jnp.arange(s)
    hor = (s - 1 - xs)[None, None, :] * leftf[:, :, None] + \
        (xs + 1)[None, None, :] * tr[:, None, None]
    ys = jnp.arange(s)
    ver = (s - 1 - ys)[None, :, None] * topf[:, None, :] + \
        (ys + 1)[None, :, None] * bl[:, None, None]
    planar = (hor + ver + s) >> (shift + 1)

    # DC (mode 1) — unfiltered refs
    dcval = (jnp.sum(top, axis=1) + jnp.sum(left, axis=1) + s) >> (shift + 1)
    dc = jnp.broadcast_to(dcval[:, None, None], (n, s, s)).astype(jnp.int32)
    if is_luma and s <= 16:
        corner_v = unf[:, corner]
        dc = dc.at[:, 0, :].set((top + 3 * dcval[:, None] + 2) >> 2)
        dc = dc.at[:, :, 0].set((left + 3 * dcval[:, None] + 2) >> 2)
        dc = dc.at[:, 0, 0].set((top[:, 0] + left[:, 0] + 2 * dcval + 2) >> 2)

    out = jnp.concatenate(
        [planar[:, None], dc[:, None], ang], axis=1).astype(jnp.int32)
    return out.reshape(lead + (35, s, s))


@lru_cache(maxsize=None)
def _hadamard(n):
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


@partial(jax.jit, static_argnames=("tile",))
def batched_satd(diffs, tile: int = 8):
    """SATD over (..., bh, bw) int32 via Hadamard matmuls.
    Rectangular blocks (inter PU shapes) tile the same way HM's RdCost
    walks rect PUs in 8x8 Hadamard tiles (TComRdCost.cpp:2345)."""
    bh, bw = diffs.shape[-2], diffs.shape[-1]
    t = tile if (bh % 8 == 0 and bw % 8 == 0) else 4
    h = jnp.asarray(_hadamard(t))
    shp = diffs.shape
    d = diffs.reshape(shp[:-2] + (bh // t, t, bw // t, t)).swapaxes(-3, -2)
    had = jnp.einsum("ij,...jk,kl->...il", h, d.astype(jnp.int32), h)
    sums = jnp.abs(had).sum(axis=(-1, -2))
    norm = ((sums + 2) >> 2) if t == 8 else ((sums + 1) >> 1)
    return norm.sum(axis=(-1, -2))


@partial(jax.jit, static_argnames=("bit_depth", "use_dst"))
def batched_fwd_transform(resi, bit_depth: int = 8, use_dst: bool = False):
    """Forward transform of (N, s, s) int32 residuals (matches
    transforms_ref.forward_transform)."""
    s = resi.shape[-1]
    t = jnp.asarray((DST4 if (use_dst and s == 4) else DCT[s]).astype(np.int32))
    log2 = s.bit_length() - 1
    s1 = log2 - 1 + bit_depth - 8
    s2 = log2 + 6
    r = resi.astype(jnp.int32)
    stage1 = jnp.einsum("...ij,kj->...ik", r, t)
    stage1 = (stage1 + (1 << (s1 - 1))) >> s1 if s1 > 0 else stage1 << (-s1)
    out = jnp.einsum("ki,...ij->...kj", t, stage1)
    return (out + (1 << (s2 - 1))) >> s2


@partial(jax.jit, static_argnames=("bit_depth", "log2_tr", "is_intra"))
def batched_quant(coeffs, qp: jnp.ndarray, bit_depth: int, log2_tr: int,
                  is_intra: bool = True):
    per, rem = qp // 6, qp % 6
    tshift = 15 - bit_depth - log2_tr
    q_bits = 14 + per + tshift
    scale = jnp.asarray(QUANT_SCALES.astype(np.int32))[rem]
    add = (171 if is_intra else 85) << (q_bits - 9)
    c = coeffs.astype(jnp.int32)
    level = (jnp.abs(c) * scale + add) >> q_bits
    return (jnp.sign(c) * jnp.clip(level, 0, 32767)).astype(jnp.int32)


def predict_all_modes_np(buf_u, buf_f, s: int, is_luma: bool = True,
                         bit_depth: int = 8):
    """Numpy twin of predict_all_modes for a single block (encoder search
    fast path on host).  buf_u/buf_f: (4s+1,) unfiltered/filtered refs."""
    t = angular_tables(s, is_luma)
    corner = 2 * s
    sel = np.where(t["plane"][:, None, None] == 1,
                   buf_f[t["g0"]], buf_u[t["g0"]])
    sel1 = np.where(t["plane"][:, None, None] == 1,
                    buf_f[t["g1"]], buf_u[t["g1"]])
    ang = (t["w0"] * sel + t["w1"] * sel1 + 16) >> 5
    top = buf_u[corner + 1: corner + 1 + s]
    left = buf_u[corner - s: corner][::-1]
    shift = s.bit_length() - 1
    if is_luma and s <= 16:
        maxv = (1 << bit_depth) - 1
        cv = buf_u[corner]
        ang[24, :, 0] = np.clip(top[0] + ((left - cv) >> 1), 0, maxv)
        ang[8, 0, :] = np.clip(left[0] + ((top - cv) >> 1), 0, maxv)
    # planar
    pl_plane = 1 if should_filter(PLANAR_IDX, s, is_luma) else 0
    fp = buf_f if pl_plane else buf_u
    topf = fp[corner + 1: corner + 1 + s]
    leftf = fp[corner - s: corner][::-1]
    tr = int(fp[corner + s + 1])
    bl = int(fp[corner - s - 1])
    xs = np.arange(s)
    hor = (s - 1 - xs)[None, :] * leftf[:, None] + (xs + 1)[None, :] * tr
    ver = (s - 1 - xs)[:, None] * topf[None, :] + (xs + 1)[:, None] * bl
    planar = (hor + ver + s) >> (shift + 1)
    # DC
    dcval = (int(top.sum()) + int(left.sum()) + s) >> (shift + 1)
    dc = np.full((s, s), dcval, dtype=np.int64)
    if is_luma and s <= 16:
        dc[0, :] = (top + 3 * dcval + 2) >> 2
        dc[:, 0] = (left + 3 * dcval + 2) >> 2
        dc[0, 0] = (top[0] + left[0] + 2 * dcval + 2) >> 2
    return np.concatenate([planar[None], dc[None], ang], axis=0)


def satd_all_np(diffs):
    """SATD over (M, s, s) via batched Hadamard matmuls (numpy)."""
    m, s, _ = diffs.shape
    t = 8 if s % 8 == 0 else 4
    h = _hadamard(t).astype(np.int64)
    d = diffs.reshape(m, s // t, t, s // t, t).swapaxes(2, 3)
    had = np.einsum("ij,mabjk,kl->mabil", h, d, h)
    sums = np.abs(had).sum(axis=(3, 4))
    norm = (sums + 2) >> 2 if t == 8 else (sums + 1) >> 1
    return norm.sum(axis=(1, 2))


def pack_ref_buffers(tops_u, lefts_u, tops_f, lefts_f):
    """Build (N, 2, 4s+1) ref buffers from top/left arrays (numpy)."""
    n = tops_u.shape[0]
    s = (tops_u.shape[1] - 1) // 2
    buf = np.zeros((n, 2, 4 * s + 1), dtype=np.int32)
    for pi, (tt, ll) in enumerate(((tops_u, lefts_u), (tops_f, lefts_f))):
        buf[:, pi, 2 * s] = tt[:, 0]
        buf[:, pi, 2 * s + 1:] = tt[:, 1:]
        buf[:, pi, :2 * s] = ll[:, 1:][:, ::-1]
    return buf
