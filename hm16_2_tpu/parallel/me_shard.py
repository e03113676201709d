"""Row-sharded inter motion estimation over a device mesh.

The current frame's rows are banded across the `row` mesh axis; each
device all-gathers the reference planes (SURVEY.md §5's
reference-picture-window exchange) and runs the SAME dense ME program
(encode/inter_me.me_frame) on its band.  Every distortion in me_frame is
an exact integer sum, so the concatenated band grids are bit-identical
to the whole-frame evaluation — asserted by __graft_entry__'s LDP
dry-run and tests.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from hm16_2_tpu._jaxcache import ensure_cache

ensure_cache()

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from hm16_2_tpu.encode import inter_me
from hm16_2_tpu.encode.inter_me import MePlan, me_frame

_SIZES = (8, 16, 32, 64)


def shardable(mesh, h: int) -> bool:
    return h % (mesh.devices.size * 64) == 0


_STEP_CACHE: dict = {}


def sharded_me_frame(mesh, cur, refs, mvp8, lam, h: int, w: int):
    """me_frame with the current frame row-banded over `mesh` and the
    references all-gathered inside the shard."""
    n_dev = mesh.devices.size
    band = h // n_dev

    key = (tuple(id(d) for d in mesh.devices.flat), h, w,
           tuple(refs.shape))
    fn = _STEP_CACHE.get(key)
    if fn is None:
        def step(cur_band, refs_band, mvp_band, lam_):
            refs_full = jax.lax.all_gather(refs_band, "row", axis=1,
                                           tiled=True)
            row0 = jax.lax.axis_index("row") * band
            out = me_frame(cur_band, refs_full, mvp_band, lam_, row0,
                           h=band, w=w, full_h=h)
            return tuple(out[s] for s in _SIZES)

        # jitted: an eager shard_map dispatches (and compiles) op by op
        fn = jax.jit(jax.shard_map(
            step, mesh=mesh,
            in_specs=(P("row", None), P(None, "row", None),
                      P(None, "row", None, None), P()),
            out_specs=tuple((P(None, "row", None), P(None, "row"))
                            for _ in _SIZES),
            check_vma=False))
        _STEP_CACHE[key] = fn
    outs = fn(cur, refs, mvp8, lam)
    return {s: outs[i] for i, s in enumerate(_SIZES)}


def sharded_submit_me(mesh, cur_y, ref_lists, prev_mv8, lam_sqrt, h, w):
    """Drop-in dual of inter_me.submit_me running the banded program."""
    uniq = []
    keymap = {}
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
    refs = jnp.stack([jnp.asarray(p[:h, :w], jnp.int32) for _, p in uniq])
    cur = jnp.asarray(cur_y[:h, :w], jnp.int32)
    if prev_mv8 is None:
        mvp8 = jnp.zeros((refs.shape[0], h // 8, w // 8, 2), jnp.int32)
    else:
        mvp8 = jnp.broadcast_to(
            jnp.asarray(prev_mv8, jnp.int32)[None],
            (refs.shape[0], h // 8, w // 8, 2))
    res = sharded_me_frame(mesh, cur, refs, mvp8, jnp.float32(lam_sqrt),
                           h, w)

    def fetch():
        plan = MePlan(h, w)
        for s, (mv, cost) in res.items():
            mvn = np.asarray(mv)
            costn = np.asarray(cost)
            for (lx, r_idx), j in keymap.items():
                plan.grids[(lx, r_idx, s)] = (mvn[j], costn[j])
        return plan

    return fetch
