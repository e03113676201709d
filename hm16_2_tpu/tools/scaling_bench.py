"""Multi-device scaling measurement over the default backend's devices
(SURVEY.md §5 / BASELINE scaling target).

Times the two sharded device stages — the row-sharded intra frame plan
(ppermute top-halo exchange) and the row-banded inter ME (reference
all_gather) — at 1/2/4/8 mesh devices and prints one JSON line per
stage.  On a multi-GPU host the same code path runs across the cards;
on a CPU-only box the mesh is XLA's host-platform device partition
(run with XLA_FLAGS=--xla_force_host_platform_device_count=8), so the
numbers are a plumbing/overhead curve, not a physical-chip speedup.

Usage: python -m hm16_2_tpu.tools.scaling_bench [--size WxH] [-n iters]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="256x128")
    ap.add_argument("-n", type=int, default=3)
    a = ap.parse_args(argv)
    w, h = (int(v) for v in a.size.split("x"))

    import jax

    from hm16_2_tpu.encode import inter_me, intra_rd
    from hm16_2_tpu.encode.top import EncoderConfig, build_sps_pps
    from hm16_2_tpu.parallel.frame_shard import (
        make_row_mesh, sharded_plan_frame)
    from hm16_2_tpu.parallel.me_shard import sharded_me_frame

    devices = jax.devices()

    cfg = EncoderConfig(w, h, qp=32, intra_period=1)
    sps, _ = build_sps_pps(cfg)
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    planes = [y, cb, cb.copy()]
    ref = np.roll(y, 2, axis=1)
    lam = 57.9

    counts = [n for n in (1, 2, 4, 8)
              if n <= len(devices) and h % (n * 64) == 0]
    for stage in ("intra_plan", "inter_me"):
        results = {}
        for n_dev in counts:
            mesh = make_row_mesh(devices[:n_dev])
            if stage == "intra_plan":
                def run():
                    return sharded_plan_frame(mesh, planes, sps, 32, lam,
                                              1.0, (32, 32))
            else:
                import jax.numpy as jnp
                cur = jnp.asarray(y)
                refs = jnp.asarray(ref)[None]
                mvp8 = jnp.zeros((1, h // 8, w // 8, 2), jnp.int32)

                def run():
                    out = sharded_me_frame(mesh, cur, refs, mvp8,
                                           jnp.float32(7.0), h, w)
                    jax.block_until_ready(out)
                    return out
            run()                                  # compile
            t0 = time.time()
            for _ in range(a.n):
                run()
            results[n_dev] = round((time.time() - t0) / a.n * 1000, 2)
        base = results.get(1)
        print(json.dumps({
            "stage": stage, "size": a.size, "ms_per_frame": results,
            "platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "efficiency_vs_1dev": {
                str(n): round(base / (results[n] * n), 3)
                for n in results if base},
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
