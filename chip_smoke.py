"""Smoke test of the encoder's main path on one NVIDIA GPU.

    python chip_smoke.py           # phases 1-5 on one card
    python chip_smoke.py --four    # only the four-card row-sharded dry run

Phases (each raises on failure, so any failure exits non-zero):

1. device: JAX's devices, and the card's name and power limit from
   nvidia-smi.  Exits non-zero when JAX finds no GPU.
2. native: the host C++ commit/CABAC libraries are built for this host
   and loaded (without them the commit silently becomes pure Python).
3. parity: every device op of the intra plan (35-mode prediction,
   Hadamard SATD, forward transform + quant, dequant + inverse transform)
   on a full 1920x1080 frame's worth of blocks per TU size 4/8/16/32,
   against the repo's numpy references.  Integer math: exact equality.
4. encode: `Encoder.encode_stream` on HM's cfg-set deployments (416x240
   AI / LDP / RA GOP8 at QP32, and 1920x1080 RA Main10), each decoded by
   the repo's decoder with every picture's hash SEI checked.
5. cpu vs gpu: the 416x240 streams encoded again on the CPU backend of
   the same process; byte identity is reported (the plan's float32 cost
   arithmetic may round differently), every stream must decode clean.

The last line of stdout is one JSON object naming the device.  Content is
generated from a seed (tools/realclip.py); nothing is read from outside
the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FULL_W, FULL_H = 1920, 1080
QP = 32
# (label, width, height, frames, bit depth, EncoderConfig keywords); the
# shapes of HM's cfg set: encoder_intra_main / encoder_lowdelay_P_main /
# encoder_randomaccess_main / encoder_randomaccess_main10
DEPLOYMENTS = (
    ("416x240 AI", 416, 240, 8, 8, dict(intra_period=1)),
    ("416x240 LDP", 416, 240, 9, 8, dict(intra_period=-1, gop="ldp")),
    ("416x240 RA GOP8", 416, 240, 17, 8, dict(intra_period=-1, gop="ra8")),
    ("1920x1080 RA Main10", 1920, 1080, 9, 10,
     dict(intra_period=-1, gop="ra8")),
)
_BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"


def say(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def device_phase(min_count: int = 1):
    import jax
    devs = jax.devices()
    d = devs[0]
    say(f"[device] jax.devices() = {devs}")
    say(f"[device] platform={d.platform} device_kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        raise SystemExit(f"JAX finds no GPU (default platform {d.platform})")
    if len(devs) < min_count:
        raise SystemExit(f"needs {min_count} GPUs, JAX finds {len(devs)}")
    # nvidia-smi runs as a child that does not import JAX
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    say("[device] nvidia-smi name, power.limit:")
    for ln in r.stdout.strip().splitlines():
        say(ln)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# phase 2: native engine
# ---------------------------------------------------------------------------

def native_phase():
    from hm16_2_tpu import native
    t0 = time.perf_counter()
    lib, dsp = native.get_lib(), native.get_dsp()
    if lib is None or dsp is None:
        raise RuntimeError("native libraries unavailable (HM16_NO_NATIVE?)")
    say(f"[native] {lib._name}")
    say(f"[native] {dsp._name}")
    say(f"[native] build+load {time.perf_counter() - t0:.3f} s")


# ---------------------------------------------------------------------------
# phase 3: op parity at real widths
# ---------------------------------------------------------------------------

def _edges(buf, s):
    """(top, left) arrays of intra_ref's layout from (..., 4s+1) buffers."""
    top = buf[..., 2 * s:]
    left = buf[..., 2 * s::-1]
    return top.astype(np.int64), left.astype(np.int64)


def _check_equal(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.argwhere(got != want)[:3].tolist()
               if got.shape == want.shape else "shape")
        raise AssertionError(
            f"{what}: device {got.shape} != reference {want.shape} at {bad}")


def parity_phase(w=FULL_W, h=FULL_H, bit_depth=8, qp=QP):
    """Device ops vs numpy references on every aligned block of a w x h
    luma frame, per TU size.  Returns {size: n_blocks}."""
    import jax
    import jax.numpy as jnp

    from hm16_2_tpu.encode import intra_rd
    from hm16_2_tpu.ops import analysis, intra_ref, transforms_ref
    from hm16_2_tpu.tools.realclip import make_clip

    plane = make_clip(w, h, 1, bit_depth=bit_depth)[0][0]
    qp_luma = qp + 6 * (bit_depth - 8)
    out = {}
    say(f"[parity] {w}x{h} luma, {bit_depth}-bit, QP{qp}; tolerance: exact "
        "equality (integer arithmetic)")
    for s in (4, 8, 16, 32):
        t0 = time.perf_counter()
        log2 = s.bit_length() - 1
        use_dst = s == 4
        bufs, blocks, _, _ = intra_rd._ref_buffers(
            plane, s, bit_depth, True, h, w)
        n = len(blocks)
        # 35-mode prediction of every block against intra_ref's filter and
        # predictors (run over all blocks at once)
        preds_d = analysis.predict_all_modes(jnp.asarray(bufs), s, True,
                                             bit_depth)
        preds = np.asarray(preds_d)
        top, left = _edges(bufs[:, 0], s)
        top_f, left_f = intra_ref.filter_reference_samples(
            top, left, s, bit_depth, True)
        _check_equal(f"ref filter s={s}", _edges(bufs[:, 1], s),
                     (top_f, left_f))
        for mode in range(35):
            t, l = ((top_f, left_f) if intra_ref.should_filter(mode, s, True)
                    else (top, left))
            _check_equal(f"predict_all_modes s={s} mode {mode}",
                         preds[:, mode],
                         intra_ref.predict_intra(mode, t, l, s, bit_depth,
                                                 True))
        # one residual per block, cycling through all 35 modes
        modes = np.arange(n) % 35
        resi_d = (jnp.asarray(blocks)
                  - preds_d[jnp.arange(n), jnp.asarray(modes)])
        resi = blocks.astype(np.int64) - preds[np.arange(n), modes]
        _check_equal(f"batched_satd s={s}",
                     analysis.batched_satd(resi_d),
                     analysis.satd_all_np(resi))
        fwd_d = analysis.batched_fwd_transform(resi_d, bit_depth, use_dst)
        fwd = transforms_ref.forward_transform(resi, bit_depth, use_dst)
        _check_equal(f"batched_fwd_transform s={s}", fwd_d, fwd)
        lvl_d = analysis.batched_quant(fwd_d, qp_luma, bit_depth, log2, True)
        lvl = transforms_ref.quant(fwd, qp_luma, bit_depth, log2, True)
        _check_equal(f"batched_quant s={s}", lvl_d, lvl)
        deq_d = intra_rd.batched_dequant(lvl_d, qp_luma, bit_depth, log2)
        deq = transforms_ref.dequant(lvl, qp_luma, bit_depth, log2)
        _check_equal(f"batched_dequant s={s}", deq_d, deq)
        inv_d = intra_rd.batched_inv_transform(deq_d, bit_depth, use_dst)
        inv = transforms_ref.inverse_transform(deq, bit_depth, use_dst)
        _check_equal(f"batched_inv_transform s={s}", inv_d, inv)
        jax.block_until_ready(inv_d)
        say(f"[parity] TU{s}: {n} blocks x 35 modes predict_all_modes, "
            "satd, fwd_transform, quant, dequant, inv_transform: exact  "
            f"({time.perf_counter() - t0:.2f} s)")
        out[s] = n
    return out


# ---------------------------------------------------------------------------
# phase 4: end-to-end encodes
# ---------------------------------------------------------------------------

class CompileClock:
    """Seconds in JAX's compile-or-load step (XLA compile, or a load from
    the persistent cache) inside the block: one event per program, so
    nothing is counted twice.  Tracing and lowering are not in it; the
    first call's wall time minus the steady call's covers all of it."""

    def __enter__(self):
        import jax
        self.seconds = 0.0

        def on_event(event, duration, **_):
            if event == _BACKEND_COMPILE:
                self.seconds += duration
        self._cb = on_event
        jax.monitoring.register_event_duration_secs_listener(on_event)
        return self

    def __exit__(self, *exc):
        import jax
        jax.monitoring.unregister_event_duration_listener(self._cb)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def decode_check(label, bs, frames):
    """Decode with the repo's decoder; every picture's hash must match."""
    from hm16_2_tpu.decode.top import Decoder
    t0 = time.perf_counter()
    pics = Decoder().decode_stream(bs)
    ok = [p.hash_ok for p in pics]
    if len(pics) != frames or not all(v is True for v in ok):
        raise AssertionError(f"{label}: decoded {len(pics)}/{frames} "
                             f"pictures, hash_ok={ok}")
    say(f"[decode] {label}: {frames} pictures, hash_ok all True "
        f"({time.perf_counter() - t0:.2f} s)")


def encode_once(w, h, clip, bit_depth, cfg_kw):
    from hm16_2_tpu.encode.top import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(w, h, qp=QP, bit_depth=bit_depth, **cfg_kw))
    with CompileClock() as cc:
        t0 = time.perf_counter()
        # encode_stream yields an access unit only after that picture's
        # plan was fetched to the host (a blocking copy), so the clock
        # stops after the last device result arrived
        bs = b"".join(enc.encode_stream([[p.copy() for p in f]
                                         for f in clip]))
        wall = time.perf_counter() - t0
    return bs, wall, cc.seconds, dict(enc.stage_ms)


def encode_phase(label, w, h, frames, bit_depth, cfg_kw, repeat=2):
    """Encode a generated clip `repeat` times through encode_stream (the
    first call compiles), decode it, and return the stream."""
    from hm16_2_tpu.tools.realclip import make_clip
    clip = make_clip(w, h, frames, bit_depth=bit_depth)
    streams, walls = [], []
    for rep in range(repeat):
        bs, wall, comp, stages = encode_once(w, h, clip, bit_depth, cfg_kw)
        streams.append(bs)
        walls.append(wall)
        kind = "first call" if rep == 0 else "steady"
        per_frame = {k: round(v / frames, 2) for k, v in stages.items()}
        say(f"[encode] {label} {kind}: {wall:.3f} s wall for {frames} "
            f"frames ({frames / wall:.3f} fps), XLA compile/load "
            f"{comp:.3f} s, {len(bs)} bytes")
        say(f"[encode] {label} {kind} stage_ms per frame: "
            f"{json.dumps(per_frame)}")
        say(f"[encode] {label} peak_bytes_in_use so far: {_peak_bytes()}")
    if repeat > 1:
        say(f"[encode] {label} first call minus steady: "
            f"{walls[0] - walls[-1]:.3f} s (trace, lower, compile or load)")
    if any(s != streams[0] for s in streams):
        raise AssertionError(f"{label}: repeated encodes differ")
    decode_check(label, streams[0], frames)
    return streams[0]


# ---------------------------------------------------------------------------
# phase 5: the same encodes on the CPU backend
# ---------------------------------------------------------------------------

def cpu_compare_phase(deployments, accel_streams):
    """Re-encode on the CPU backend of this process and report byte
    identity with `accel_streams` ({label: bytes}).  Differences are
    reported, not failed; every stream must decode hash-clean.  CPU
    programs compiled here are kept out of the persistent cache (its key
    does not cover the host's CPU features)."""
    import jax

    from hm16_2_tpu._jaxcache import cpu_programs_not_persisted
    from hm16_2_tpu.tools.realclip import make_clip
    same = {}
    with jax.default_device(jax.devices("cpu")[0]), \
            cpu_programs_not_persisted():
        for label, w, h, frames, bd, kw in deployments:
            clip = make_clip(w, h, frames, bit_depth=bd)
            bs, wall, comp, _ = encode_once(w, h, clip, bd, kw)
            ref = accel_streams[label]
            same[label] = bs == ref
            say(f"[cpu-vs-gpu] {label}: identical={bs == ref} "
                f"gpu={len(ref)} bytes cpu={len(bs)} bytes "
                f"(cpu encode {wall:.3f} s, XLA compile/load {comp:.3f} s)")
            if bs != ref:
                decode_check(f"{label} (cpu)", bs, frames)
    return same


# ---------------------------------------------------------------------------

def four_card_phase(w=1920, h=1024, n_devices=4):
    """`dryrun_multichip`: the RA GOP prefix encoded row-sharded over
    n_devices cards and unsharded, byte-identical and hash-clean."""
    from __graft_entry__ import dryrun_multichip
    t0 = time.perf_counter()
    with CompileClock() as cc:
        bs = dryrun_multichip(n_devices, w=w, h=h)
    say(f"[four] {w}x{h} RA GOP prefix: row-sharded over {n_devices} "
        f"devices == unsharded, {len(bs)} bytes, 5 pictures hash_ok "
        f"({time.perf_counter() - t0:.1f} s, XLA compile/load "
        f"{cc.seconds:.1f} s)")
    return bs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card row-sharded dry run")
    a = ap.parse_args(argv)
    # phase 5 needs the CPU backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    t_start = time.perf_counter()
    device = device_phase(4 if a.four else 1)
    if a.four:
        four_card_phase()
    else:
        native_phase()
        for bd in (8, 10):
            parity_phase(bit_depth=bd)
        streams = {}
        for label, w, h, frames, bd, kw in DEPLOYMENTS:
            streams[label] = encode_phase(label, w, h, frames, bd, kw)
        cpu_compare_phase([d for d in DEPLOYMENTS if d[1] == 416], streams)
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
