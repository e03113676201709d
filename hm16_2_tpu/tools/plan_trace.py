"""Device time of the plan programs, and the route XLA takes for their
integer matmuls.

    python -m hm16_2_tpu.tools.plan_trace [--size 1920x1080] [--frames 9]
        [--out plan_trace_out]

1. Compiles intra_rd._plan_device and inter_plan._plan_device (P and B) at
   the deployment's shapes (RA Main10, QP32) and classifies every `dot`
   of the optimized HLO by the route XLA chose: a cuBLAS custom call, a
   Triton gemm fusion, or a dot emitted inside an ordinary XLA fusion.
2. Encodes the clip once through encode_stream (compiles), then again
   under jax.profiler.trace, and reduces the trace of device 0: busy time
   (union of kernel intervals) over the window, time per kernel, and the
   time of the kernels that hold a dot.

Prints one JSON line; the per-kernel table and every dot of the compiled
programs go to --out (the raw trace is deleted after the reduction).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import shutil
import time


_COMP = re.compile(r"^(?:ENTRY )?%?([\w.\-]+) \(.*\) -> .* \{$")
_INSTR = re.compile(r"^\s*(?:ROOT )?%?([\w.\-]+) = (\S+?) ([\w\-]+)\(")


def dot_routes(hlo_text: str) -> list[dict]:
    """Every dot / gemm of an optimized HLO module with the route that
    computes it: 'cublas' (custom call), 'triton_gemm' (fusion handed to
    Triton's gemm emitter) or 'xla_fusion:<kind>' (XLA's own emitter)."""
    comp = None
    callers = {}          # fused computation -> (fusion name, route)
    found = []
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name, shape, op = m.groups()
        if op == "fusion":
            called = re.search(r"calls=%?([\w.\-]+)", line)
            kind = re.search(r"kind=(k\w+)", line)
            route = ("triton_gemm" if "triton_gemm" in line
                     or "__triton" in line else
                     f"xla_fusion:{kind.group(1) if kind else '?'}")
            if called:
                callers[called.group(1)] = (name, route)
        elif op == "dot" or (op == "custom-call" and "cublas" in line):
            src = re.findall(r"jit\((\w+)\)", line)
            found.append({"op": name, "comp": comp, "shape": shape,
                          "cublas": op == "custom-call",
                          "source": src[-1] if src else "?"})
    for d in found:
        comp = d.pop("comp")
        if d.pop("cublas"):
            d["kernel"], d["route"] = d["op"], "cublas"
        else:
            d["kernel"], d["route"] = callers.get(comp, (d["op"], "unfused"))
    return found


def _device_events(xspace_path: str):
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xspace_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    if not planes:
        planes = [p for p in pd.planes if p.name.startswith("/device:")]
    events, line_names = [], collections.Counter()
    for plane in planes[:1]:
        for line in plane.lines:
            evs = list(line.events)
            line_names[line.name] += len(evs)
            if "stream" not in line.name.lower():
                continue
            for ev in evs:
                stats = {}
                try:
                    stats = {k: v for k, v in ev.stats}
                except (TypeError, ValueError):
                    pass
                events.append((ev.name, ev.start_ns, ev.duration_ns,
                               str(stats.get("hlo_op", ""))))
    return events, dict(line_names), [p.name for p in pd.planes]


def _busy_ns(events) -> float:
    iv = sorted((s, s + d) for _, s, d, _ in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--out", default="plan_trace_out")
    a = ap.parse_args(argv)
    w, h = (int(v) for v in a.size.split("x"))
    os.makedirs(a.out, exist_ok=True)

    import jax

    from hm16_2_tpu.encode import inter_plan, intra_rd
    from hm16_2_tpu.encode.top import Encoder, EncoderConfig
    from hm16_2_tpu.tools.realclip import make_clip

    dev = jax.devices()[0]
    bd, qp = 10, 32
    args, kw = intra_rd.zero_inputs(h, w, bd, qp)
    programs = {"intra_plan": intra_rd._plan_device.lower(*args, **kw)}
    for is_b in (False, True):
        args, kw = inter_plan.zero_inputs(h, w, bd, is_b, qp)
        programs["inter_plan_" + ("b" if is_b else "p")] = \
            inter_plan._plan_device.lower(*args, **kw)
    routes, dot_kernels = {}, set()
    for name, low in programs.items():
        t0 = time.perf_counter()
        dots = dot_routes(low.compile().as_text())
        with open(os.path.join(a.out, f"{name}.dots.json"), "w") as f:
            json.dump(dots, f, indent=1)
        dot_kernels |= {d["kernel"] for d in dots}
        routes[name] = {
            "compile_s": round(time.perf_counter() - t0, 3),
            "n_dots": len(dots),
            "by_route": dict(collections.Counter(d["route"] for d in dots)),
            "by_result_dtype": dict(collections.Counter(
                d["shape"].split("[")[0] for d in dots)),
            "by_source": dict(collections.Counter(
                f'{d["source"]}:{d["route"]}' for d in dots)),
        }

    clip = make_clip(w, h, a.frames, bit_depth=bd)

    def encode():
        enc = Encoder(EncoderConfig(w, h, qp=qp, bit_depth=bd,
                                    intra_period=-1, gop="ra8"))
        t0 = time.perf_counter()
        bs = b"".join(enc.encode_stream([[p.copy() for p in f]
                                         for f in clip]))
        return time.perf_counter() - t0, enc.stage_ms, len(bs)

    encode()                                   # compile outside the window
    tdir = os.path.join(a.out, "trace")
    with jax.profiler.trace(tdir):
        wall, stages, nbytes = encode()
    xs = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                          recursive=True))
    events, line_names, plane_names = _device_events(xs[-1])
    shutil.rmtree(tdir)
    per_kernel = collections.defaultdict(lambda: [0, 0.0, ""])
    for name, _, dur, hlo_op in events:
        k = per_kernel[name]
        k[0] += 1
        k[1] += dur
        k[2] = hlo_op
    busy = _busy_ns(events)
    norm = lambda s: re.sub(r"[.\-]", "_", s)        # noqa: E731
    dot_norm = {norm(k) for k in dot_kernels}
    dot_ns = sum(v[1] for n, v in per_kernel.items()
                 if norm(n) in dot_norm or norm(v[2]) in dot_norm)
    table = sorted(((v[1], n, v[0], v[2]) for n, v in per_kernel.items()),
                   reverse=True)
    with open(os.path.join(a.out, "kernels.json"), "w") as f:
        json.dump({"planes": plane_names, "lines": line_names,
                   "kernels": [{"name": n, "calls": c, "device_ms": t / 1e6,
                                "hlo_op": op}
                               for t, n, c, op in table]}, f, indent=1)
    print(json.dumps({
        "platform": dev.platform, "device_kind": dev.device_kind,
        "size": a.size, "frames": a.frames, "dot_routes": routes,
        "window_s": round(wall, 4), "bytes": nbytes,
        "stage_ms": {k: round(v, 1) for k, v in stages.items()},
        "device_busy_s": round(busy / 1e9, 4),
        "device_idle_share": round(1 - busy / 1e9 / wall, 4),
        "dot_kernel_device_s": round(dot_ns / 1e9, 4),
        "top_kernels": [(n, round(t / 1e6, 2), c) for t, n, c, _ in
                        table[:12]],
    }))


if __name__ == "__main__":
    main()
