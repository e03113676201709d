"""Real-content test clips from a real photograph.

The BD-rate harness historically ran on procedural noise+sinusoid frames,
whose skip/bi statistics do not match camera content.  This module
synthesises video with *real camera statistics* by panning/zooming a
window over an actual photograph (the US Navy's public-domain portrait of
Grace Hopper, as matplotlib ships it - natural textures, skin, fabric,
specular highlights, sharp edges) with smooth sub-pixel global motion
plus a slow zoom, which is exactly the motion model of a camera
dolly/pan shot.  Luma/chroma are BT.601 full->limited range, 4:2:0
co-sited averaging.  The photograph's decoded 8-bit RGB is stored beside
this module (grace_hopper_rgb.npz), so numpy and scipy are all it needs.

Mirrors the role of HM's per-sequence camera clips
(cfg/per-sequence/BasketballDrill.cfg etc.) as far as is possible with
zero network egress.
"""

import os

import numpy as np

_PHOTO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "grace_hopper_rgb.npz")

_cache = {}


def _photo_ycbcr():
    """Load the source photograph as float BT.601 YCbCr (limited range)."""
    if "photo" in _cache:
        return _cache["photo"]
    with np.load(_PHOTO) as z:
        rgb = z["rgb"].astype(np.float64) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16 + 219 * (0.299 * r + 0.587 * g + 0.114 * b)
    cb = 128 + 224 * (-0.168736 * r - 0.331264 * g + 0.5 * b)
    cr = 128 + 224 * (0.5 * r - 0.418688 * g - 0.081312 * b)
    # Tile 2x2 with mirror so pans can wander beyond the frame without a
    # visible seam (keeps gradients continuous).
    def tile(p):
        row = np.concatenate([p, p[:, ::-1]], axis=1)
        return np.concatenate([row, row[::-1]], axis=0)
    out = (tile(y), tile(cb), tile(cr))
    _cache["photo"] = out
    return out


def _sample(plane, y0, x0, h, w, zoom):
    """Bilinear sample an (h, w) window at sub-pixel offset/zoom."""
    from scipy import ndimage
    ys = y0 + np.arange(h) * zoom
    xs = x0 + np.arange(w) * zoom
    yy, xx = np.meshgrid(ys % plane.shape[0], xs % plane.shape[1],
                         indexing="ij")
    return ndimage.map_coordinates(plane, [yy, xx], order=1, mode="wrap")


def make_clip(w, h, frames, bit_depth=8, pan=(1.7, 0.9), zoom_rate=0.0015,
              seed=7):
    """Pan/zoom clip over the photograph: list of [Y, U, V] int32 planes.

    pan is the per-frame (dx, dy) in source pixels (sub-pixel => the
    encoder must use fractional MC to follow it); zoom_rate is the
    per-frame scale change (slow dolly).  A small smooth jitter is added
    so the global motion is not perfectly constant.
    """
    yp, cbp, crp = _photo_ycbcr()
    rng = np.random.default_rng(seed)
    jit = rng.standard_normal((frames, 2)).cumsum(axis=0) * 0.15
    sh = bit_depth - 8
    base_zoom = min(yp.shape[0] / (h * 1.35), yp.shape[1] / (w * 1.35))
    base_zoom = min(base_zoom, 1.0) if base_zoom >= 1.0 else base_zoom
    out = []
    for t in range(frames):
        zoom = base_zoom * (1.0 + zoom_rate * t)
        x0 = 40 + pan[0] * t + jit[t, 0]
        y0 = 60 + pan[1] * t + jit[t, 1]
        y = _sample(yp, y0, x0, h, w, zoom)
        cb = _sample(cbp, y0, x0, h, w, zoom)
        cr = _sample(crp, y0, x0, h, w, zoom)
        # 4:2:0 co-sited average downsample
        cb = cb.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        cr = cr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        mx = (1 << (8 + sh)) - 1
        planes = [np.clip(np.rint(p * (1 << sh)), 0, mx).astype(np.int32)
                  for p in (y, cb, cr)]
        out.append(planes)
    return out


def write_yuv(path, clip, bit_depth=8):
    dt = np.uint8 if bit_depth == 8 else np.uint16
    with open(path, "wb") as f:
        for planes in clip:
            for p in planes:
                f.write(p.astype(dt).tobytes())


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--size", default="416x240")
    ap.add_argument("--frames", type=int, default=17)
    ap.add_argument("--bit-depth", type=int, default=8)
    a = ap.parse_args()
    w, h = map(int, a.size.split("x"))
    write_yuv(a.out, make_clip(w, h, a.frames, a.bit_depth), a.bit_depth)
    print(f"wrote {a.out}: {w}x{h} x{a.frames} @{a.bit_depth}bit")
