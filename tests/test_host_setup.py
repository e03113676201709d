"""What the program decides about its host: the device the plans run on,
the compile-cache directory, the native build, the multi-device dry run,
and the plan programs' freedom from float matmuls (no TF32 exposure)."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from hm16_2_tpu import native
from hm16_2_tpu.encode import inter_plan, intra_rd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pick_device_is_jax_default():
    assert intra_rd._pick_device() == jax.devices()[0]


@pytest.mark.parametrize("which", ["device", "platform"])
def test_pick_device_follows_default_device(which):
    cpu = jax.devices("cpu")
    want = cpu[-1] if which == "device" else cpu[0]
    with jax.default_device(want if which == "device" else "cpu"):
        assert intra_rd._pick_device() == want


def _cache_settings(tmp_path, env_dir, platforms="cpu"):
    """(cache directory, min compile seconds to persist) that ensure_cache
    sets in a fresh process (its one-shot flag must not leak)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["HOME"] = str(tmp_path / "home")
    env["JAX_PLATFORMS"] = platforms
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    # no backend is initialised: a GPU platform name is only read
    code = ("from hm16_2_tpu._jaxcache import ensure_cache; ensure_cache(); "
            "import jax; print(jax.config.jax_compilation_cache_dir); "
            "print(jax.config.jax_persistent_cache_min_compile_time_secs)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    assert not os.path.exists(tmp_path / "home")
    d, secs = r.stdout.strip().splitlines()[-2:]
    return d, float(secs)


@pytest.mark.parametrize("env_dir", [True, False])
def test_ensure_cache_directory(tmp_path, env_dir):
    want = str(tmp_path / "cache") if env_dir else os.path.join(
        ROOT, ".jax_cache")
    d, _ = _cache_settings(tmp_path, want if env_dir else None)
    assert d == want
    assert os.path.isdir(want)


@pytest.mark.parametrize("env_dir,platforms,persists_cpu", [
    (True, "cpu", False),       # a shared directory gets no CPU programs
    (True, "cuda,cpu", True),   # GPU programs are written; phase 5 of
                                # chip_smoke.py opts its CPU ones out
    (False, "cpu", True),       # the checkout's own directory
])
def test_ensure_cache_keeps_cpu_programs_out_of_shared_dirs(
        tmp_path, env_dir, platforms, persists_cpu):
    _, secs = _cache_settings(
        tmp_path, str(tmp_path / "cache") if env_dir else None, platforms)
    assert (secs < 60) == persists_cpu


def test_cpu_programs_not_persisted_restores_threshold():
    from hm16_2_tpu import _jaxcache
    before = jax.config.jax_persistent_cache_min_compile_time_secs
    with _jaxcache.cpu_programs_not_persisted():
        assert jax.config.jax_persistent_cache_min_compile_time_secs >= 1e9
    assert jax.config.jax_persistent_cache_min_compile_time_secs == before


def test_native_lib_name_tracks_source_flags_and_cpu(tmp_path):
    a, b = tmp_path / "a.cpp", tmp_path / "b.cpp"
    a.write_text("int f() { return 1; }\n")
    b.write_text("int f() { return 2; }\n")
    base = native.lib_path(str(a), cpu_flags="flags : sse2")
    assert native.lib_path(str(a), cpu_flags="flags : sse2") == base
    assert native.lib_path(str(b), cpu_flags="flags : sse2") != base
    assert native.lib_path(str(a), native.CXXFLAGS + ("-DX",),
                           cpu_flags="flags : sse2") != base
    assert native.lib_path(str(a), cpu_flags="flags : sse2 avx512f") != base
    assert os.path.dirname(base) == native.BUILD_DIR
    # the loaded libraries are this host's builds of the current sources
    assert native.get_dsp()._name == native.lib_path(native._SRC_DSP)
    assert native.get_lib()._name == native.lib_path(native._SRC)


def test_native_build_failure_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build(str(bad))
    assert not os.path.exists(native.lib_path(str(bad)))


def test_dryrun_multichip_needs_the_devices_it_asks_for():
    from __graft_entry__ import dryrun_multichip
    with pytest.raises(RuntimeError, match="needs"):
        dryrun_multichip(len(jax.devices()) + 1)


_DOT = re.compile(r"stablehlo\.dot_general.*$", re.M)


def _float_dots(lowered):
    dots = _DOT.findall(lowered.as_text())
    return dots, [d for d in dots if re.search(r"x(f32|bf16|f16|f64)>", d)]


def test_intra_plan_has_no_float_matmul():
    args, kw = intra_rd.zero_inputs(64, 64, 8)
    dots, float_dots = _float_dots(intra_rd._plan_device.lower(*args, **kw))
    assert dots and not float_dots, float_dots


@pytest.mark.parametrize("is_b", [False, True])
def test_inter_plan_has_no_float_matmul(is_b):
    args, kw = inter_plan.zero_inputs(64, 64, 8, is_b)
    dots, float_dots = _float_dots(inter_plan._plan_device.lower(*args,
                                                                 **kw))
    assert dots and not float_dots, float_dots


def test_realclip_photo_matches_the_jpeg(tmp_path, monkeypatch):
    """The stored RGB array gives bit-identical clips to decoding the
    photograph matplotlib ships."""
    matplotlib = pytest.importorskip("matplotlib")
    image = pytest.importorskip("PIL.Image")
    from hm16_2_tpu.tools import realclip
    w, h, n = 96, 64, 3
    stored = realclip.make_clip(w, h, n, bit_depth=10)
    jpg = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                       "sample_data", "grace_hopper.jpg")
    decoded_npz = tmp_path / "decoded.npz"
    np.savez(decoded_npz, rgb=np.asarray(image.open(jpg).convert("RGB")))
    monkeypatch.setattr(realclip, "_PHOTO", str(decoded_npz))
    monkeypatch.setattr(realclip, "_cache", {})
    decoded = realclip.make_clip(w, h, n, bit_depth=10)
    for fs, fd in zip(stored, decoded):
        for ps, pd in zip(fs, fd):
            np.testing.assert_array_equal(ps, pd)
