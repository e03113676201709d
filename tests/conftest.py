import os
import subprocess
import sys

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without accelerator hardware (chip_smoke.py runs the GPU path, and
# `chip_smoke.py --four` the four-card mesh).  Force, don't setdefault: on a
# GPU host JAX would otherwise pick the card, and the env var AND the
# config are both set in case JAX was configured before this file ran.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
import jax  # noqa: E402  (must come after the env setup above)

jax.config.update("jax_platforms", "cpu")

# Golden fixtures: auto-regenerate on a clean machine when the reference
# HM binaries are available (tests/make_fixtures.py, rng seed 42).
_DATA = "/tmp/hevc_data"
if not os.path.exists(os.path.join(_DATA, "tiny64_ai.bin")) and \
        os.path.exists("/tmp/hmref/bin/TAppEncoderStatic"):
    subprocess.run(
        [sys.executable,
         os.path.join(os.path.dirname(__file__), "make_fixtures.py"),
         "--data-dir", _DATA],
        check=True)
