"""chip_smoke.py's phase functions on the CPU at small sizes.

On the GPU host the script runs them at full width; here they run on the
CPU backend, where only main() refuses to go on."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_parity_phase_exact(bit_depth):
    assert chip_smoke.parity_phase(64, 64, bit_depth=bit_depth) == {
        4: 256, 8: 64, 16: 16, 32: 4}


@pytest.mark.parametrize("label,frames,kw", [
    ("AI", 2, dict(intra_period=1)),
    ("LDP", 3, dict(intra_period=-1, gop="ldp")),
    ("RA GOP8", 9, dict(intra_period=-1, gop="ra8")),
])
def test_encode_phase_hash_clean_and_cpu_compare(label, frames, kw):
    deployment = (label, 128, 128, frames, 8, kw)
    bs = chip_smoke.encode_phase(*deployment)   # decodes hash-clean
    assert bs[:4] == b"\x00\x00\x00\x01"
    # on a CPU-only host both sides run on the CPU backend
    assert chip_smoke.cpu_compare_phase([deployment], {label: bs}) == {
        label: True}


def test_four_card_phase_on_virtual_devices():
    """The --four path on four of the CPU test mesh's virtual devices."""
    bs = chip_smoke.four_card_phase(w=128, h=256)
    assert bs[:4] == b"\x00\x00\x00\x01"


def test_main_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "JAX finds no GPU" in r.stderr
    last = r.stdout.strip().splitlines()[-1:] or [""]
    with pytest.raises(json.JSONDecodeError):
        json.loads(last[0])
