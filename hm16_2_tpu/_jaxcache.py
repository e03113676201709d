"""Persistent XLA compilation cache setup (imported lazily by modules that
jit).  Avoids recompiling the plan programs in every process.

The cache lives where JAX_COMPILATION_CACHE_DIR says when it is set, and
otherwise at a fixed path inside the checkout (`<repo>/.jax_cache`,
gitignored): the directory is part of what makes a later process hit.

The installed JAX does not hash the host's CPU features into its cache
key, so an XLA:CPU executable written on one host can be loaded on
another host with fewer ISA features and crash there.  A directory named
by the environment may be shared between hosts, so CPU programs are never
written to it: a process held to the CPU backend (JAX_PLATFORMS=cpu, or
bench.py's CPU phases) reads it but does not write, and code that
compiles CPU programs beside the accelerator's (the CPU-vs-GPU comparison
in chip_smoke.py) wraps them in `cpu_programs_not_persisted`.
"""

import contextlib
import os

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(_REPO, ".jax_cache")
_MIN_COMPILE_SECS = 0.5
_NEVER_SECS = 1e9

_done = False


def ensure_cache():
    global _done
    if _done:
        return
    _done = True
    import jax
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    d = env_dir or DEFAULT_DIR
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    cpu_only = (jax.config.jax_platforms or "").split(",") == ["cpu"]
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      _NEVER_SECS if env_dir and cpu_only
                      else _MIN_COMPILE_SECS)


@contextlib.contextmanager
def cpu_programs_not_persisted():
    """Compile inside this block without writing to the persistent cache
    (the threshold is read at every write; reads are unaffected)."""
    import jax
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      _NEVER_SECS)
    try:
        yield
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", old)
