"""Platform choice and the persistent compile cache.

`default_platform()` is the platform of the effective default device.
It looks at ``jax_default_device`` before `jax.default_backend()`: the
test suite pins the default device to the CPU. A backend that fails to
start is an error, not a reason to fall back.

`tile_impl(platform)` is the one switch from a platform to the SDF tile
implementation (`ops.tiles`): the Hopper kernel on a GPU, the plain jnp
reference on a CPU, and an error anywhere else. Callers pass the
platform of the devices their arrays or mesh live on, so nothing on a
GPU ever runs in interpret mode or falls back to the reference.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Compile cache inside the checkout when JAX_COMPILATION_CACHE_DIR is not
# set: a fixed path, so every run of this checkout finds it again.
CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def default_platform() -> str:
    import jax

    dev = jax.config.jax_default_device
    if isinstance(dev, str):
        return dev
    if dev is not None:
        return dev.platform
    return jax.default_backend()


def tile_impl(platform: str) -> str:
    """``"kernel"`` on ``gpu``, ``"reference"`` on ``cpu``; raises
    ValueError for any other platform."""
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "reference"
    raise ValueError(f"no SDF tile implementation for platform {platform!r}")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives at `CACHE_DIR`."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
