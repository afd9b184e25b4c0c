"""Process set-up shared by every entry point: compile cache and device.

  * `use_compile_cache()` — JAX's persistent compilation cache. When
    JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing is
    changed; otherwise the cache lives at <repo>/.jax_cache (a fixed path,
    so later runs of the same checkout hit it; listed in .gitignore).
  * `require_device()` — the device a measurement runs on. It must be a
    GPU; the one exception is a rehearsal whose caller set
    JAX_PLATFORMS=cpu explicitly. Returns the description every result
    line carries.
  * `gpu_name_power()` — the card's name and power limit from nvidia-smi,
    read in a child process that does not import JAX.
"""

from __future__ import annotations

import os
import subprocess

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO, ".jax_cache")


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def gpu_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or a
    note saying why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return out[0] if out else "nvidia-smi printed nothing"


def require_device() -> dict:
    """Check the backend and return {"platform", "kind", "count"}.

    Raises RuntimeError unless the first device is a GPU or the caller
    explicitly chose the CPU with JAX_PLATFORMS=cpu (a rehearsal)."""
    devs = jax.devices()
    d = devs[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
    if d.platform == "gpu":
        return info
    if d.platform == "cpu" and os.environ.get("JAX_PLATFORMS") == "cpu":
        return info
    raise RuntimeError(
        f"no GPU found (JAX reports {d.platform!r}); set JAX_PLATFORMS=cpu "
        f"explicitly for a CPU rehearsal")


def describe(info: dict) -> str:
    """One line naming the device and, on a GPU, the card's power limit."""
    line = (f"device: platform={info['platform']} kind={info['kind']} "
            f"count={info['count']}")
    if info["platform"] == "gpu":
        line += f" | nvidia-smi: {gpu_name_power()}"
    return line
