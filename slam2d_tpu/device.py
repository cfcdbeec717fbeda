"""The one place that knows about the device.

- `describe()`: what JAX runs on (platform, device kind, count) and, on a
  GPU, each card's name and power limit as `nvidia-smi` reports them.
- `require_gpu()`: the guard benchmarks and the chip smoke call first — a
  measurement that finds no GPU fails instead of timing the CPU.
- `setup_compile_cache()`: JAX's persistent compilation cache, called by
  the entry points (never on import). `JAX_COMPILATION_CACHE_DIR`, when
  set, wins; otherwise the cache lives at the fixed `<checkout>/.jax_cache`
  (git-ignored) — a fixed path, because the path is part of the cache key.

The library itself runs on whatever backend JAX was given; no module
branches on the platform.
"""

from __future__ import annotations

import os
import shutil
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def _nvidia_smi() -> list[dict]:
    """[{"name", "power_limit"}] per card, or [] when nvidia-smi is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (subprocess.SubprocessError, OSError):
        return []
    cards = []
    for line in out.strip().splitlines():
        name, _, limit = line.rpartition(",")
        cards.append({"name": name.strip(), "power_limit": limit.strip()})
    return cards


def describe() -> dict:
    """Platform, device kind and count as JAX reports them; on a GPU also
    each card's nvidia-smi name and power limit."""
    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if info["platform"] == "gpu":
        info["cards"] = _nvidia_smi()
    return info


def require_gpu() -> None:
    """Raise unless JAX's default backend is a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"this command measures the GPU, but JAX's backend is "
            f"{backend!r}"
        )


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives for this process."""
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir().

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it and nothing
    else is set here. Returns the directory in use."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get(CACHE_ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
