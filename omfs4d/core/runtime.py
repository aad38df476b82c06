"""Process set-up shared by the entry points: compile cache and device check.

`enable_compile_cache` keeps JAX's persistent compilation cache where
`JAX_COMPILATION_CACHE_DIR` says, and otherwise at `<repo>/.jax_cache` —
a fixed path, since the path is part of what a later run looks up.
`require_gpu` refuses to measure or smoke-test anything on a host that has
no NVIDIA GPU: a number from the CPU must never pass for a device number.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns its directory.

    With `JAX_COMPILATION_CACHE_DIR` set, JAX already reads it and nothing
    else is set here."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def require_gpu(count: int = 1) -> list:
    """The first `count` JAX devices, which must be GPUs; raises otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX runs on {devices[0].platform!r} "
            f"({devices[0].device_kind}); this entry point measures the card "
            "and has no CPU mode")
    if len(devices) < count:
        raise SystemExit(f"{count} GPUs requested, {len(devices)} present")
    return devices[:count]


class CompileCounter:
    """Counts lowerings to XLA while installed: every miss of a jitted
    function's in-memory cache, whether or not the persistent compile
    cache then supplies the executable."""

    EVENT = "/jax/core/compile/jaxpr_to_mlir_module_duration"

    def __init__(self):
        import jax

        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == self.EVENT:
            self.count += 1


def card_info() -> str:
    """`name, power.limit` of each card, from nvidia-smi (run as a child
    that never touches JAX)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise SystemExit("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
