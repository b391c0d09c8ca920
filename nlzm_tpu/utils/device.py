"""The GPU a measurement runs on: JAX's view of it and nvidia-smi's."""

import os
import subprocess


def insist_on_cuda() -> None:
    """Before any JAX backend starts: use CUDA unless JAX_PLATFORMS says
    otherwise, so a missing GPU fails at once instead of falling back to
    the CPU."""
    import jax

    if not os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", "cuda")


def card_lines() -> list:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one line per card; empty when nvidia-smi is unavailable."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return []
    return r.stdout.strip().splitlines() if r.returncode == 0 else []
