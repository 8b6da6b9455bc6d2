"""The one platform choice the program makes.

Every metric has one accelerator path, written in ``jax.numpy``/``lax`` and
left to XLA. What differs between the GPU and the CPU (where the tests and
rehearsals run) is only how work is dispatched: on the GPU the quality and
complexity phases of a chunk run as one program, on the CPU as two smaller
ones that compile faster.
"""

from __future__ import annotations

import jax


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    return jax.default_backend() == "gpu"
