"""Time the 1080p complexity program with the motion search kernel and with
the XLA scan, in turns, in one process on one GPU.

    python scripts/motion_ab.py [--frames 128] [--rounds 4] [--calls 5]

On the GPU ``ops.motion.block_match_motion`` runs the search as a kernel
(``kernels/motion_triton.py``); it stays only while the whole complexity
program is faster with it than with the scan. Both variants are compiled
ahead of time from the same ``complexity_suite`` with that choice forced
each way; the pyramid motion search is also timed alone. Inputs are made on
the device (``bench.device_frame_fns``). Each round runs every variant
``--calls`` times, each call ended by ``block_until_ready``; the order of
the variants alternates between rounds. Prints one JSON line: the median
milliseconds of each (variant, program), the card's name and power limit,
and both variants' eight suite values. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=128)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--calls", type=int, default=5)
    args = parser.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import card_info, device_frame_fns, device_info
    from rtvqa_tpu.metrics.complexity import METRIC_ORDER, complexity_suite
    from rtvqa_tpu.obs.jaxcache import enable_persistent_cache
    from rtvqa_tpu.ops import motion
    from rtvqa_tpu.ops.color import yuv420_to_gray

    device = device_info()  # exits unless JAX's first device is a GPU
    card = card_info()
    enable_persistent_cache()

    n = args.frames
    gen, _ = device_frame_fns(n, 1080, 1920)
    y, u, v = gen(0)
    ts = jnp.asarray(np.arange(n) * (1000.0 / 30.0), jnp.float32)
    n_valid = jnp.int32(n)
    gray = jax.jit(yuv420_to_gray)(y, u, v)

    inputs = {"complexity program": (y, u, v, ts, n_valid),
              "pyramid motion": (gray,)}

    def suite(y, u, v, ts, n_valid):
        out = complexity_suite(y, u, v, ts, n_valid, resize_h=64, resize_w=64)
        return jnp.stack([out[k] for k in METRIC_ORDER])

    def build(use_kernel: bool) -> dict:
        """Both programs, traced and compiled with the search forced. JAX
        keeps a trace per jitted function (``complexity_suite`` is one), and
        a kept trace would skip the forced choice: clear them first."""
        jax.clear_caches()
        chosen = motion.on_gpu
        motion.on_gpu = lambda: use_kernel
        try:
            return {what: jax.jit(fn).lower(*inputs[what]).compile()
                    for what, fn in (
                        ("complexity program", suite),
                        ("pyramid motion", motion.block_match_motion_pyramid_series))}
        finally:
            motion.on_gpu = chosen

    variants = {"xla_scan": build(False), "triton_kernel": build(True)}
    for what in inputs:
        if len({progs[what].as_text() for progs in variants.values()}) != 2:
            raise SystemExit(f"{what}: both variants compiled to one program")
    values = {}
    for name, progs in variants.items():  # warm-up, and the suite's values
        values[name] = np.asarray(progs["complexity program"](*inputs["complexity program"]))
        jax.block_until_ready(progs["pyramid motion"](gray))

    times = {(name, what): [] for name in variants for what in inputs}
    for r in range(args.rounds):
        order = list(variants) if r % 2 == 0 else list(variants)[::-1]
        for name in order:
            for what, exe in variants[name].items():
                for _ in range(args.calls):
                    t0 = time.perf_counter()
                    jax.block_until_ready(exe(*inputs[what]))
                    times[(name, what)].append(time.perf_counter() - t0)

    print(json.dumps({
        "what": "motion search kernel vs XLA scan, 1080p complexity program",
        **card, "device": device, "frames": n,
        "calls_each": args.rounds * args.calls,
        "median_ms": {name: {what: 1e3 * statistics.median(times[(name, what)])
                             for what in inputs} for name in variants},
        "suite_values": {name: dict(zip(METRIC_ORDER, map(float, vals)))
                         for name, vals in values.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
