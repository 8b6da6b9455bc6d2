#!/bin/bash
# CPU test runner: forces the CPU backend with 8 virtual devices (the
# sharding tests need them). Tests marked `gpu` skip here; run them on the
# card with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
cd "$(dirname "$0")"
export PYTHONPATH="$(pwd)"
export JAX_PLATFORMS=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=8 ${XLA_FLAGS}"
exec python -m pytest tests/ -q "$@"
