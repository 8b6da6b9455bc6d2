"""Exponential smoothing as a parallel associative scan.

Reference semantics: ``pd.Series(data).ewm(alpha=a).mean()``
(``complexity_metrics.py:114-125``) — pandas ``adjust=True`` form::

    y_t = sum_{i=0..t} (1-a)^i * x_{t-i}  /  sum_{i=0..t} (1-a)^i

Both numerator and denominator are first-order linear recurrences
``s_t = (1-a) * s_{t-1} + v_t``, which parallelize as an associative scan over
pairs ``(A, b)`` representing the affine map ``s -> A*s + b`` (composition
``(A2, b2) ∘ (A1, b1) = (A1*A2, A2*b1 + b2)``). On the device this runs in
O(log n) depth via ``jax.lax.associative_scan`` instead of the reference's
strictly sequential host loop — and it is exactly this formulation that lets
the smoothing stage shard over the frame axis (SURVEY.md §5 long-context row).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _affine_compose(left, right):
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def linear_recurrence(decay: jax.Array, values: jax.Array, axis: int = 0) -> jax.Array:
    """Compute ``s_t = decay_t * s_{t-1} + values_t`` (s_{-1}=0) via scan."""
    elems = (decay, values)
    _, out = jax.lax.associative_scan(_affine_compose, elems, axis=axis)
    return out


def ewm_mean(x: jax.Array, alpha: float, axis: int = 0) -> jax.Array:
    """pandas-equivalent ``ewm(alpha=alpha, adjust=True).mean()`` along ``axis``.

    Matches ``smooth_data`` (``complexity_metrics.py:114-125``) to float
    tolerance. Works on any float dtype; computes in float32 minimum.
    """
    x = jnp.asarray(x)
    if x.dtype not in (jnp.float32, jnp.float64):
        x = x.astype(jnp.float32)
    one_minus = jnp.asarray(1.0 - alpha, dtype=x.dtype)
    decay = jnp.full_like(x, one_minus)
    num = linear_recurrence(decay, x, axis=axis)
    den = linear_recurrence(decay, jnp.ones_like(x), axis=axis)
    return num / den


def ewm_mean_masked(
    x: jax.Array, alpha: float, valid: jax.Array, axis: int = 0
) -> tuple[jax.Array, jax.Array]:
    """EWM over a padded series: invalid slots are skipped, as if absent.

    Padding to static shapes is how ragged per-clip frame counts stay
    XLA-friendly; ``valid`` is a boolean mask along ``axis``. Invalid slots
    carry the running state through unchanged (decay 1, contribution 0), which
    reproduces the unpadded sequential EWM exactly. Returns ``(smoothed,
    valid)`` where smoothed values at invalid slots are zero.
    """
    x = jnp.asarray(x)
    if x.dtype not in (jnp.float32, jnp.float64):
        x = x.astype(jnp.float32)
    validf = valid.astype(x.dtype)
    one_minus = jnp.asarray(1.0 - alpha, dtype=x.dtype)
    # Invalid: decay=1 (state passes through), value contribution 0.
    decay = jnp.where(validf > 0, one_minus, jnp.ones_like(x))
    num = linear_recurrence(decay, x * validf, axis=axis)
    den = linear_recurrence(decay, validf, axis=axis)
    smoothed = jnp.where(den > 0, num / jnp.maximum(den, 1e-30), jnp.zeros_like(num))
    return smoothed * validf, valid


def masked_mean(x: jax.Array, valid: jax.Array, axis=None) -> jax.Array:
    """Mean over valid slots; 0.0 when no slot is valid (reference returns
    0.0 for empty series, ``complexity_metrics.py:541``)."""
    validf = valid.astype(x.dtype)
    total = jnp.sum(x * validf, axis=axis)
    count = jnp.sum(validf, axis=axis)
    return jnp.where(count > 0, total / jnp.maximum(count, 1.0), 0.0)
