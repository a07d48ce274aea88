"""Linear-algebra utilities: pairwise distances and covariance.

Counterpart of the reference's linalg layer (reference:
``src/linalg.rs``).  The key design decision is shared with the reference
(design note at ``src/linalg.rs:66-86``): squared Euclidean distances are
computed through the norm expansion

    ``|u - v|^2 = |u|^2 + |v|^2 - 2 u.v``

so that the heavy lifting is a single matrix multiplication, which XLA
hands to the device's matrix units and fuses the norm broadcasts around —
the mathematically identical, hardware-idiomatic formulation.

All functions are pure, shape-polymorphic over the leading dimensions, and
safe to ``jit``/``vmap``/``shard_map``.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

__all__ = [
    "squared_euclidean_distance",
    "euclidean_distance",
    "covariance",
]


def squared_euclidean_distance(u: Array, v: Array, *, precision="highest") -> Array:
    """Squared Euclidean distance(s) between ``u`` and ``v``.

    Shape behavior matches the reference trait impls
    (``src/linalg.rs:88-180``):

    * ``(d,) x (d,)``  → scalar.
    * ``(d,) x (k, d)`` → ``(k,)`` distances from ``u`` to each row of ``v``.
    * ``(n, d) x (k, d)`` → ``(n, k)`` with entry ``(i, j)`` the distance
      between row ``i`` of ``u`` and row ``j`` of ``v``.

    Uses the ``|u|^2 + |v|^2 - 2 u.v`` expansion; like the reference, the
    result is not clamped at zero, so tiny negative values can appear for
    near-identical inputs.
    """
    u = jnp.asarray(u)
    v = jnp.asarray(v)
    if u.ndim == 1 and v.ndim == 1:
        if u.shape[0] != v.shape[0]:
            raise ValueError(
                "Cannot compute (squared) euclidean distance of vectors with "
                f"different lengths: {u.shape[0]} != {v.shape[0]}"
            )
        dp = jnp.dot(u, v, precision=precision)
        return jnp.dot(u, u, precision=precision) + jnp.dot(v, v, precision=precision) - (dp + dp)
    if u.ndim == 1 and v.ndim == 2:
        if u.shape[0] != v.shape[1]:
            raise ValueError(
                "Cannot compute (squared) euclidean distance when the number of "
                f"vector components ({u.shape[0]}) and matrix columns ({v.shape[1]}) differ."
            )
        u_sqn = jnp.dot(u, u, precision=precision)
        v_sqn = jnp.einsum("kd,kd->k", v, v, precision=precision)
        dp = jnp.dot(v, u, precision=precision)
        return u_sqn + v_sqn - (dp + dp)
    if u.ndim == 2 and v.ndim == 2:
        if u.shape[1] != v.shape[1]:
            raise ValueError(
                "Cannot compute (squared) euclidean distance of matrices with "
                f"different numbers of columns: {u.shape[1]} != {v.shape[1]}"
            )
        u_sqn = jnp.einsum("nd,nd->n", u, u, precision=precision)
        v_sqn = jnp.einsum("kd,kd->k", v, v, precision=precision)
        dp = jnp.dot(u, v.T, precision=precision)
        return u_sqn[:, None] + v_sqn[None, :] - (dp + dp)
    raise ValueError(
        f"Unsupported operand ranks for squared_euclidean_distance: {u.ndim} and {v.ndim}"
    )


def euclidean_distance(u: Array, v: Array, *, precision="highest") -> Array:
    """Euclidean distance(s): the square root of
    :func:`squared_euclidean_distance`, with the same shape rules
    (reference: ``src/linalg.rs:192-244``)."""
    return jnp.sqrt(squared_euclidean_distance(u, v, precision=precision))


def covariance(x: Array, observation_axis: int = 0, *, precision="highest") -> Array:
    """Covariance matrix of ``x`` with observations along ``observation_axis``.

    For an ``n x m`` matrix with ``n`` observations along axis 0, returns the
    ``m x m`` matrix ``C`` with ``C[i, j]`` the covariance between variables
    ``i`` and ``j`` — mean-centered, normalized by ``n - 1`` (reference:
    ``src/linalg.rs:17-45``).
    """
    x = jnp.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"covariance expects a rank-2 array, got rank {x.ndim}")
    if observation_axis not in (0, 1):
        raise ValueError(f"observation_axis must be 0 or 1, got {observation_axis}")
    n_obs = x.shape[observation_axis]
    if n_obs == 0:
        raise ValueError("Cannot compute a covariance from zero observations")

    means = jnp.mean(x, axis=observation_axis, keepdims=True)
    centered = x - means
    normalization = jnp.asarray(n_obs - 1, dtype=x.dtype)
    if observation_axis == 0:
        return jnp.dot(centered.T, centered / normalization, precision=precision)
    return jnp.dot(centered, centered.T / normalization, precision=precision)
