"""float64 support, mirroring the reference's dtype genericity.

The reference is generic over ``A: NdFloat`` — f32 and f64 both work; its
k-means unit tests run in f64 (``src/kmeans.rs:437``) while the PQ tests
run in f32.  JAX's x64 mode is process-global, so these tests run a child
interpreter with ``jax_enable_x64`` on and assert the whole stack — linalg
goldens, the exact 7/6 MSE fixture, PQ/OPQ/GaussianOpq train → encode →
reconstruct — flows float64 end to end.
"""

import subprocess
import sys

_SCRIPT = r"""
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from reductive_tpu import linalg, kmeans, train_pq, train_opq, train_gaussian_opq

# --- linalg goldens in f64 (reference tests are f64: src/linalg.rs:246-314) ---
u = jnp.asarray([1.0, 2.0, 3.0], dtype=jnp.float64)
v = jnp.asarray([2.0, 4.0, 6.0], dtype=jnp.float64)
d = linalg.squared_euclidean_distance(u[None, :], v[None, :])
assert d.dtype == jnp.float64, d.dtype
assert float(d[0, 0]) == 14.0  # 1+4+9 exactly, f64 arithmetic

x = jnp.asarray([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], dtype=jnp.float64)
cov = linalg.covariance(x, 0)
assert cov.dtype == jnp.float64
assert np.allclose(np.asarray(cov), [[4.0, 4.0], [4.0, 4.0]], atol=1e-12)

# --- exact MSE fixture in f64 (reference: src/kmeans.rs:504-519) ---
centroids = jnp.asarray([[-1.0, 2.0, 0.0], [0.0, -1.0, 1.0]], dtype=jnp.float64)
instances = jnp.asarray([[-1.0, 1.0, 1.0], [0.0, 1.0, 0.0]], dtype=jnp.float64)
assignments = jnp.asarray([1, 0])
mse = kmeans.mean_squared_error(centroids, instances, assignments)
assert mse.dtype == jnp.float64
assert abs(float(mse) - 7.0 / 6.0) < 1e-15, float(mse)  # exact in f64

# --- full quantizer stack in f64 ---
key = jax.random.PRNGKey(42)
dk, k1, k2, k3 = jax.random.split(key, 4)
data = jax.random.uniform(dk, (256, 20), dtype=jnp.float64)
assert data.dtype == jnp.float64

def loss(pq):
    codes = pq.quantize_batch(data, dtype=jnp.uint8)
    rec = pq.reconstruct_batch(codes)
    assert rec.dtype == jnp.float64, rec.dtype
    return float(jnp.mean(jnp.sqrt(jnp.sum((data - rec) ** 2, axis=1))))

pq = train_pq(k1, data, 10, 7, 10, 1)
assert pq.codebooks.dtype == jnp.float64
assert loss(pq) < 0.08

opq = train_opq(k2, data, 10, 7, 10)
assert opq.codebooks.dtype == jnp.float64
assert opq.projection.dtype == jnp.float64
assert loss(opq) < 0.10

gopq = train_gaussian_opq(k3, data, 10, 7, 10, 1)
assert gopq.codebooks.dtype == jnp.float64
assert loss(gopq) < 0.12

print("float64 OK")
"""


def test_float64_end_to_end():
    result = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert result.returncode == 0, f"stdout:\n{result.stdout}\nstderr:\n{result.stderr}"
    assert "float64 OK" in result.stdout
