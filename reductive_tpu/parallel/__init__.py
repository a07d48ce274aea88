"""Multi-device scale-out: meshes, sharded training, and distributed encode.

The reference is single-process — its only parallelism is a rayon thread
pool over the ``m`` subquantizers plus threaded BLAS (see SURVEY.md §2).
This package supplies what the reference never had: SPMD scale-out over a
``jax.sharding.Mesh``:

* **data parallelism** — the instance matrix sharded over the ``data``
  axis; centroid statistics (sums + counts) reduced with ``psum`` across
  devices each Lloyd's iteration.
* **subquantizer (model) parallelism** — the ``m`` independent
  subquantizers sharded over the ``model`` axis; zero communication, the
  tensor-parallel analog for this domain.
"""

from .launch import initialize_distributed
from .mesh import make_mesh
from .sharded import (
    encode_sharded,
    sharded_kmeans,
    sharded_pq_train_step,
    stream_encode_sharded,
    train_opq_chunked_sharded,
    train_pq_chunked_sharded,
    train_pq_sharded,
    train_pq_streamed_sharded,
)

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "sharded_kmeans",
    "sharded_pq_train_step",
    "train_pq_sharded",
    "train_pq_chunked_sharded",
    "train_opq_chunked_sharded",
    "train_pq_streamed_sharded",
    "encode_sharded",
    "stream_encode_sharded",
]
