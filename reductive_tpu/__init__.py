"""reductive_tpu — a JAX product-quantization engine.

A from-scratch JAX/XLA/Pallas implementation of the full capability set of
`finalfusion/reductive <https://github.com/finalfusion/reductive>`_ (the
Rust reference): k-means clustering, plain product quantization (Jégou et
al., 2011), and optimized product quantization with learned orthonormal
rotations (Ge et al., 2013), plus batched encode and reconstruction —
re-designed as sharded tensor programs for an accelerator (an NVIDIA GPU,
with Pallas kernels for the hot paths) rather than translated from the
reference's rayon/BLAS/LAPACK design.

Top-level surface::

    from reductive_tpu import (
        Pq, train_pq, train_opq, train_gaussian_opq,
        kmeans, linalg, errors,
    )
"""

from . import conformance, data, errors, io, ivf, kmeans, linalg, native, search
from .data import SyntheticReader
from .pq import (
    Pq,
    bucket_eigenvalues,
    create_projection_matrix,
    train_gaussian_opq,
    train_gaussian_opq_chunked,
    train_gaussian_opq_streamed,
    train_opq,
    train_opq_chunked,
    train_opq_streamed,
    train_pq,
    train_pq_chunked,
    train_pq_streamed,
)

__version__ = "0.9.0"

__all__ = [
    "Pq",
    "train_pq",
    "train_pq_chunked",
    "train_pq_streamed",
    "train_opq",
    "train_opq_chunked",
    "train_opq_streamed",
    "train_gaussian_opq",
    "train_gaussian_opq_chunked",
    "train_gaussian_opq_streamed",
    "bucket_eigenvalues",
    "conformance",
    "create_projection_matrix",
    "data",
    "errors",
    "io",
    "ivf",
    "kmeans",
    "linalg",
    "native",
    "search",
    "SyntheticReader",
]
