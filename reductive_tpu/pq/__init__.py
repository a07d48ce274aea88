"""Product quantization: models, primitives, and trainers.

Counterpart of the reference's ``pq`` module tree
(reference: ``src/pq/mod.rs``).  Public surface:

* :class:`~reductive_tpu.pq.model.Pq` — the quantizer model (codebooks +
  optional projection), with ``quantize_*``/``reconstruct*`` methods.
* :func:`~reductive_tpu.pq.train.train_pq` — plain PQ training
  (Jégou et al., 2011).
* :func:`~reductive_tpu.pq.opq.train_opq` — optimized PQ with a learned
  rotation (Ge et al., 2013).
* :func:`~reductive_tpu.pq.opq.train_gaussian_opq` — closed-form PCA
  rotation variant for Gaussian-distributed data.
* :mod:`~reductive_tpu.pq.primitives` — raw encode/decode against a
  codebook tensor.
"""

from . import primitives
from .model import (
    Pq,
    quantize_batch_into,
    quantize_vector_into,
    reconstruct_batch_into,
    reconstruct_into,
)
from .opq import (
    bucket_eigenvalues,
    create_projection_matrix,
    train_gaussian_opq,
    train_gaussian_opq_chunked,
    train_opq,
    train_opq_chunked,
)
from .streamed import (
    streamed_covariance,
    train_gaussian_opq_streamed,
    train_opq_streamed,
    train_pq_streamed,
)
from .train import train_pq, train_pq_chunked
from .traits import GaussianOpq, Opq, PqTrainer, entropy_key

__all__ = [
    "Pq",
    "quantize_batch_into",
    "quantize_vector_into",
    "reconstruct_batch_into",
    "reconstruct_into",
    "PqTrainer",
    "Opq",
    "GaussianOpq",
    "entropy_key",
    "primitives",
    "train_pq",
    "train_pq_chunked",
    "train_pq_streamed",
    "train_opq",
    "train_opq_chunked",
    "train_opq_streamed",
    "train_gaussian_opq",
    "train_gaussian_opq_chunked",
    "train_gaussian_opq_streamed",
    "streamed_covariance",
    "bucket_eigenvalues",
    "create_projection_matrix",
]
