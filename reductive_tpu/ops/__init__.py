"""Hand-written GPU kernels for the two hot paths (Pallas through Triton).

* :mod:`~reductive_tpu.ops.assign` — fused distance + argmin encode kernel
  (the serving encode and the assign half of every Lloyd's step).
* :mod:`~reductive_tpu.ops.adc` — lookup-table ADC scoring of uint8 and
  packed-u4 codes (exhaustive and IVF search).

Which of them runs is decided in :mod:`reductive_tpu.dispatch`.
:mod:`~reductive_tpu.ops.packing` holds the plain-XLA 4-bit code packing.
"""

from .adc import adc_scores_kernel
from .assign import assign_nearest, pq_encode
from .packing import pack_u4_codes, unpack_u4_codes

__all__ = [
    "pq_encode",
    "assign_nearest",
    "adc_scores_kernel",
    "pack_u4_codes",
    "unpack_u4_codes",
]
