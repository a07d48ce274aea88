"""Codebook artifact persistence.

The reference keeps no serialization of its own — the model state is the
``(projection?, quantizers)`` pair with public read accessors and a public
constructor, and persistence is delegated to the downstream finalfusion
crate (reference: ``src/pq/pq.rs:29-61,103-110,191-193``).  This library
ships a self-contained artifact instead: a single ``.npz`` holding the
codebooks, the optional projection, and a format version.

Because :class:`~reductive_tpu.pq.model.Pq` is a registered pytree, it
also works directly with orbax/flax checkpointing for users embedded in a
larger training system; this module is the lightweight standalone path
(train once → artifact → serve anywhere).
"""

from __future__ import annotations

import io as _io
import os
from typing import Union

import numpy as np

import jax.numpy as jnp

from .pq.model import Pq

__all__ = ["save", "load"]

_FORMAT = "reductive-tpu-pq"
_FORMAT_IVF = "reductive-tpu-ivfpq"
_VERSION = 1


def _atomic_savez(path, arrays) -> None:
    # Write via a buffer so a crash mid-write cannot leave a torn file,
    # then atomically replace.
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    tmp = f"{os.fspath(path)}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, os.fspath(path))


def save(path: Union[str, os.PathLike], pq) -> None:
    """Write a quantizer (``Pq``) or an IVF-PQ index
    (:class:`reductive_tpu.ivf.IvfPq`) to ``path`` as a ``.npz``
    artifact."""
    from .ivf import IvfPq

    if isinstance(pq, IvfPq):
        arrays = {
            "format": np.array(_FORMAT_IVF),
            "version": np.array(_VERSION),
            "coarse_centroids": np.asarray(pq.coarse_centroids),
            "codebooks": np.asarray(pq.pq.codebooks),
            "cell_codes": np.asarray(pq.cell_codes),
            "cell_ids": np.asarray(pq.cell_ids),
            "cell_norms": np.asarray(pq.cell_norms),
        }
        if pq.pq.projection is not None:
            arrays["projection"] = np.asarray(pq.pq.projection)
        # Build metadata: rows dropped under on_overflow="drop".  Persist
        # it so a reloaded index still reports its incompleteness.
        dropped = np.asarray(getattr(pq, "dropped_ids", np.empty(0, np.int64)))
        if dropped.size:
            arrays["dropped_ids"] = dropped.astype(np.int64)
        _atomic_savez(path, arrays)
        return

    arrays = {
        "format": np.array(_FORMAT),
        "version": np.array(_VERSION),
        "codebooks": np.asarray(pq.codebooks),
    }
    if pq.projection is not None:
        arrays["projection"] = np.asarray(pq.projection)
    _atomic_savez(path, arrays)


def load(path: Union[str, os.PathLike]):
    """Load an artifact written by :func:`save`: a :class:`Pq` for
    quantizer artifacts, an :class:`reductive_tpu.ivf.IvfPq` for IVF
    index artifacts (dispatch on the recorded format tag).

    A restored ``Pq`` passes the same constructor validation as
    ``Pq.new`` in the reference (``src/pq/pq.rs:38-61``): non-empty
    codebooks, square projection matching the reconstructed length.
    """
    with np.load(os.fspath(path), allow_pickle=False) as data:
        fmt = str(data["format"]) if "format" in data else ""
        if fmt not in (_FORMAT, _FORMAT_IVF):
            raise ValueError(f"{path!r} is not a reductive-tpu quantizer artifact")
        version = int(data["version"])
        if version > _VERSION:
            raise ValueError(
                f"artifact version {version} is newer than supported {_VERSION}"
            )
        codebooks = jnp.asarray(data["codebooks"])
        projection = (
            jnp.asarray(data["projection"]) if "projection" in data.files else None
        )
        if fmt == _FORMAT_IVF:
            from .ivf import IvfPq

            index = IvfPq(
                coarse_centroids=jnp.asarray(data["coarse_centroids"]),
                pq=Pq(codebooks=codebooks, projection=projection),
                cell_codes=jnp.asarray(data["cell_codes"]),
                cell_ids=jnp.asarray(data["cell_ids"]),
                cell_norms=jnp.asarray(data["cell_norms"]),
            )
            index.dropped_ids = (
                np.asarray(data["dropped_ids"])
                if "dropped_ids" in data.files
                else np.empty(0, np.int64)
            )
            return index
    return Pq(codebooks=codebooks, projection=projection)
