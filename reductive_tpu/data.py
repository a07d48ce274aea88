"""Streaming encode pipeline: disk → host batches → device → codes.

Production encode jobs process corpora far larger than HBM (BASELINE.json
config #5: 100M 768-d vectors).  This pipeline streams the corpus in
fixed-size batches through the fused encode kernel with double buffering:
JAX dispatch is asynchronous, so while the device encodes batch *i* the
host is already mmap-reading and converting batch *i+1* (the native
``VecsReader``), and completed code blocks drain to host memory a couple
of batches behind.  The last partial batch is zero-padded to the batch
shape so a single compiled program serves the whole stream (no retraces).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .pq.model import Pq

__all__ = [
    "stream_encode",
    "stream_encode_batches",
    "stream_encode_resumable",
    "SyntheticReader",
]


class SyntheticReader:
    """Device-resident synthetic corpus implementing the reader protocol.

    Every row is a pure function of ``(seed, row_index)`` — a
    *virtual corpus* that is never materialized on disk, in host RAM, or
    in HBM: ``batches()`` generates each block on the device on demand,
    so streaming consumers (:func:`stream_encode`,
    :func:`reductive_tpu.pq.train_pq_streamed`, IVF builds from a reader)
    run their full >HBM path with zero host-link traffic.  Two uses:

    * executing corpus-scale workloads (BASELINE config #5's 100M×768)
      at device rate on hardware whose host link would otherwise bound
      the stream — generation replaces the disk read, everything
      downstream is the production code path;
    * reader-protocol tests without temp files.

    Data is a mixture of ``n_centers`` Gaussians (centers drawn
    ``N(0, center_scale²)``, isotropic unit noise by default) — the
    clustered distribution from the recall-methodology benches.  Because
    each row derives its own PRNG key from its index, ``read``,
    ``read_rows``, and ``batches`` are mutually consistent and
    order-independent, exactly like a file-backed reader.
    """

    def __init__(
        self,
        n: int,
        dim: int,
        *,
        seed: int = 0,
        n_centers: int = 256,
        center_scale: float = 2.0,
        noise_scale: float = 1.0,
    ):
        self.n = int(n)
        self.dim = int(dim)
        self.path = None  # reader protocol: no backing file
        key = jax.random.PRNGKey(seed)
        ckey, self._row_key = jax.random.split(key)
        self._centers = jax.random.normal(
            ckey, (n_centers, dim), jnp.float32
        ) * center_scale
        n_c = n_centers
        noise = float(noise_scale)

        @jax.jit
        def gen_rows(row_key, centers, idx):
            def one(i):
                h = jax.random.fold_in(row_key, i)
                hw, hn = jax.random.split(h)
                which = jax.random.randint(hw, (), 0, n_c)
                return centers[which] + noise * jax.random.normal(
                    hn, (centers.shape[1],), jnp.float32
                )

            return jax.vmap(one)(idx)

        self._gen = gen_rows

    def rows(self, idx) -> jax.Array:
        """Device-side row generation for an int index array."""
        return self._gen(self._row_key, self._centers, jnp.asarray(idx))

    def read(self, start: int, count: int) -> jax.Array:
        return self.rows(start + jnp.arange(count))

    def read_rows(self, indices) -> jax.Array:
        return self.rows(jnp.asarray(indices).ravel())

    def batches(self, batch_size: int, start: int = 0, stop: Optional[int] = None):
        stop = self.n if stop is None else min(stop, self.n)
        # Full-size generation + tail slice: one compiled program for the
        # whole stream, matching the file readers' padding discipline.
        for off in range(start, stop, batch_size):
            b = min(batch_size, stop - off)
            block = self.rows(off + jnp.arange(batch_size))
            yield off, (block if b == batch_size else block[:b])

    def close(self) -> None:  # reader protocol
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _encode_fn(pq: Pq, dtype, use_kernel: bool):
    from .dispatch import encode

    def fn(codebooks, projection, x):
        # Upcast a reduced wire dtype (transfer_dtype) back to the
        # codebook dtype for compute.
        x = x.astype(codebooks.dtype)
        if projection is not None:
            x = jnp.dot(x, projection, precision="highest")
        return encode(codebooks, x, dtype=dtype, use_kernel=use_kernel)

    # No donation here: the (b, d) float input can never alias the much
    # smaller (b, m) integer output, XLA already frees the batch temp at
    # execution completion (its only reference dies when fn returns), and
    # donating only produced a "donated buffers were not usable" warning
    # per compile.  The *_into donation entries live on the model API,
    # where output buffers genuinely alias.
    return jax.jit(fn)


def stream_encode_batches(
    pq: Pq,
    batches: Iterable[Tuple[int, np.ndarray]],
    *,
    batch_size: int,
    dtype=jnp.uint8,
    use_kernel: Optional[bool] = None,
    max_in_flight: int = 2,
    transfer_dtype=None,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Encode a stream of ``(offset, (b, d) float32)`` batches.

    Yields ``(offset, (b, m) codes)`` in order.  Up to ``max_in_flight``
    device batches stay queued, overlapping host IO, host→device copies,
    and compute.  Batches smaller than ``batch_size`` (the tail) are
    padded on device entry and trimmed on exit.

    ``transfer_dtype=jnp.bfloat16`` casts each batch on the **host**
    before the host→device copy, halving the bytes on the wire; the
    codes are then those of the bf16-rounded vectors.  ``use_kernel``
    is resolved by :func:`reductive_tpu.dispatch.use_kernel`.
    """
    from .dispatch import use_kernel as choose

    use_kernel = choose("encode", use_kernel)
    fn = _encode_fn(pq, dtype, use_kernel)
    codebooks, projection = pq.codebooks, pq.projection

    pending: list[Tuple[int, int, jax.Array]] = []

    def drain_one():
        off, valid, codes = pending.pop(0)
        return off, np.asarray(codes)[:valid]

    for off, batch in batches:
        b = batch.shape[0]
        if transfer_dtype is not None:
            batch = np.asarray(batch).astype(transfer_dtype)  # host-side cast
        if b < batch_size:
            batch = np.concatenate(
                [batch, np.zeros((batch_size - b, batch.shape[1]), batch.dtype)]
            )
        codes = fn(codebooks, projection, jnp.asarray(batch))
        pending.append((off, b, codes))
        if len(pending) > max_in_flight:
            yield drain_one()
    while pending:
        yield drain_one()


def _reader_batches(reader, batch_size: int, start: int, stop: int):
    """Prefer the native prefetch executor when the reader has one.

    ``copy=True`` — device_put may stage the host buffer asynchronously,
    and the prefetcher's ring slot is recycled on the next step; the
    memcpy is cheap next to the conversion it overlaps."""
    if hasattr(reader, "prefetch_batches"):
        return reader.prefetch_batches(batch_size, start, stop, copy=True)
    return reader.batches(batch_size, start, stop)


def stream_encode(
    pq: Pq,
    reader,
    *,
    batch_size: int = 1 << 18,
    dtype=jnp.uint8,
    use_kernel: Optional[bool] = None,
    start: int = 0,
    stop: Optional[int] = None,
    transfer_dtype=None,
) -> np.ndarray:
    """Encode an entire on-disk dataset to a ``(n, m)`` code matrix.

    ``reader`` is a :class:`reductive_tpu.native.VecsReader` (or anything
    with ``n``/``batches()``).  Memory high-water: one output code matrix
    plus ``max_in_flight`` input batches.
    """
    stop = reader.n if stop is None else min(stop, reader.n)
    n = stop - start
    out = np.empty((n, pq.quantized_len), dtype=np.dtype(dtype))
    batches = _reader_batches(reader, batch_size, start, stop)
    for off, codes in stream_encode_batches(
        pq,
        batches,
        batch_size=batch_size,
        dtype=dtype,
        use_kernel=use_kernel,
        transfer_dtype=transfer_dtype,
    ):
        out[off - start:off - start + codes.shape[0]] = codes
    return out


# ---------------------------------------------------------------------------
# Resumable encode: failure detection / restart for long-running jobs
# ---------------------------------------------------------------------------
#
# The reference has no failure handling at all (SURVEY.md §5); the aux
# requirement for production encode jobs is deterministic restart from the
# codebook artifact.  Codes are written straight into an on-disk memmap;
# a sidecar JSON tracks the contiguous completed prefix and a fingerprint
# of the model + corpus, updated atomically (write-tmp + rename) so a kill
# at any point leaves a consistent resume state.  Encode is deterministic
# given (model, corpus), so restart continues bit-identically.


def _model_fingerprint(pq: Pq, reader, batch_size: int, dtype) -> str:
    h = hashlib.sha256()
    h.update(np.asarray(pq.codebooks).tobytes())
    if pq.projection is not None:
        h.update(np.asarray(pq.projection).tobytes())
    h.update(f"{reader.n}:{batch_size}:{np.dtype(dtype).name}".encode())
    # Corpus identity: a regenerated same-length corpus must not resume a
    # stale prefix.  Content-based only — mtime is deliberately excluded so
    # an rsync/copy of an identical file (which may not preserve
    # timestamps) keeps its completed progress.  Size plus head, tail, and
    # 64 interior 1 KB windows at pseudo-random offsets (seeded from the
    # size, so the same file always hashes the same bytes) catch
    # regeneration anywhere in the file: a same-size corpus with different
    # contents has < 2^-40 odds of leaving all ~72 KB of sampled windows
    # untouched unless the change is narrowly targeted between them.
    path = getattr(reader, "path", None)
    if path is None and hasattr(reader, "read"):
        # No backing file (e.g. SyntheticReader): corpus identity from a
        # few probed rows' bytes — a regenerated same-size virtual corpus
        # with a different seed must not resume a stale prefix.  One
        # probe per resumable job, so the device round-trip is immaterial.
        take = min(reader.n, 16)
        h.update(np.asarray(reader.read(0, take), np.float32).tobytes())
        if reader.n > take:
            mid = reader.n // 2
            h.update(np.asarray(
                reader.read(mid, min(16, reader.n - mid)), np.float32
            ).tobytes())
    if path is not None and os.path.exists(path):
        st = os.stat(path)
        h.update(f"{os.path.basename(path)}:{st.st_size}".encode())
        with open(path, "rb") as f:
            h.update(f.read(4096))
            interior = st.st_size - 8192
            if interior > 0:
                rs = np.random.RandomState(st.st_size % (2**32))
                offs = np.sort(rs.randint(0, max(1, interior), size=64))
                for off in offs:
                    f.seek(4096 + int(off))
                    h.update(f.read(1024))
            if st.st_size > 8192:
                f.seek(-4096, os.SEEK_END)
                h.update(f.read(4096))
    return h.hexdigest()


def stream_encode_resumable(
    pq: Pq,
    reader,
    out_path: str,
    *,
    batch_size: int = 1 << 18,
    dtype=jnp.uint8,
    use_kernel: Optional[bool] = None,
    flush_every: int = 4,
    transfer_dtype=None,
) -> np.memmap:
    """Encode an on-disk dataset into an on-disk ``(n, m)`` code matrix,
    resuming after interruption.

    Progress is tracked in ``<out_path>.progress.json`` (atomic replace):
    if it exists and its fingerprint matches this (model, corpus, config),
    encoding continues from the recorded contiguous prefix.  The sidecar
    is kept with ``completed_rows == n`` after success, making the call
    idempotent — a supervisor that blindly re-runs the command returns
    the finished output instead of re-encoding (or worse, truncating) it.
    Returns the completed read-only memmap.
    """
    n = reader.n
    m = pq.quantized_len
    np_dtype = np.dtype(dtype)
    progress_path = out_path + ".progress.json"
    fingerprint = _model_fingerprint(pq, reader, batch_size, np_dtype)

    start = 0
    if os.path.exists(progress_path) and os.path.exists(out_path):
        try:
            with open(progress_path) as f:
                state = json.load(f)
            if (
                state.get("fingerprint") == fingerprint
                and state.get("n") == n
                and state.get("m") == m
            ):
                start = int(state["completed_rows"])
        except (ValueError, KeyError, OSError):
            start = 0  # unreadable sidecar: restart from scratch

    if start >= n:  # already complete: idempotent return
        return np.memmap(out_path, dtype=np_dtype, mode="r", shape=(n, m))

    mode = "r+" if (start > 0 and os.path.exists(out_path)) else "w+"
    out = np.memmap(out_path, dtype=np_dtype, mode=mode, shape=(n, m))

    def write_progress(rows: int) -> None:
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "fingerprint": fingerprint,
                    "n": n,
                    "m": m,
                    "dtype": np_dtype.name,
                    "completed_rows": rows,
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, progress_path)

    batches = _reader_batches(reader, batch_size, start, n)

    completed = start
    since_flush = 0
    for off, codes in stream_encode_batches(
        pq, batches, batch_size=batch_size, dtype=dtype,
        use_kernel=use_kernel, transfer_dtype=transfer_dtype,
    ):
        out[off : off + codes.shape[0]] = codes
        # Batches arrive in order, so the completed prefix is contiguous.
        completed = off + codes.shape[0]
        since_flush += 1
        if since_flush >= flush_every:
            out.flush()
            write_progress(completed)
            since_flush = 0

    out.flush()
    write_progress(n)  # completion marker — kept for idempotent re-runs
    return np.memmap(out_path, dtype=np_dtype, mode="r", shape=(n, m))
