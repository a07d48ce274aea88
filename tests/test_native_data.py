"""Tests for the native IO runtime and the streaming encode pipeline."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reductive_tpu import Pq
from reductive_tpu.data import stream_encode, stream_encode_batches
from reductive_tpu.native import (
    NATIVE_AVAILABLE,
    VecsReader,
    pack_u4,
    unpack_u4,
    write_fvecs,
)


def test_native_library_builds():
    # The toolchain is part of the environment contract; the native path
    # must actually be active here, not silently falling back.
    assert NATIVE_AVAILABLE


def make_fvecs(tmp_path, n=100, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    path = str(tmp_path / "data.fvecs")
    write_fvecs(path, data)
    return path, data


def test_vecs_reader_fvecs(tmp_path):
    path, data = make_fvecs(tmp_path)
    with VecsReader(path) as r:
        assert len(r) == 100
        assert r.dim == 16
        np.testing.assert_array_equal(r.read(0, 100), data)
        np.testing.assert_array_equal(r.read(37, 5), data[37:42])
        with pytest.raises(IndexError):
            r.read(90, 20)


def test_vecs_reader_bvecs(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(50, 8), dtype=np.uint8)
    path = str(tmp_path / "data.bvecs")
    with open(path, "wb") as f:
        header = np.asarray([8], dtype=np.int32).tobytes()
        for row in data:
            f.write(header)
            f.write(row.tobytes())
    with VecsReader(path) as r:
        assert r.dim == 8 and len(r) == 50
        np.testing.assert_array_equal(r.read(0, 50), data.astype(np.float32))


def test_vecs_reader_batches(tmp_path):
    path, data = make_fvecs(tmp_path, n=100)
    with VecsReader(path) as r:
        chunks = list(r.batches(32))
    assert [off for off, _ in chunks] == [0, 32, 64, 96]
    assert chunks[-1][1].shape == (4, 16)
    np.testing.assert_array_equal(np.concatenate([c for _, c in chunks]), data)


def test_vecs_reader_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.fvecs"
    bad.write_bytes(b"\x01\x00\x00\x00\xff")  # truncated row
    with pytest.raises(OSError):
        VecsReader(str(bad))


@pytest.mark.parametrize("n", [10, 11, 0])
def test_pack_unpack_u4_roundtrip(n):
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 16, size=n, dtype=np.uint8)
    packed = pack_u4(codes)
    assert packed.size == (n + 1) // 2
    np.testing.assert_array_equal(unpack_u4(packed, n), codes)


def test_pack_u4_matches_numpy_fallback():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 16, size=1001, dtype=np.uint8)
    packed = pack_u4(codes)
    lo = codes[0::2] & 0x0F
    hi = np.zeros_like(lo)
    hi[: codes.size // 2] = codes[1::2] & 0x0F
    np.testing.assert_array_equal(packed, lo | (hi << 4))


def test_stream_encode_matches_batch_encode(tmp_path):
    key = jax.random.PRNGKey(0)
    pq = Pq(codebooks=jax.random.normal(key, (4, 16, 4), dtype=jnp.float32))
    path, data = make_fvecs(tmp_path, n=333, dim=16, seed=4)

    expected = np.asarray(pq.quantize_batch(jnp.asarray(data), dtype=jnp.uint8))
    with VecsReader(path) as r:
        got = stream_encode(pq, r, batch_size=100, use_kernel=False)
    np.testing.assert_array_equal(got, expected)


def test_stream_encode_batches_order_and_tail():
    key = jax.random.PRNGKey(1)
    pq = Pq(codebooks=jax.random.normal(key, (2, 8, 4), dtype=jnp.float32))
    rng = np.random.default_rng(5)
    batches = [(0, rng.standard_normal((64, 8)).astype(np.float32)),
               (64, rng.standard_normal((64, 8)).astype(np.float32)),
               (128, rng.standard_normal((10, 8)).astype(np.float32))]
    out = list(
        stream_encode_batches(pq, iter(batches), batch_size=64, use_kernel=False)
    )
    assert [off for off, _ in out] == [0, 64, 128]
    assert out[-1][1].shape == (10, 2)
    full = np.concatenate([c for _, c in out])
    expected = np.asarray(
        pq.quantize_batch(jnp.asarray(np.concatenate([b for _, b in batches])))
    )
    np.testing.assert_array_equal(full, expected)


def test_prefetch_batches_content_and_order(tmp_path):
    """The native prefetch executor yields exactly the same (offset, batch)
    stream as the synchronous reader, in order, including the tail."""
    import numpy as np
    from reductive_tpu.native import VecsReader, write_fvecs

    rng = np.random.default_rng(7)
    data = rng.standard_normal((2_500, 16)).astype(np.float32)
    path = str(tmp_path / "p.fvecs")
    write_fvecs(path, data)
    with VecsReader(path) as r:
        sync = list(r.batches(700))
        pre = [(o, b.copy()) for o, b in r.prefetch_batches(700, depth=3)]
        assert [o for o, _ in pre] == [o for o, _ in sync]
        for (_, a), (_, b) in zip(pre, sync):
            np.testing.assert_array_equal(a, b)
        # zero-copy mode: views valid within each step
        pre2 = [(o, b.copy()) for o, b in r.prefetch_batches(700, depth=2, copy=False)]
        for (_, a), (_, b) in zip(pre2, sync):
            np.testing.assert_array_equal(a, b)
        # early termination must not hang (prefetch_destroy on close)
        it = r.prefetch_batches(700)
        next(it)
        it.close()


def test_prefetch_zero_copy_needs_depth_two(tmp_path):
    import numpy as np
    import pytest
    from reductive_tpu.native import VecsReader, write_fvecs, NATIVE_AVAILABLE

    if not NATIVE_AVAILABLE:
        pytest.skip("native library unavailable")
    data = np.zeros((10, 4), dtype=np.float32)
    path = str(tmp_path / "z.fvecs")
    write_fvecs(path, data)
    with VecsReader(path) as r:
        with pytest.raises(ValueError):
            next(r.prefetch_batches(4, depth=1, copy=False))


def test_stream_encode_uses_prefetch(tmp_path):
    import numpy as np
    import jax, jax.numpy as jnp
    from reductive_tpu import Pq
    from reductive_tpu.data import stream_encode
    from reductive_tpu.native import VecsReader, write_fvecs

    rng = np.random.default_rng(3)
    data = rng.standard_normal((1_111, 32)).astype(np.float32)
    path = str(tmp_path / "s.fvecs")
    write_fvecs(path, data)
    pq = Pq(codebooks=jnp.asarray(rng.standard_normal((4, 8, 8)), dtype=jnp.float32))
    with VecsReader(path) as r:
        codes = stream_encode(pq, r, batch_size=256)
    ref = pq.quantize_batch(jnp.asarray(data))
    np.testing.assert_array_equal(codes, np.asarray(ref))


def test_stream_encode_resumable_restart(tmp_path):
    """Kill-and-restart: an interrupted resumable encode continues from the
    recorded prefix and produces a bit-identical result to one-shot."""
    import json
    import numpy as np
    import jax, jax.numpy as jnp
    from reductive_tpu import Pq
    from reductive_tpu.data import stream_encode_resumable
    from reductive_tpu.native import VecsReader, write_fvecs

    rng = np.random.default_rng(9)
    data = rng.standard_normal((2_000, 16)).astype(np.float32)
    path = str(tmp_path / "c.fvecs")
    write_fvecs(path, data)
    pq = Pq(codebooks=jnp.asarray(rng.standard_normal((4, 8, 4)), dtype=jnp.float32))
    out_path = str(tmp_path / "codes.bin")

    # Simulate an interrupted run: encode only the first half, leaving a
    # valid sidecar behind (as a crash after a flush would).
    with VecsReader(path) as r:
        full = stream_encode_resumable(pq, r, str(tmp_path / "ref.bin"), batch_size=256)
        half = stream_encode_resumable(pq, r, out_path, batch_size=256)
    # Forge the interrupted state: truncate progress to 1024 rows and
    # corrupt everything after it.
    from reductive_tpu.data import _model_fingerprint

    sidecar = out_path + ".progress.json"
    mm = np.memmap(out_path, dtype=np.uint8, mode="r+", shape=(2_000, 4))
    mm[1024:] = 255
    mm.flush()
    with VecsReader(path) as r:
        fp = _model_fingerprint(pq, r, 256, np.dtype(np.uint8))
    with open(sidecar, "w") as f:
        json.dump({"fingerprint": fp, "n": 2_000, "m": 4,
                   "dtype": "uint8", "completed_rows": 1024}, f)

    with VecsReader(path) as r:
        resumed = stream_encode_resumable(pq, r, out_path, batch_size=256)
    np.testing.assert_array_equal(np.asarray(resumed), np.asarray(full))
    # The sidecar survives as a completion marker; a blind re-run is
    # idempotent (returns the finished output without truncating it).
    assert (tmp_path / "codes.bin.progress.json").exists()
    mm2 = np.memmap(out_path, dtype=np.uint8, mode="r+", shape=(2_000, 4))
    mm2[0] = 77  # sentinel: would be zeroed by a w+ reopen
    mm2.flush()
    with VecsReader(path) as r:
        again = stream_encode_resumable(pq, r, out_path, batch_size=256)
    assert np.all(np.asarray(again[0]) == 77)  # untouched: no re-encode

    # A fingerprint mismatch (different model) restarts from scratch.
    pq2 = Pq(codebooks=jnp.asarray(rng.standard_normal((4, 8, 4)), dtype=jnp.float32))
    with open(sidecar, "w") as f:
        json.dump({"fingerprint": "stale", "n": 2_000, "m": 4,
                   "dtype": "uint8", "completed_rows": 1024}, f)
    with VecsReader(path) as r:
        fresh = stream_encode_resumable(pq2, r, out_path, batch_size=256)
    ref2 = pq2.quantize_batch(jnp.asarray(data))
    np.testing.assert_array_equal(np.asarray(fresh), np.asarray(ref2))


def test_u4_end_to_end_roundtrip():
    """4-bit deployment path: k=16 quantizer -> uint8 codes -> packed
    nibbles on disk -> unpack -> bit-identical reconstruction."""
    import numpy as np
    import jax, jax.numpy as jnp
    from reductive_tpu import Pq
    from reductive_tpu.native import pack_u4, unpack_u4

    rng = np.random.default_rng(11)
    pq = Pq(codebooks=jnp.asarray(rng.standard_normal((8, 16, 4)), dtype=jnp.float32))
    x = jnp.asarray(rng.standard_normal((999, 32)), dtype=jnp.float32)
    codes = np.asarray(pq.quantize_batch(x, dtype=jnp.uint8))
    assert codes.max() < 16

    packed = pack_u4(codes)
    assert packed.nbytes == (codes.size + 1) // 2  # half the storage
    restored = unpack_u4(packed, codes.size).reshape(codes.shape)
    np.testing.assert_array_equal(restored, codes)

    rec_a = pq.reconstruct_batch(jnp.asarray(codes))
    rec_b = pq.reconstruct_batch(jnp.asarray(restored))
    np.testing.assert_array_equal(np.asarray(rec_a), np.asarray(rec_b))


def test_stream_encode_bf16_transfer():
    """transfer_dtype=bfloat16 halves the wire bytes: the host cast
    rounds exactly like a device cast, and the pipeline accepts the cast
    end to end."""
    import jax.numpy as jnp

    from reductive_tpu import Pq
    from reductive_tpu.data import stream_encode_batches

    m, k, ds, n = 4, 16, 4, 300
    kc, kx = jax.random.split(jax.random.PRNGKey(17))
    pq = Pq(codebooks=jax.random.normal(kc, (m, k, ds), dtype=jnp.float32))
    x = np.asarray(jax.random.normal(kx, (n, m * ds), dtype=jnp.float32))

    # The host-side ml_dtypes cast rounds exactly like the device cast.
    host_cast = x.astype(jnp.bfloat16)
    dev_cast = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(
        host_cast.view(np.uint16), dev_cast.view(np.uint16)
    )

    # End-to-end pipeline smoke with the cast (einsum fallback on CPU).
    batches = [(0, x[:128]), (128, x[128:])]
    out = np.concatenate([
        c for _, c in stream_encode_batches(
            pq, iter(batches), batch_size=128, transfer_dtype=jnp.bfloat16,
        )
    ])
    assert out.shape == (n, m)
    ref = np.concatenate([
        c for _, c in stream_encode_batches(pq, iter(batches), batch_size=128)
    ])
    agree = float(np.mean(out == ref))
    assert agree > 0.95  # einsum fallback: bf16 input flips only near-ties
