"""Headline benchmark: PQ encode throughput on one NVIDIA GPU.

Times the public encode path that users call, ``Pq.quantize_batch(x)``
(on a GPU, the Pallas/Triton encode kernel), on the reference's
flagship encode shape (BASELINE.md / BASELINE.json): d=128 vectors, m=16
subquantizers, k=256 centroids, uint8 codes, in 8M-row batches.

One process; it needs a GPU and exits non-zero without one, measuring
nothing.  The last line of standard output is one JSON record naming the
device (platform, kind, count) and the card's name and power limit as
``nvidia-smi`` reports them.

    python bench.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

ROWS = 8_000_000
ITERS = 5


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main() -> int:
    import jax
    import jax.numpy as jnp

    from reductive_tpu import Pq
    from reductive_tpu.utils import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU found (JAX platform {dev.platform!r}); "
              "nothing was measured", file=sys.stderr)
        return 2
    m, k, ds = 16, 256, 8
    pq = Pq(codebooks=jax.random.normal(jax.random.PRNGKey(1), (m, k, ds),
                                        jnp.float32))
    x = jax.random.normal(jax.random.PRNGKey(2), (ROWS, m * ds), jnp.float32)
    encode = jax.jit(lambda p, v: p.quantize_batch(v))
    jax.block_until_ready(encode(pq, x))  # compile + warm
    times = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        jax.block_until_ready(encode(pq, x))
        times.append(time.perf_counter() - t0)
    t = sorted(times)[len(times) // 2]
    name = card()
    print(f"card: {name}")
    print(json.dumps({
        "metric": "pq_encode_throughput_d128_m16_k256",
        "value": ROWS / t,
        "unit": "vectors/sec",
        "batch_rows": ROWS,
        "median_of": ITERS,
        "card": name,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
