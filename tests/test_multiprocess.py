"""True multi-process distributed training test.

The sharded trainers are validated elsewhere on a single-process virtual
mesh; this test exercises the actual ``jax.distributed`` wiring — two OS
processes, a real coordinator, cross-process collectives (gloo on CPU) —
the same topology a multi-host deployment uses (one process per host).

Each process holds one CPU device; the 2-device global mesh shards the
instance matrix across processes, the psum'd centroid statistics cross
the process boundary, and both processes must arrive at codebooks
identical to a single-process run of the same training.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np

    import jax

    jax.config.update("jax_platforms", "cpu")
    coord, pid, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=2, process_id=pid,
        local_device_ids=[0],
    )
    import jax.numpy as jnp

    sys.path.insert(0, os.getcwd())
    from reductive_tpu.parallel import make_mesh, train_pq_chunked_sharded

    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 2, jax.devices()

    mesh = make_mesh((2,), ("data",))
    key = jax.random.PRNGKey(42)
    # Same full matrix on every process; device_put shards it globally.
    x = jax.random.uniform(key, (128, 12), dtype=jnp.float32)
    pq = train_pq_chunked_sharded(
        key, x, 4, 3, 4, mesh=mesh, chunk=16, use_kernel=False,
    )
    cb = np.asarray(pq.codebooks)  # replicated output: same on every process
    np.save(os.path.join(out_dir, f"cb_{pid}.npy"), cb)
    jax.distributed.shutdown()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_training(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # no virtual device splitting in workers

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), str(tmp_path)],
            cwd=str(Path(__file__).resolve().parent.parent),
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process workers timed out")
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            if "UNIMPLEMENTED" in out or "UNAVAILABLE" in out:
                pytest.skip(f"distributed CPU backend unavailable: {out[-300:]}")
            pytest.fail(f"worker rc={p.returncode}:\n{out[-2000:]}")

    cb0 = np.load(tmp_path / "cb_0.npy")
    cb1 = np.load(tmp_path / "cb_1.npy")
    # Both processes hold the same replicated result...
    np.testing.assert_array_equal(cb0, cb1)

    # ...equal to the single-process training on the gathered data (the
    # psum'd statistics match the global one-hot matmul).
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from reductive_tpu.parallel import make_mesh, train_pq_chunked_sharded

    key = jax.random.PRNGKey(42)
    x = jax.random.uniform(key, (128, 12), dtype=jnp.float32)
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    ref = train_pq_chunked_sharded(
        key, x, 4, 3, 4, mesh=mesh, chunk=16, use_kernel=False,
    )
    np.testing.assert_allclose(
        cb0, np.asarray(ref.codebooks), rtol=1e-6, atol=1e-6
    )
