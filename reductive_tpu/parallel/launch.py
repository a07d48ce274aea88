"""Multi-process initialization helpers.

One process per host drives its local cards; `jax.distributed.initialize`
wires the processes into one global runtime, after which every entry in
this package works unchanged — `jax.devices()` spans every process,
meshes built by :func:`reductive_tpu.parallel.make_mesh` cover all cards,
and the psum'd centroid statistics cross NVLink within a host and the
network between hosts.

Typical launch (same script in every process)::

    from reductive_tpu.parallel import initialize_distributed, make_mesh

    initialize_distributed("host0:1234", num_processes=2, process_id=rank)
    mesh = make_mesh()                # 1-D data mesh over all cards
    pq = train_pq_chunked_sharded(key, shard, ..., mesh=mesh)

Pass the coordinator address, process count and process id explicitly
unless the cluster's launcher lets ``jax.distributed.initialize`` discover
them.  Encode-style jobs need no coordination at all — each host can run
:func:`reductive_tpu.data.stream_encode_resumable` on its own corpus
shard and restart independently (deterministic given the codebook
artifact).
"""

from __future__ import annotations

import os
from typing import Optional

import jax

__all__ = ["initialize_distributed"]

_initialized = False

# Environment variables that signal this process is part of a MULTI-
# process deployment.  If one is set and auto-discovery still fails,
# silently falling back to single-process would make every process train
# on its own shard alone and produce divergent models — so we raise.
_MULTIHOST_ENV_SIGNALS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def _multihost_intent() -> Optional[str]:
    """The first environment signal indicating multi-process membership."""
    for name in _MULTIHOST_ENV_SIGNALS:
        if os.environ.get(name):
            return name
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Idempotent wrapper around ``jax.distributed.initialize``.

    Call once per process before touching devices.  With no arguments
    the cluster environment must supply the topology; single-process runs
    (the common local/test case) skip initialization entirely.
    """
    global _initialized
    if _initialized:
        return
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kwargs,
        )
        _initialized = True
    except (RuntimeError, ValueError) as e:
        if explicit:
            raise
        signal = _multihost_intent()
        if signal is not None:
            # The environment says this process is part of a cluster; a silent
            # single-process fallback would mean every host trains on its
            # own shard alone and produces a divergent model.  Fail.
            raise RuntimeError(
                f"jax.distributed.initialize failed ({e}) but the "
                f"environment signals multi-host membership ({signal} is "
                "set). Refusing the silent single-process fallback — pass "
                "coordinator_address/num_processes/process_id explicitly."
            ) from e
        # No multi-host signal anywhere (the common local/test case, or a
        # backend already initialized in-session): run single-process.
        import logging

        logging.getLogger("reductive_tpu").warning(
            "jax.distributed.initialize failed (%s); continuing "
            "single-process (no multi-host environment signals present).",
            e,
        )
