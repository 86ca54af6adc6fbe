"""Multi-host bring-up and failure-detection helpers.

The reference had no distributed runtime (SURVEY.md §2.3); the equivalents
of its reconnect-or-die device handling (encoder_node_li.cpp:56-80) at
cluster scale are: jax.distributed initialization, a collective heartbeat
with timeout (failure detection), and checkpoint-based recovery
(pipeline.checkpoint) — resume from the last keyframe state on a rebuilt
job, per SURVEY.md §5.

Single-host fallbacks keep every code path importable and testable without
a cluster.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import jax.numpy as jnp


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed if a cluster is configured.

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID when
    args are omitted. Returns True when multi-process mode is active.
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return False
    nproc = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    pid = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    if nproc <= 1:
        return False
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=nproc, process_id=pid)
    return True


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def is_coordinator() -> bool:
    return jax.process_index() == 0


def heartbeat(mesh, axis_name: str = "data",
              timeout_s: float = 30.0, _probe_fn=None) -> bool:
    """All-reduce heartbeat: returns True when every process responds.

    A hung / dead host stalls the psum past ``timeout_s``; the caller then
    triggers checkpoint-based recovery (save latest state, re-init the
    cluster, resume). The collective itself cannot be interrupted
    mid-call, so the probe runs on a daemon thread and the host-side wait is
    a bounded ``join``: a dead peer leaves the thread blocked inside the
    psum forever, the join times out, and the caller gets False instead of
    hanging with it.

    ``_probe_fn`` is the fault-injection seam (tests substitute a probe
    that hangs or raises, standing in for a dead peer — a real one cannot
    be simulated in a single-process CI job).
    """
    import functools
    import threading

    from jax.sharding import PartitionSpec as P

    if _probe_fn is None:
        @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                           in_specs=P(), out_specs=P())
        def probe(x):
            return jax.lax.psum(x, axis_name)

        def _probe_fn(x):
            probe(x).block_until_ready()

    result = {"ok": False}

    def _run():
        try:
            _probe_fn(jnp.ones((mesh.shape[axis_name],), jnp.float32))
            result["ok"] = True
        except Exception:
            result["ok"] = False

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    return result["ok"] and not t.is_alive()
