"""Scan-Context appearance descriptors for loop-closure candidates.

Round-1 loop closure proposed candidates by pose proximity only
(graph/loop_closure.py) — blind once odometry drift exceeds the gate.
This module adds the appearance channel: a polar ring x sector max-height
descriptor per keyframe (Kim & Kim's Scan Context, the standard LiDAR
place-recognition signature), built and matched on device:

  * the descriptor is one segment-max over bin ids — no loops;
  * matching is rotation-invariant by scoring ALL sector shifts at once:
    the (S,) circular shifts become one batched cosine-similarity tensor
    contraction (einsum over a rolled stack), vmapped over the keyframe
    database — the whole database match is a single fused kernel;
  * a ring-key (per-ring occupancy mean, rotation-invariant by
    construction) gives the cheap prefilter distance.

The SLAM pipeline stores one descriptor per keyframe and unions
scan-context candidates with the proximity ones before the (unchanged)
batched-ICP verification gate.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_slam.core.pointcloud import PointCloud


@dataclasses.dataclass(frozen=True)
class ScanContextParams:
    """Static descriptor configuration."""

    n_rings: int = 16                # radial bins
    n_sectors: int = 60              # azimuthal bins
    max_range: float = 40.0          # radial extent of the descriptor
    min_z: float = -2.0              # height offset so empty != low
    intensity_weight: float = 0.0    # > 0 blends the per-bin max INTENSITY
                                     # (cloud.attrs channel 0, the RSSI the
                                     # reference delivers at 0.01 scale —
                                     # m3d_aggregator.cpp:269-286) into the
                                     # descriptor: bin = max_z + w * max_i.
                                     # Intensity is geometry-independent
                                     # appearance — it separates places
                                     # with similar height profiles


@functools.partial(jax.jit, static_argnames=("params",))
def scan_context(cloud: PointCloud,
                 params: ScanContextParams = ScanContextParams()
                 ) -> jax.Array:
    """(R, S) max-height descriptor of a body-frame cloud.

    Empty bins read 0; occupied bins read (max z - min_z), strictly
    positive. One segment-max over flat bin ids.
    """
    R, S = params.n_rings, params.n_sectors
    pts = cloud.points
    rng = jnp.linalg.norm(pts[:, :2], axis=1)
    az = jnp.arctan2(pts[:, 1], pts[:, 0])            # [-pi, pi)
    ring = jnp.clip((rng / params.max_range * R).astype(jnp.int32), 0, R - 1)
    sect = jnp.clip(((az + jnp.pi) / (2 * jnp.pi) * S).astype(jnp.int32),
                    0, S - 1)
    ok = cloud.mask & (rng <= params.max_range)
    bin_id = jnp.where(ok, ring * S + sect, R * S)    # invalid -> dropped
    z = jnp.where(ok, pts[:, 2] - params.min_z, -jnp.inf)
    desc = jax.ops.segment_max(z, bin_id, num_segments=R * S + 1,
                               indices_are_sorted=False)[: R * S]
    desc = jnp.maximum(desc, 0.0)
    if params.intensity_weight > 0.0 and cloud.attrs is not None:
        inten = jnp.where(ok, cloud.attrs[:, 0], -jnp.inf)
        di = jax.ops.segment_max(inten, bin_id, num_segments=R * S + 1,
                                 indices_are_sorted=False)[: R * S]
        desc = desc + params.intensity_weight * jnp.maximum(di, 0.0)
    return desc.reshape(R, S)


def ring_key(desc: jax.Array) -> jax.Array:
    """(R,) rotation-invariant occupancy-mean key (cheap prefilter)."""
    return jnp.mean((desc > 0.0).astype(jnp.float32), axis=-1)


@jax.jit
def sc_distance(query: jax.Array, db: jax.Array) -> jax.Array:
    """Min-over-rotation Scan-Context distance of ``query`` to each db row.

    query: (R, S); db: (N, R, S). Returns (N,) distances in [0, 1]:
    1 - max_shift mean_col cos(query_col, db_col). All S shifts are scored
    in one contraction: stack the S rolls of the query once (S, R, S) and
    einsum against the database.
    """
    S = query.shape[1]
    shifts = jnp.stack([jnp.roll(query, k, axis=1) for k in range(S)])
    qn = shifts / jnp.maximum(
        jnp.linalg.norm(shifts, axis=1, keepdims=True), 1e-9)   # (S, R, S)
    dn = db / jnp.maximum(jnp.linalg.norm(db, axis=1, keepdims=True), 1e-9)
    # column-wise cosine, averaged over non-empty columns
    cos = jnp.einsum("krs,nrs->nks", qn, dn)                    # (N, S, S)
    nonzero = (jnp.any(shifts > 0, axis=1)[None, :, :]
               & jnp.any(db > 0, axis=1)[:, None, :])
    n_cols = jnp.maximum(jnp.sum(nonzero, axis=-1), 1)
    sim = jnp.sum(jnp.where(nonzero, cos, 0.0), axis=-1) / n_cols  # (N, S)
    return 1.0 - jnp.max(sim, axis=-1)


def propose_sc_candidates(query_desc: jax.Array, db_desc: jax.Array,
                          query_idx: int, n_nodes: int,
                          max_distance: float, min_index_gap: int,
                          top_k: int = 3) -> Tuple:
    """Scan-context candidates (i, query_idx) for the newest keyframe.

    Host-side wrapper: one device call scores the whole database, the
    top-k under ``max_distance`` (respecting the index gap) come back as
    numpy index arrays ready for the ICP verification batch.
    """
    import numpy as np

    if query_idx < min_index_gap + 1:
        return (np.zeros((0,), np.int32), np.zeros((0,), np.int32))
    # score the FULL (static-shape) database and mask on host: a
    # db_desc[:n_nodes] dynamic slice would recompile sc_distance for
    # every new keyframe count
    d = np.array(sc_distance(query_desc, db_desc))
    d[n_nodes:] = np.inf                               # empty slots
    d[max(0, query_idx - min_index_gap):] = np.inf     # too recent + self
    order = np.argsort(d, kind="stable")[:top_k]
    keep = order[d[order] <= max_distance]
    ci = keep.astype(np.int32)
    cj = np.full_like(ci, query_idx)
    return ci, cj
