"""Loop-closure detection: proximity candidates + batched ICP verification.

The reference's loop closure lived in the missing CPU graph-SLAM backend
(SURVEY.md §2.2 [inferred]). Design: candidate generation is a
dense pairwise pose-distance computation (cheap — one (N, N) matrix), and
verification registers ALL candidate keyframe pairs in one vmapped ICP
batch — the DP axis of SURVEY.md §2.3, ready to shard over devices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.graph.scan_context import ScanContextParams
from tpu_slam.registration.icp import ICPParams, ICPResult, icp


@dataclasses.dataclass(frozen=True)
class LoopClosureParams:
    """Static loop-closure configuration."""

    max_distance: float = 2.0        # candidate gate on position distance
    min_index_gap: int = 20          # skip temporally adjacent keyframes
    max_candidates: int = 16         # per detection sweep (static batch)
    min_matched_fraction: float = 0.5
    max_error: float = 0.05          # mean squared residual acceptance gate
    max_correction_t: float = 3.0    # consistency gate: reject constraints
    max_correction_r: float = 0.5    # deviating from the current estimate
                                     # by more than this (m / rad) — a
                                     # verified-looking alias (symmetric
                                     # structure) shows up as a huge
                                     # correction. Finite by default (r4
                                     # advisor: 1e9 disabled the gate, so
                                     # an unconverged alignment scraping
                                     # past the quality gates could
                                     # out-vote the odometry chain); sized
                                     # to generous accumulated drift.
    icp: ICPParams = ICPParams(max_iterations=30, max_corr_dist=1.0,
                               huber_delta=0.3)
    # Verify with point-to-PLANE ICP against stored keyframe normals.
    # Point-to-point NN residuals between two sparse-ring lidar scans taken
    # a meter apart are dominated by ring-spacing mismatch (~0.15-0.25 mse
    # at PERFECT alignment on the r4 config-4 bench — every true revisit
    # rejected); plane residuals collapse that to noise + flatness, so
    # max_error becomes a discriminative gate (calibrate to ~1e-2).
    plane_verify: bool = True
    # Symmetric verification: ALSO register i onto j and gate on the cycle
    # error ||log(Z_fwd @ Z_rev)||. A biased partial-overlap or aliased
    # alignment is not mirror-consistent (r5 diag_loop_verify: good pairs
    # cyc_t <= 0.01 m, a 4.6 m place-alias that passed every other gate
    # showed cyc_t 0.12 m). Doubles the (vmapped, tiny-batch) verify cost.
    symmetric_verify: bool = True
    max_cycle_t: float = 0.05        # m
    max_cycle_r: float = 0.03        # rad
    # Sweeps a REJECTED pair sits out before it may be re-proposed: without
    # a cooldown the same near-miss pairs burn the whole max_candidates
    # budget every sweep (r4: 3 pairs re-verified 5x each while fresh
    # revisit pairs were never tried).
    retry_cooldown: int = 6
    # appearance channel (graph/scan_context.py): candidates the proximity
    # gate cannot see once drift exceeds max_distance. 0 disables.
    use_scan_context: bool = True
    sc_max_distance: float = 0.22    # min-over-rotation SC distance gate
    sc_top_k: int = 3                # best matches proposed per keyframe
    # appearance matches farther than this from the CURRENT pose estimate
    # are place-aliases, not drift: the channel exists to bridge drift past
    # max_distance, so the bound is a generous drift budget, not the
    # proximity gate (r5 diag: ungated sc pairs 4.6 m apart verified as
    # plausible-looking dm-biased constraints and folded the graph)
    sc_max_pose_distance: float = 4.0
    sc: ScanContextParams = ScanContextParams()


def propose_candidates(positions: jax.Array, n_nodes: int,
                       params: LoopClosureParams
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Proximity-gated candidate pairs (i, j), i + gap <= j.

    positions: (N, 3) keyframe positions (poses[:, :3, 3]). Host-side
    (candidate lists are tiny and drive batched device work). Returns up to
    ``max_candidates`` pairs, nearest-first.
    """
    n = int(n_nodes)
    pos = np.asarray(positions)[:n]
    if n < params.min_index_gap + 2:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ok = (jj - ii >= params.min_index_gap) & (d <= params.max_distance)
    ci, cj = np.nonzero(ok)
    if ci.size == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    order = np.argsort(d[ci, cj], kind="stable")[:params.max_candidates]
    return ci[order].astype(np.int32), cj[order].astype(np.int32)


def verify_candidates(clouds_points: jax.Array, clouds_mask: jax.Array,
                      poses: jax.Array, cand_i: np.ndarray,
                      cand_j: np.ndarray, params: LoopClosureParams,
                      clouds_normals: jax.Array = None
                      ) -> Tuple[ICPResult, jax.Array]:
    """Register candidate pairs in one vmapped batch.

    Args:
      clouds_points: (N, P, 3) keyframe clouds in their OWN body frames.
      clouds_mask: (N, P) validity.
      poses: (N, 4, 4) current world<-keyframe estimates (init guesses).
      cand_i/cand_j: (K,) candidate indices (host arrays).
      clouds_normals: (N, P, 3) per-point normals (registration.normals),
        required when params.plane_verify — the solve and the error gate
        then run point-to-plane.

    Returns (batched ICPResult with leading axis K, accept (K,) bool). The
    measured constraint for edge (i, j) is Z = result.T — the transform
    satisfying cloud_j ~ Z @ cloud_i... specifically ICP maps source=cloud_j
    onto target=cloud_i, so Z = T_i^-1 T_j refined; feed to
    pose_graph.add_edge(i, j, Z).
    """
    plane = params.plane_verify and clouds_normals is not None
    ci = jnp.asarray(cand_i)
    cj = jnp.asarray(cand_j)
    src_pts = jnp.take(clouds_points, cj, axis=0)
    src_msk = jnp.take(clouds_mask, cj, axis=0)
    tgt_pts = jnp.take(clouds_points, ci, axis=0)
    tgt_msk = jnp.take(clouds_mask, ci, axis=0)
    Ti = jnp.take(poses, ci, axis=0)
    Tj = jnp.take(poses, cj, axis=0)
    init = jax.vmap(lambda a, b: se3.inverse(a) @ b)(Ti, Tj)

    icp_params = params.icp
    if plane:
        icp_params = dataclasses.replace(icp_params, point_to_plane=True)
        tgt_nrm = jnp.take(clouds_normals, ci, axis=0)
        src_nrm = jnp.take(clouds_normals, cj, axis=0)

        def one(sp, sm, tp, tm, tn, T0):
            return icp(PointCloud(points=sp, mask=sm),
                       PointCloud(points=tp, mask=tm),
                       init_T=T0, params=icp_params, target_normals=tn)

        res = jax.vmap(one)(src_pts, src_msk, tgt_pts, tgt_msk, tgt_nrm,
                            init)
        if params.symmetric_verify:
            init_rev = jax.vmap(se3.inverse)(res.T)
            res_rev = jax.vmap(one)(tgt_pts, tgt_msk, src_pts, src_msk,
                                    src_nrm, init_rev)
    else:
        def one(sp, sm, tp, tm, T0):
            return icp(PointCloud(points=sp, mask=sm),
                       PointCloud(points=tp, mask=tm),
                       init_T=T0, params=icp_params)

        res = jax.vmap(one)(src_pts, src_msk, tgt_pts, tgt_msk, init)
        if params.symmetric_verify:
            init_rev = jax.vmap(se3.inverse)(res.T)
            res_rev = jax.vmap(one)(tgt_pts, tgt_msk, src_pts, src_msk,
                                    init_rev)
    # gate on solution QUALITY (match fraction + residual) and on
    # CONSISTENCY with the current estimate, not on the step-norm
    # convergence flag: long-gap revisit pairs routinely hit the iteration
    # cap with a low-error, high-overlap alignment — exactly the
    # constraints worth keeping (r4: every lap-revisit loop was rejected
    # by `converged` while trivial short-gap pairs sailed through);
    # conversely an unconverged mediocre alignment admitted as a
    # constraint out-votes the odometry chain when there are many
    dev = jax.vmap(lambda Z, T0: se3.log(se3.inverse(Z) @ T0))(res.T, init)
    dev_t = jnp.linalg.norm(dev[:, :3], axis=1)
    dev_r = jnp.linalg.norm(dev[:, 3:], axis=1)
    accept = ((res.matched_fraction >= params.min_matched_fraction)
              & (res.error <= params.max_error)
              & (dev_t <= params.max_correction_t)
              & (dev_r <= params.max_correction_r))
    if params.symmetric_verify:
        cyc = jax.vmap(lambda Zf, Zr: se3.log(Zf @ Zr))(res.T, res_rev.T)
        cyc_t = jnp.linalg.norm(cyc[:, :3], axis=1)
        cyc_r = jnp.linalg.norm(cyc[:, 3:], axis=1)
        accept = (accept & (cyc_t <= params.max_cycle_t)
                  & (cyc_r <= params.max_cycle_r)
                  & (res_rev.error <= params.max_error))
    return res, accept
