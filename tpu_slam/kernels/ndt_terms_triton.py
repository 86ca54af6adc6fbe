"""NDT terms pass as one Pallas kernel through Triton (GPU).

Same frozen-bin point-major pass as kernels.ndt_terms.ndt_terms, fused:
a program takes ``block`` points, loops over the 27 neighbour cells
(gathering the 10 used channels of each neighbour row with masked loads),
keeps the per-point factors y (3), sum s Lambda (6), s and the gate in
registers, expands the per-point normal equations and writes the
block's 29 partial sums. One small XLA sum over blocks finishes the
reduction. Nothing of the (N, 27, 16) gather is stored.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpu_slam.kernels.ndt_terms import Dims


def _kernel(scal_ref, px_ref, py_ref, pz_ref, cx_ref, cy_ref, cz_ref,
            keep_ref, rows_ref, out_ref, *, n: int, dims: Dims, block: int,
            owned_x: Optional[Tuple[int, int]]):
    wx, wy, wz = dims
    i = pl.program_id(0)
    idx = i * block + jnp.arange(block, dtype=jnp.int32)
    inb = idx < n
    px = plgpu.load(px_ref.at[idx], mask=inb, other=0.0)
    py = plgpu.load(py_ref.at[idx], mask=inb, other=0.0)
    pz = plgpu.load(pz_ref.at[idx], mask=inb, other=0.0)
    cx = plgpu.load(cx_ref.at[idx], mask=inb, other=0)
    cy = plgpu.load(cy_ref.at[idx], mask=inb, other=0)
    cz = plgpu.load(cz_ref.at[idx], mask=inb, other=0)
    keep = plgpu.load(keep_ref.at[idx], mask=inb, other=0) > 0
    t = [scal_ref[j] for j in range(12)]
    inv_2g = scal_ref[12]
    maxd2 = scal_ref[13]
    tx = t[0] * px + t[1] * py + t[2] * pz + t[3]
    ty = t[4] * px + t[5] * py + t[6] * pz + t[7]
    tz = t[8] * px + t[9] * py + t[10] * pz + t[11]

    def body(nx, ny, nz, acc):
        ok = (keep & (nx >= 0) & (nx < wx) & (ny >= 0) & (ny < wy)
              & (nz >= 0) & (nz < wz))
        base = jnp.where(ok, ((nx * wy + ny) * wz + nz) * 16, 0)
        ch = [plgpu.load(rows_ref.at[base + c], mask=ok, other=0.0)
              for c in range(10)]
        r0, r1, r2 = tx - ch[0], ty - ch[1], tz - ch[2]
        l00, l01, l02, l11, l12, l22 = ch[3:9]
        q0 = l00 * r0 + l01 * r1 + l02 * r2
        q1 = l01 * r0 + l11 * r1 + l12 * r2
        q2 = l02 * r0 + l12 * r1 + l22 * r2
        d2 = q0 * r0 + q1 * r1 + q2 * r2
        de2 = r0 * r0 + r1 * r1 + r2 * r2
        gate = ok & (ch[9] > 0.5) & (de2 < maxd2)
        s = jnp.where(gate, jnp.exp(-jnp.minimum(d2 * inv_2g, 30.0)), 0.0)
        y0, y1, y2, c00, c01, c02, c11, c12, c22, ssum, m = acc
        return (y0 + s * q0, y1 + s * q1, y2 + s * q2,
                c00 + s * l00, c01 + s * l01, c02 + s * l02,
                c11 + s * l11, c12 + s * l12, c22 + s * l22,
                ssum + s, jnp.maximum(m, gate.astype(jnp.float32)))

    # nested loops over dx, dy, dz (no integer div/mod of the loop index)
    def over_z(dx, dy, acc):
        return jax.lax.fori_loop(
            -1, 2, lambda dz, a: body(cx + dx, cy + dy, cz + dz, a), acc)

    def over_y(dx, acc):
        return jax.lax.fori_loop(-1, 2, lambda dy, a: over_z(dx, dy, a), acc)

    zero = jnp.zeros((block,), jnp.float32)
    (y0, y1, y2, c00, c01, c02, c11, c12, c22, ssum, m) = jax.lax.fori_loop(
        -1, 2, over_y, (zero,) * 11)
    if owned_x is not None:
        m = jnp.where((cx >= owned_x[0]) & (cx < owned_x[1]), m, 0.0)

    m00 = c01 * tz - c02 * ty
    m01 = -c00 * tz + c02 * tx
    m02 = c00 * ty - c01 * tx
    m10 = c11 * tz - c12 * ty
    m11 = -c01 * tz + c12 * tx
    m12 = c01 * ty - c11 * tx
    m20 = c12 * tz - c22 * ty
    m21 = -c02 * tz + c22 * tx
    m22 = c02 * ty - c12 * tx
    vals = [c00, c01, c02, -m00, -m01, -m02,
            c11, c12, -m10, -m11, -m12,
            c22, -m20, -m21, -m22,
            tz * m10 - ty * m20, tz * m11 - ty * m21, tz * m12 - ty * m22,
            -tz * m01 + tx * m21, -tz * m02 + tx * m22,
            ty * m02 - tx * m12,
            y0, y1, y2,
            ty * y2 - tz * y1, tz * y0 - tx * y2, tx * y1 - ty * y0,
            ssum, m]
    lane = jnp.arange(32, dtype=jnp.int32)
    vec = jnp.zeros((32,), jnp.float32)
    for j, v in enumerate(vals):
        vec = jnp.where(lane == j, jnp.sum(v), vec)
    plgpu.store(out_ref.at[i * 32 + lane], vec)


@functools.partial(jax.jit, static_argnames=("dims", "owned_x", "block",
                                             "num_warps", "interpret"))
def ndt_terms_triton(points: jax.Array, cells: jax.Array, keep: jax.Array,
                     rows: jax.Array, T: jax.Array, gamma: jax.Array,
                     max_corr_dist: float, dims: Dims,
                     owned_x: Optional[Tuple[int, int]] = None,
                     block: int = 64, num_warps: int = 2,
                     interpret: bool = False):
    """Fused frozen-bin NDT terms pass; same contract as ndt_terms."""
    n = points.shape[0]
    n_blocks = pl.cdiv(n, block)
    scal = jnp.concatenate([
        T[:3].reshape(-1).astype(jnp.float32),
        jnp.stack([0.5 / jnp.asarray(gamma, jnp.float32),
                   jnp.float32(max_corr_dist) ** 2]),
        jnp.zeros((2,), jnp.float32)])
    kernel = functools.partial(_kernel, n=n, dims=dims, block=block,
                               owned_x=owned_x)
    out = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        out_shape=jax.ShapeDtypeStruct((n_blocks * 32,), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ndt_terms_triton",
    )(scal, points[:, 0], points[:, 1], points[:, 2], cells[:, 0],
      cells[:, 1], cells[:, 2], keep.astype(jnp.int32), rows.reshape(-1))
    tot = jnp.sum(out.reshape(n_blocks, 32), axis=0)
    iu0, iu1 = np.triu_indices(6)
    H = jnp.zeros((6, 6), jnp.float32).at[iu0, iu1].set(tot[:21])
    H = H + jnp.triu(H, 1).T
    return H, tot[21:27], -tot[27], tot[28]
