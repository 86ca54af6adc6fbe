"""Passes compiled for the card, against the float64 references.

Marked ``gpu``: they skip without a GPU (the ``gpu`` fixture decides at
run time) and run on a card with ``JAX_PLATFORMS=cuda pytest -m gpu``
or as a phase of ``python chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_slam.core import se3
from tpu_slam.kernels.ndt_terms import (bin_points, ndt_terms_reference,
                                        terms_pass)

from test_ndt_terms_kernel import LEAF, Q, _scan, _synthetic_field

pytestmark = pytest.mark.gpu

DIMS = (24, 20, 16)


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_ndt_terms_on_card_matches_reference(gpu, impl):
    rows = _synthetic_field(dims=DIMS)
    pts, mask = _scan(3000, dims=DIMS)
    cells, keep = bin_points(pts, mask, jnp.eye(4), jnp.zeros(3), LEAF,
                             DIMS, Q)
    T = se3.exp(jnp.asarray([0.03, -0.02, 0.01, 0.02, -0.01, 0.015],
                            jnp.float32))
    H, b, c, m = terms_pass(impl)(pts, cells, keep, rows, T,
                                  jnp.float32(4.0), 1.0, DIMS,
                                  owned_x=(4, 20))
    Hr, br, cr, mr = ndt_terms_reference(pts, cells, keep, rows, T, 4.0,
                                         1.0, DIMS)
    assert np.linalg.norm(np.asarray(H) - Hr) <= 1e-4 * np.linalg.norm(Hr)
    assert np.linalg.norm(np.asarray(b) - br) <= 1e-4 * np.linalg.norm(br)
    assert abs(float(c) - cr) <= 1e-5 * abs(cr)
    _, _, _, m_all = terms_pass(impl)(pts, cells, keep, rows, T,
                                      jnp.float32(4.0), 1.0, DIMS)
    assert int(m_all) == mr and 0 < int(m) < mr


def test_icp_terms_on_card_matches_reference(gpu):
    from tpu_slam.kernels.icp_terms import (icp_terms, icp_terms_reference,
                                            target_table)

    rng = np.random.default_rng(2)
    tgt = jnp.asarray(rng.uniform(0.2, 7.8, (4000, 3)), jnp.float32)
    src = tgt + jnp.asarray(rng.normal(0, 0.05, (4000, 3)), jnp.float32)
    mask = jnp.ones(4000, bool)
    o, eye = jnp.zeros(3), jnp.eye(4)
    table = target_table(tgt, mask, o, 0.5, (16, 16, 16), 4)
    tc, tk = bin_points(tgt, mask, eye, o, 0.5, (16, 16, 16), 4)
    sc, sk = bin_points(src, mask, eye, o, 0.5, (16, 16, 16), 4)
    T = se3.exp(jnp.asarray([0.02, 0.01, -0.01, 0.01, 0.0, 0.01],
                            jnp.float32))
    got = icp_terms(src, sc, sk, table, T, 0.8, 0.3, (16, 16, 16))
    want = icp_terms_reference(src, sc, sk, tgt, tc, tk, T, 0.8, 0.3)
    for g, w in zip(got[:2], want[:2]):
        assert np.linalg.norm(np.asarray(g) - w) <= 1e-4 * np.linalg.norm(w)
    assert int(got[3]) == want[3]


def test_nn_on_card_matches_numpy(gpu):
    from tpu_slam.kernels.nn_search import nearest_neighbors

    rng = np.random.default_rng(3)
    q = rng.normal(size=(1000, 3)).astype(np.float32)
    t = rng.normal(size=(3000, 3)).astype(np.float32)
    idx, dist = nearest_neighbors(jnp.asarray(q), jnp.asarray(t))
    d = np.linalg.norm(q[:, None].astype(np.float64) - t[None], axis=2)
    np.testing.assert_allclose(np.asarray(dist), d.min(1), atol=1e-5)
    assert (d[np.arange(1000), np.asarray(idx)] - d.min(1)).max() <= 1e-5
