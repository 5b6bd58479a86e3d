"""Float64 NumPy ground truth shared by the intersector tests.

A float64 Moller-Trumbore over the whole world triangle soup. It is the
comparison baseline rather than intersect_brute_force: f32 Moller-Trumbore
is unstable for rays that graze a shared edge or a near-parallel triangle,
and two f32 paths may legitimately resolve such an edge differently.
"""

import numpy as np


def brute_f64(arr, ro, rd, only_instance=None, tmax=None):
    """Nearest hit over the padded world soup: (t (R,), soup column (R,)),
    t = 1e30 for a miss."""
    w9 = np.asarray(arr.world_tris9, np.float64)
    wi = np.asarray(arr.world_tri_inst)
    ro = np.asarray(ro, np.float64)
    rd = np.asarray(rd, np.float64)
    v0, v1, v2 = w9[0:3].T, w9[3:6].T, w9[6:9].T
    e1, e2 = v1 - v0, v2 - v0
    h = np.cross(rd[:, None, :], e2[None])
    a = (e1[None] * h).sum(-1)
    par = np.abs(a) < 1e-12
    f = 1.0 / np.where(par, 1.0, a)
    s = ro[:, None, :] - v0[None]
    u = f * (s * h).sum(-1)
    q = np.cross(s, e1[None])
    v = f * (q * rd[:, None, :]).sum(-1)
    t = f * (e2[None] * q).sum(-1)
    valid = wi >= 0 if only_instance is None else wi == only_instance
    hit = (~par) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
    hit &= valid[None]
    t = np.where(hit, t, 1e30)
    if tmax is not None:
        t = np.where(t < np.asarray(tmax, np.float64)[:, None], t, 1e30)
    return t.min(axis=1), t.argmin(axis=1)
