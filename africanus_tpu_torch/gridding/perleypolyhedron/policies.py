"""Gridding strategy policies of the Perley-polyhedron gridder.

Port of ``africanus_tpu/gridding/perleypolyhedron/policies.py`` (itself
after ``africanus/gridding/perleypolyhedron/policies/``): policies are
plain Python branches on strings.

- baseline transforms: "None", "rotate" (facet tangent-plane rotation,
  Thompson/Moran/Swenson ch. 4) and "wlinapprox" (Kogan & Greisen AIPS
  memo 113 planar w approximation). The reference's "rotate" indexes
  uvw[3] (out of bounds) and chains in-place updates; this applies the
  documented matrix, as the JAX package does. Host numpy inputs stay
  numpy (planning quantises taps in float64 on the host); torch tensors
  stay on their device.
- phase transforms: "None", "phase_rotate", on torch complex
  visibilities (the phase formed in float64 on the visibilities'
  device).
- Stokes conversions: the full {stokes}_FROM_{corrs} /
  {corrs}_FROM_{stokes} table, on torch complex tensors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "baseline_transform",
    "phase_transform",
    "corr2stokes",
    "stokes2corr",
    "ncorr_out",
]


def baseline_transform(uvw, ra0, dec0, ra, dec, policy_type):
    """Transform (row, 3) uvw coordinates (numpy or torch) for faceting."""
    if policy_type == "None":
        return uvw

    # Python floats (not numpy scalars) so that torch tensors stay tensors
    d_ra = ra - ra0
    c_d_ra, s_d_ra = float(np.cos(d_ra)), float(np.sin(d_ra))
    c_new, s_new = float(np.cos(dec)), float(np.sin(dec))
    c_old, s_old = float(np.cos(dec0)), float(np.sin(dec0))
    stack = np.stack if isinstance(uvw, np.ndarray) else torch.stack

    if policy_type == "rotate":
        # elementwise row combinations, in the JAX package's order
        mat = [
            (c_d_ra, s_old * s_d_ra, -c_old * s_d_ra),
            (
                -s_new * s_d_ra,
                s_new * s_old * c_d_ra + c_new * c_old,
                -c_old * s_new * c_d_ra + c_new * s_old,
            ),
            (
                c_new * s_d_ra,
                -c_new * s_old * c_d_ra + s_new * c_old,
                c_new * c_old * c_d_ra + s_new * s_old,
            ),
        ]
        u, v, w = uvw[:, 0], uvw[:, 1], uvw[:, 2]
        return stack([m0 * u + m1 * v + m2 * w for (m0, m1, m2) in mat], 1)

    if policy_type == "wlinapprox":
        li0 = c_new * s_d_ra
        mi0 = s_new * c_old - c_new * s_old * c_d_ra
        ni0 = s_new * s_old + c_new * c_old * c_d_ra
        u = uvw[:, 0] - uvw[:, 2] * li0 / ni0
        v = uvw[:, 1] - uvw[:, 2] * mi0 / ni0
        return stack([u, v, uvw[:, 2]], 1)

    raise ValueError("unknown baseline transform policy")


def phase_transform(vis, uvw, wavelengths, ra0, dec0, ra, dec, policy_type,
                    phasesign=1.0):
    """Phase-rotate (row, chan, corr) complex visibilities to the facet
    centre (phase_transform_policies.py:9-34). ``uvw`` (row, 3) and
    ``wavelengths`` (chan,) may be numpy or tensors; the phase is formed
    in float64 on ``vis``'s device."""
    if policy_type == "None":
        return vis
    if policy_type != "phase_rotate":
        raise ValueError("Invalid phase transform policy type")

    d_ra = ra - ra0
    c_dec, s_dec = np.cos(dec), np.sin(dec)
    c_dec0, s_dec0 = np.cos(dec0), np.sin(dec0)
    ll = c_dec * np.sin(d_ra)
    mm = s_dec * c_dec0 - c_dec * s_dec0 * np.cos(d_ra)
    nn = -(1.0 - np.sqrt(max(1.0 - ll * ll - mm * mm, 0.0)))
    ll, mm, nn = float(ll), float(mm), float(nn)

    uvw = torch.as_tensor(uvw).to(device=vis.device, dtype=torch.float64)
    wl = torch.as_tensor(np.asarray(wavelengths).ravel()
                         if not isinstance(wavelengths, torch.Tensor)
                         else wavelengths.reshape(-1)).to(
        device=vis.device, dtype=torch.float64)
    dot = uvw[:, 0] * ll + uvw[:, 1] * mm + uvw[:, 2] * nn  # (row,)
    x = phasesign * 2.0 * np.pi * dot[:, None] / wl
    rot = torch.complex(torch.cos(x), torch.sin(x)).to(vis.dtype)
    return vis * rot[..., None]


# {stokes}_FROM_{corr-schema}: (indices, complex weights)
_CORR2STOKES = {
    "I_FROM_XXYY": ((0, 1), (0.5, 0.5)),
    "I_FROM_XXXYYXYY": ((0, 3), (0.5, 0.5)),
    "I_FROM_RRLL": ((0, 1), (0.5, 0.5)),
    "I_FROM_RRRLLRLL": ((0, 3), (0.5, 0.5)),
    "Q_FROM_XXYY": ((0, 1), (0.5, -0.5)),
    "Q_FROM_XXXYYXYY": ((0, 3), (0.5, -0.5)),
    "Q_FROM_RRRLLRLL": ((1, 2), (0.5, 0.5)),
    "U_FROM_XYYX": ((0, 1), (0.5, 0.5)),
    "U_FROM_XXXYYXYY": ((1, 2), (0.5, 0.5)),
    "U_FROM_RLLR": ((0, 1), (-0.5j, 0.5j)),
    "U_FROM_RRRLLRLL": ((1, 2), (-0.5j, 0.5j)),
    "V_FROM_RRLL": ((0, 1), (0.5, -0.5)),
    "V_FROM_RRRLLRLL": ((0, 3), (0.5, -0.5)),
    "V_FROM_XYYX": ((0, 1), (-0.5j, 0.5j)),
    "V_FROM_XXXYYXYY": ((1, 2), (-0.5j, 0.5j)),
}

# {corr-schema}_FROM_{stokes}: per-output-corr weights
_STOKES2CORR = {
    "XXYY_FROM_I": (1.0, 1.0),
    "XXXYYXYY_FROM_I": (1.0, 0.0, 0.0, 1.0),
    "RRLL_FROM_I": (1.0, 1.0),
    "RRRLLRLL_FROM_I": (1.0, 0.0, 0.0, 1.0),
    "XXYY_FROM_Q": (1.0, -1.0),
    "XXXYYXYY_FROM_Q": (1.0, 0.0, 0.0, -1.0),
    "RLLR_FROM_Q": (1.0, 1.0),
    "RRRLLRLL_FROM_Q": (0.0, 1.0, 1.0, 0.0),
    "XYYX_FROM_U": (1.0, 1.0),
    "XXXYYXYY_FROM_U": (0.0, 1.0, 1.0, 0.0),
    "RLLR_FROM_U": (1.0j, -1.0j),
    "RRRLLRLL_FROM_U": (0.0, 1.0j, -1.0j, 0.0),
    "XYYX_FROM_V": (1.0j, -1.0j),
    "XXXYYXYY_FROM_V": (0.0, 1.0j, -1.0j, 0.0),
    "RRLL_FROM_V": (1.0, -1.0),
    "RRRLLRLL_FROM_V": (1.0, 0.0, 0.0, -1.0),
}


def corr2stokes(vis, policy_type):
    """(…, corr) complex correlations → (…,) complex Stokes scalar."""
    try:
        idx, wgt = _CORR2STOKES[policy_type]
    except KeyError:
        raise ValueError("Invalid stokes mapping for the correlation schema")
    out = None
    for i, w in zip(idx, wgt):
        term = vis[..., i] * complex(w)
        out = term if out is None else out + term
    return out


def stokes2corr(value, policy_type):
    """(…,) complex Stokes scalar → (…, corr) complex correlations."""
    try:
        wgt = _STOKES2CORR[policy_type]
    except KeyError:
        raise ValueError("Invalid stokes mapping for the correlation schema")
    return torch.stack([value * complex(w) for w in wgt], dim=-1)


def ncorr_out(policy_type):
    """Number of correlations a stokes2corr policy produces."""
    return len(_STOKES2CORR[policy_type])
