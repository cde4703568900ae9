"""Transform source lm coordinates into beam-cube sampling coordinates.

Port of ``africanus_tpu/rime/transform.py`` (reference
``africanus/rime/transform.py:47``, _nb_transform_sources:14): rotate lm
by parallactic angle, add pointing errors, scale per antenna/channel,
and attach frequency as the cube's third coordinate, as one broadcast
expression.
"""

from __future__ import annotations

import torch

__all__ = ["transform_sources"]


def transform_sources(lm, parallactic_angles, pointing_errors,
                      antenna_scaling, frequency, dtype=None):
    """Create beam sampling coordinates for :func:`beam_cube_dde`.

    Parameters
    ----------
    lm : (src, 2) tensor, radians
    parallactic_angles : (time, ant) tensor, radians
    pointing_errors : (time, ant, 2) tensor, radians
    antenna_scaling : (ant, chan) tensor
    frequency : (chan,) tensor
    dtype : output dtype (default torch.float64, the reference's)

    Returns
    -------
    (3, src, time, ant, chan) tensor of (l, m, frequency) coordinates.

    Notes
    -----
    Keeps the reference numba kernel's sequential update quirk
    (transform.py:31-33): the rotated ``m`` uses the already-rotated
    ``l``, i.e. ``l' = l·cos − m·sin; m' = l'·sin + m·cos``.
    """
    lm, pa, pe, scale, frequency = (
        torch.as_tensor(x) for x in (lm, parallactic_angles, pointing_errors,
                                     antenna_scaling, frequency))

    ntime, na = pa.shape
    nsrc = lm.shape[0]
    if tuple(pe.shape) != (ntime, na, 2):
        raise ValueError(f"pointing_errors shape {tuple(pe.shape)} != {(ntime, na, 2)}")
    nchan = scale.shape[1]
    if frequency.shape[0] != nchan:
        raise ValueError("antenna_scaling and frequency channel counts differ")

    dtype = torch.float64 if dtype is None else dtype

    l = lm[:, 0][:, None, None].to(dtype)  # noqa: E741  (src,1,1)
    m = lm[:, 1][:, None, None].to(dtype)
    cos_pa = torch.cos(pa)[None, :, :].to(dtype)  # (1,time,ant)
    sin_pa = torch.sin(pa)[None, :, :].to(dtype)

    # Reference parity: m' uses the already-rotated l'
    l_rot = l * cos_pa - m * sin_pa  # (src, time, ant)
    m_rot = l_rot * sin_pa + m * cos_pa

    l_pt = l_rot + pe[None, :, :, 0].to(dtype)
    m_pt = m_rot + pe[None, :, :, 1].to(dtype)

    sc = scale[None, None, :, :].to(dtype)  # (1,1,ant,chan)
    l_out = l_pt[..., None] * sc
    m_out = m_pt[..., None] * sc
    f_out = frequency.to(dtype).expand(nsrc, ntime, na, nchan)

    return torch.stack([l_out, m_out, f_out], dim=0)
