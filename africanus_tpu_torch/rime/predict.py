"""predict_vis — the RIME Jones-chain visibility predictor.

V_pq = G_p ( B_pq + Σ_s E_ps X_pqs E_qs^H ) G_q^H

Port of ``africanus_tpu/rime/predict.py`` (reference
``africanus/rime/predict.py``: predict_vis:466, predict_checks:380,
apply_gains:622) on complex tensors.

- Absent optional arguments select the chain in host Python, as the
  reference specialises a closure per presence combination.
- Antenna-indexed Jones terms (src, time, ant, chan, corr…) are gathered
  to rows by advanced indexing; the chain is then elementwise complex
  arithmetic ("diag" corr layouts (1,), (2,), (4,)) or 2×2 products
  (:mod:`africanus_tpu_torch.ops.jones`), summed over sources.
- ``source_block`` loops over the source axis in blocks, bounding peak
  memory like the reference dask layer's LinearReduction.
"""

from __future__ import annotations

import functools

import torch

from africanus_tpu_torch.ops import jones as j2

__all__ = ["predict_vis", "apply_gains"]


def _check_args(dde1, coh, dde2, die1, bvis, die2):
    """Mirror of reference predict_checks (rime/predict.py:380-463)."""
    have_ddes1, have_ddes2 = dde1 is not None, dde2 is not None
    have_dies1, have_dies2 = die1 is not None, die2 is not None

    if have_ddes1 ^ have_ddes2:
        raise ValueError("dde1_jones and dde2_jones must be present or absent together")
    if have_dies1 ^ have_dies2:
        raise ValueError("die1_jones and die2_jones must be present or absent together")

    have_ddes = have_ddes1 and have_ddes2
    have_coh = coh is not None
    have_dies = have_dies1 and have_dies2
    have_bvis = bvis is not None

    if have_ddes and dde1.ndim not in (5, 6):
        raise ValueError(f"dde1_jones.ndim {dde1.ndim} not in (5, 6)")
    if have_ddes and dde1.ndim != dde2.ndim:
        raise ValueError("dde1_jones and dde2_jones rank mismatch")
    if have_coh and coh.ndim not in (4, 5):
        raise ValueError(f"source_coh.ndim {coh.ndim} not in (4, 5)")
    if have_dies and die1.ndim not in (4, 5):
        raise ValueError(f"die1_jones.ndim {die1.ndim} not in (4, 5)")
    if have_dies and die1.ndim != die2.ndim:
        raise ValueError("die1_jones and die2_jones rank mismatch")
    if have_bvis and bvis.ndim not in (3, 4):
        raise ValueError(f"base_vis.ndim {bvis.ndim} not in (3, 4)")

    # All present terms must agree on the correlation layout
    sizes = []
    if have_ddes:
        n = dde1.ndim
        sizes.append([n, n - 1, n - 2, n - 1])
    if have_coh:
        n = coh.ndim
        sizes.append([n + 1, n, n - 1, n])
    if have_dies:
        n = die1.ndim
        sizes.append([n + 1, n, n - 1, n])
    if have_bvis:
        n = bvis.ndim
        sizes.append([n + 2, n + 1, n, n + 1])
    if not all(sizes[0] == s for s in sizes[1:]):
        raise ValueError(
            "A rank pre-condition failed "
            "(missing values are ignored):\n"
            "dde_jones{1,2}.ndim == source_coh.ndim + 1\n"
            "dde_jones{1,2}.ndim == base_vis.ndim + 2\n"
            "dde_jones{1,2}.ndim == die_jones{1,2}.ndim + 1"
        )

    # 2x2 iff the dde ndim is 6 / coh ndim 5 / die ndim 5 / bvis ndim 4
    if have_ddes:
        full = dde1.ndim == 6
    elif have_coh:
        full = coh.ndim == 5
    elif have_dies:
        full = die1.ndim == 5
    elif have_bvis:
        full = bvis.ndim == 4
    else:
        raise ValueError(
            "Insufficient inputs to infer the output visibility shape"
        )

    return have_ddes, have_coh, have_dies, have_bvis, full


def _jones_chain(a1, x, a2, full):
    """A1 · X · A2ᴴ (or the available subset) for one source block."""
    if a1 is not None and x is not None:
        if full:
            return j2.mul2x2(a1, j2.mul2x2_hr(x, a2))
        return a1 * x * a2.conj()
    if a1 is not None:
        if full:
            return j2.mul2x2_hr(a1, a2)
        return a1 * a2.conj()
    return x


def predict_vis(
    time_index,
    antenna1,
    antenna2,
    dde1_jones=None,
    source_coh=None,
    dde2_jones=None,
    die1_jones=None,
    base_vis=None,
    die2_jones=None,
    source_block: int | None = None,
):
    """Predict visibilities from a chain of Jones terms.

    Parameters
    ----------
    time_index : (row,) integer tensor — indices into the time dimension
        of the dde/die terms, normalised here by subtracting its minimum
        (reference semantics, predict.py:585), so a row chunk indexes a
        term table that starts at the chunk's first time.
    antenna1, antenna2 : (row,) integer tensors
    dde1_jones, dde2_jones : (src, time, ant, chan, corr…) tensors
    source_coh : (src, row, chan, corr…) tensor
    die1_jones, die2_jones : (time, ant, chan, corr…) tensors
    base_vis : (row, chan, corr…) tensor
    source_block : optional int — sum the source axis in blocks of this
        size to bound memory (requires src % source_block == 0).

    corr… is (1,), (2,), (4,) (diagonal, elementwise) or (2, 2).

    Returns
    -------
    (row, chan, corr…) complex tensor of the inputs' promoted dtype
    (at least complex64).
    """
    opt = [dde1_jones, source_coh, dde2_jones, die1_jones, base_vis, die2_jones]
    present = [a for a in opt if a is not None]
    if not present:
        raise ValueError(
            "Insufficient inputs to infer the output visibility shape"
        )
    out_dtype = functools.reduce(torch.promote_types,
                                 (a.dtype for a in present), torch.complex64)
    dde1, coh, dde2, die1, bvis, die2 = (
        a.to(out_dtype) if a is not None else None for a in opt
    )

    have_ddes, have_coh, have_dies, have_bvis, full = _check_args(
        dde1, coh, dde2, die1, bvis, die2
    )

    ti = time_index - time_index.min()

    def source_sum(dde1, coh, dde2):
        """Σ_s A1·X·A2ᴴ with row-gathered DDEs."""
        if have_ddes:
            a1 = dde1[:, ti, antenna1]  # (src, row, chan, corr…)
            a2 = dde2[:, ti, antenna2]
        else:
            a1 = a2 = None
        return _jones_chain(a1, coh, a2, full).sum(dim=0)

    if not have_ddes and not have_coh:
        out = None
    elif source_block is None:
        out = source_sum(dde1, coh, dde2)
    else:
        nsrc = (dde1 if have_ddes else coh).shape[0]
        if nsrc % source_block != 0:
            raise ValueError(
                f"source count {nsrc} not divisible by source_block {source_block}"
            )
        out = None
        for s0 in range(0, nsrc, source_block):
            blk = slice(s0, s0 + source_block)
            s = source_sum(dde1[blk] if have_ddes else None,
                           coh[blk] if have_coh else None,
                           dde2[blk] if have_ddes else None)
            out = s if out is None else out + s

    if have_bvis:
        out = bvis if out is None else out + bvis

    if have_dies:
        g1 = die1[ti, antenna1]  # (row, chan, corr…)
        g2 = die2[ti, antenna2]
        if out is None:
            # Reference semantics: dies-only starts from a zero visibility
            # buffer (predict.py:288-300 output_factory), so G·0·Gᴴ = 0.
            out = torch.zeros_like(g1)
        elif full:
            out = j2.mul2x2(g1, j2.mul2x2_hr(out, g2))
        else:
            out = g1 * out * g2.conj()

    return out


def apply_gains(time_index, antenna1, antenna2, gains1, vis, gains2):
    """Apply direction-independent gains to visibilities: G_p · V_pq · G_qᴴ.

    A convenience alias for :func:`predict_vis` with only
    ``die{1,2}_jones`` and ``base_vis`` set (reference
    ``rime/predict.py:622``).

    Parameters
    ----------
    time_index : (row,) int, index of each row's unique time
    antenna1, antenna2 : (row,) int antenna indices
    gains1, gains2 : (time, ant, chan, corr...) complex gains
    vis : (row, chan, corr...) complex visibilities

    Returns
    -------
    (row, chan, corr...) complex corrupted visibilities.
    """
    return predict_vis(
        time_index,
        antenna1,
        antenna2,
        die1_jones=gains1,
        base_vis=vis,
        die2_jones=gains2,
    )
