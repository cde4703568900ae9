"""Fused RIME transformers: derive missing term inputs from other columns.

Port of ``africanus_tpu/rime/fused/transformers.py`` (reference
``africanus/experimental/rime/fused/transformers/``): LMTransformer
(lm.py:8: radec + phase_dir → lm) and ParallacticTransformer
(parangle.py:10: times + antenna positions + phase_dir → beam/feed
parallactic angles). They are plain functions run at state-build time;
the parallactic angles are computed on the host in float64 (MJD seconds
do not fit float32) and put on the state's device.
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.coordinates.transforms import radec_to_lm
from africanus_tpu_torch.rime.parangles import parallactic_angles

__all__ = ["LMTransformer", "ParallacticTransformer", "TRANSFORMERS"]


class Transformer:
    OUTPUTS = ()
    ARGS = ()

    def can_create(self, available):
        return all(a in available for a in self.ARGS)

    def transform(self, state):
        raise NotImplementedError


class LMTransformer(Transformer):
    """radec + phase_dir → lm (transformers/lm.py:8)."""

    OUTPUTS = ("lm",)
    ARGS = ("radec", "phase_dir")

    def transform(self, state):
        return {"lm": radec_to_lm(state["radec"], state["phase_dir"])}


def _host(x):
    """A numpy copy (or view) of a tensor or array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ParallacticTransformer(Transformer):
    """utime + antenna_position + phase_dir → beam_parangle (utime, ant)
    and feed_parangle (utime, feed, ant, 2, 2) sin/cos tables
    (transformers/parangle.py:10). Receptor angles default to zero;
    ``receptor_angle`` of shape (ant, 2) offsets the two receptors."""

    OUTPUTS = ("beam_parangle", "feed_parangle")
    ARGS = ("utime", "antenna_position", "phase_dir")

    def transform(self, state):
        utime = _host(state["utime"])
        pa = parallactic_angles(utime, _host(state["antenna_position"]),
                                _host(state["phase_dir"]), backend="numpy")
        nutime, nant = pa.shape
        nfeed = state["ufeed"].shape[0] if "ufeed" in state else 1

        ra = state.get("receptor_angle")
        ra = np.zeros((nant, 2)) if ra is None else _host(ra)

        # (utime, 1, ant): one angle table broadcast over feeds
        ang_a = pa[:, None, :] + ra[None, None, :, 0]
        ang_b = pa[:, None, :] + ra[None, None, :, 1]
        feed_pa = np.stack(
            [
                np.stack([np.sin(ang_a), np.cos(ang_a)], axis=-1),
                np.stack([np.sin(ang_b), np.cos(ang_b)], axis=-1),
            ],
            axis=-2,
        )  # (utime, 1, ant, 2, 2)
        feed_pa = np.broadcast_to(feed_pa, (nutime, nfeed, nant, 2, 2)).copy()

        device = state["time_inverse"].device
        return {
            "beam_parangle": torch.as_tensor(pa, device=device),
            "feed_parangle": torch.as_tensor(feed_pa, device=device),
        }


TRANSFORMERS = (LMTransformer(), ParallacticTransformer())
