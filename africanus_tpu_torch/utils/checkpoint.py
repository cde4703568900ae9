"""Checkpoint/resume for long-running solves.

Port of ``africanus_tpu/utils/checkpoint.py`` (SURVEY.md §5: the
reference has no checkpointing — persistence is writing MODEL_DATA back
to the MS). A checkpoint is a directory holding one ``tree.pt``: the
tree's leaves as CPU tensors in a nest of dicts, lists and tuples,
written by ``torch.save`` to a temporary file and renamed into place, so
a killed writer leaves the previous checkpoint whole. It is read with
``torch.load(weights_only=True)``, which builds no Python object but
tensors and containers. Orbax's on-disk format is not a goal.

Leaves are tensors (on any device), numpy arrays and Python numbers.
Named tuples are saved as tuples; ``restore(path, like=...)`` rebuilds
the structure of ``like`` (named tuples included) with each leaf in the
dtype and on the device of ``like``'s leaf. ``CheckpointLoop`` wraps an
iterative loop: it restores the latest step on construction and saves
every ``every`` steps, so a killed job resumes where it stopped.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointLoop"]

_FILE = "tree.pt"


def _leaves(tree):
    """Leaves in a fixed order: dict entries by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to_saved(tree):
    """The tree with plain containers and CPU tensor leaves."""
    if isinstance(tree, dict):
        return {k: _to_saved(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_to_saved(v) for v in tree]
        return items if isinstance(tree, list) else tuple(items)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return torch.as_tensor(np.asarray(tree))


def _rebuild(like, leaves):
    """``like``'s structure filled from the iterator ``leaves``."""
    if isinstance(like, dict):
        filled = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (tuple, list)):
        items = [_rebuild(v, leaves) for v in like]
        if isinstance(like, list):
            return items
        return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
    leaf = next(leaves)
    if isinstance(like, torch.Tensor):
        return leaf.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float, complex)):
        return type(like)(leaf.item())
    return leaf.numpy().astype(np.asarray(like).dtype)


def save(path, tree, force=True):
    """Write a tree checkpoint to ``path`` (a directory). The file is
    complete on disk when this returns. With ``force=False`` an existing
    checkpoint raises FileExistsError."""
    path = os.path.abspath(str(path))
    target = os.path.join(path, _FILE)
    if os.path.exists(target) and not force:
        raise FileExistsError(f"checkpoint {path} exists")
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_to_saved(tree), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore(path, like=None):
    """Read a tree checkpoint. ``like`` (a tree of the same structure)
    restores into that structure, each leaf in the dtype and on the
    device of ``like``'s; without it the saved tree (dicts, lists and
    tuples of CPU tensors) is returned."""
    tree = torch.load(os.path.join(os.path.abspath(str(path)), _FILE),
                      weights_only=True)
    if like is None:
        return tree
    saved, wanted = _leaves(tree), _leaves(like)
    if len(saved) != len(wanted):
        raise ValueError(f"checkpoint {path} holds {len(saved)} leaves, "
                         f"like has {len(wanted)}")
    return _rebuild(like, iter(saved))


def latest_step(directory):
    """Largest ``step_N`` checkpoint index under ``directory`` or None."""
    try:
        entries = os.listdir(str(directory))
    except FileNotFoundError:
        return None
    steps = [
        int(e.split("_", 1)[1])
        for e in entries
        if e.startswith("step_") and e.split("_", 1)[1].isdigit()
        and os.path.exists(os.path.join(str(directory), e, _FILE))
    ]
    return max(steps) if steps else None


class CheckpointLoop:
    """Resumable iteration loop.

    >>> loop = CheckpointLoop("ckpt", init_state, every=10)
    >>> for step, state in loop.range(200):
    ...     state = update(state)
    ...     loop.state = state
    resumes from the latest saved step after a restart.
    """

    def __init__(self, directory, init_state, every=10):
        self.directory = str(directory)
        self.every = int(every)
        step = latest_step(self.directory)
        if step is None:
            self.start = 0
            self.state = init_state
        else:
            self.start = step + 1
            self.state = restore(
                os.path.join(self.directory, f"step_{step}"), like=init_state
            )

    def _save(self, step):
        save(os.path.join(self.directory, f"step_{step}"), self.state)

    def range(self, n_steps):
        for step in range(self.start, n_steps):
            yield step, self.state
            if (step + 1) % self.every == 0 or step == n_steps - 1:
                self._save(step)
