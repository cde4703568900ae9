"""A minimal Measurement-Set-shaped column store on plain ``.npy`` files.

Port of ``africanus_tpu/io/ms_store.py``, a numpy module, kept here as
its own copy so that the port needs nothing of the JAX package. The
on-disk format is the same byte for byte: a store written by either
package opens in the other.

The reference's flagship example reads a real MS through daskms/casacore
and writes MODEL_DATA back (africanus/rime/examples/predict.py:531-587).
This module provides the same *shape* of IO without them: a directory of
memory-mappable ``.npy`` columns (TIME, ANTENNA1, ANTENNA2, UVW, DATA,
MODEL_DATA, …) plus JSON "subtables" (FIELD phase centre,
SPECTRAL_WINDOW channel frequencies, ANTENNA positions), with chunked
row reads and in-place row writes — the operations a predict pipeline
needs to stream visibilities through a device without holding the whole
MS in memory.

Layout::

    store/
      meta.json                 # {"nrow": N, "subtables": {...}}
      TIME.npy ANTENNA1.npy ... # one mmap-able .npy per column

Complex columns are stored as float pairs with a trailing axis of 2
(re, im); :meth:`MSStore.read` reassembles complex and
:meth:`MSStore.write` splits it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["MSStore"]

_META = "meta.json"


class MSStore:
    """Columnar visibility store with chunked row access — a stand-in
    for a Measurement Set accessed via daskms (the reference's examples
    read and write MODEL_DATA through ``daskms.xds_from_ms``).

    On-disk layout: one ``.npy`` per column plus ``meta.json`` (nrow,
    complex-column registry, JSON subtables). Complex columns are
    stored as trailing (re, im) float pairs and materialise as
    complex on read (or as pairs via ``read_pair``). Row ranges are
    memory-mapped, so chunked pipelines only touch the rows they
    stream (``iter_chunks``)."""

    def __init__(self, path):
        self.path = Path(path)
        meta_path = self.path / _META
        if not meta_path.exists():
            raise FileNotFoundError(f"no column store at {self.path}")
        meta = json.loads(meta_path.read_text())
        self.nrow = int(meta["nrow"])
        self.subtables = meta.get("subtables", {})
        self._complex_cols = set(meta.get("complex_columns", []))

    # -- creation ---------------------------------------------------------
    @classmethod
    def create(cls, path, columns, subtables=None):
        """Write a new store. ``columns`` maps names to (nrow, …) arrays;
        complex arrays are split into trailing (re, im) pairs on disk.
        ``subtables`` is a JSON-serialisable mapping (lists/scalars)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        nrow = None
        complex_cols = []
        for name, arr in columns.items():
            arr = np.asarray(arr)
            if nrow is None:
                nrow = arr.shape[0]
            elif arr.shape[0] != nrow:
                raise ValueError(
                    f"column {name} has {arr.shape[0]} rows, expected {nrow}"
                )
            if np.iscomplexobj(arr):
                complex_cols.append(name)
                arr = np.stack([arr.real, arr.imag], axis=-1)
            np.save(path / f"{name}.npy", arr)
        meta = dict(
            nrow=int(nrow or 0),
            complex_columns=complex_cols,
            subtables=_jsonable(subtables or {}),
        )
        (path / _META).write_text(json.dumps(meta, indent=1))
        return cls(path)

    # -- access -----------------------------------------------------------
    def columns(self):
        return sorted(p.stem for p in self.path.glob("*.npy"))

    def _mmap(self, name, mode="r"):
        f = self.path / f"{name}.npy"
        if not f.exists():
            raise KeyError(f"no column {name} in {self.path}")
        return np.load(f, mmap_mode=mode)

    def read(self, name, rows=None):
        """Read a column (or a row slice of it). Complex columns are
        reassembled from their on-disk (re, im) pairs."""
        m = self._mmap(name)
        out = np.array(m if rows is None else m[rows])
        if name in self._complex_cols:
            out = out[..., 0] + 1j * out[..., 1]
        return out

    def read_pair(self, name, rows=None):
        """Read a complex column as its raw (…, 2) float pair, as it
        lies on disk."""
        if name not in self._complex_cols:
            raise ValueError(f"{name} is not a complex column")
        m = self._mmap(name)
        return np.array(m if rows is None else m[rows])

    def write(self, name, values, rows=None):
        """Write (a row slice of) a column in place."""
        values = np.asarray(values)
        if np.iscomplexobj(values):
            if name not in self._complex_cols:
                raise ValueError(
                    f"{name} was not created as a complex column"
                )
            values = np.stack([values.real, values.imag], axis=-1)
        m = self._mmap(name, mode="r+")
        if rows is None:
            m[...] = values
        else:
            m[rows] = values
        m.flush()

    def iter_chunks(self, chunk_rows, *names):
        """Yield (slice, col_arrays…) over row chunks of the store."""
        for start in range(0, self.nrow, chunk_rows):
            sl = slice(start, min(start + chunk_rows, self.nrow))
            yield (sl,) + tuple(self.read(n, sl) for n in names)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj
