"""Fused RIME entry point.

Port of ``africanus_tpu/rime/fused/core.py`` (reference
``africanus/experimental/rime/fused/core.py``: rime:233, RimeFactory:127,
rime_impl_factory:33; the argument resolution of ``arguments.py:44``).
Where the reference compiles one numba kernel by inlining every term's
sampler into a src/row/chan loop with Kahan summation (core.py:97-118),
here each term samples the whole (source, row, chan) grid as torch ops,
the Jones chain is folded with :func:`term_mul` (right terms
hermitianed), and the source axis is summed with compensation: a
two-float pairwise tree over all sources at once, or a Kahan ``two_sum``
accumulation over source blocks. Both are eager torch ops, so nothing
contracts or reassociates the compensated chains. RimeFactory instances
are cached per specification (the reference's Multiton).

The source block is the caller's, or, where none is given and one grid
of every source would not fit, chosen here: the largest block whose
bytes — the output's accumulators and the block sum, and the block's
chain as the specification's terms declare it (``Term.AXES``, ``KIND``,
``sample_bytes``), linear in the block — fit in the free memory of the
state's device, made even over the blocks. Nothing is evaluated to
probe the memory, and the block, so the sum's last bits, follows the
memory free at the call.

The route is chosen from the specification and the state's devices,
dtypes and shapes before anything is evaluated (:func:`kernel_route`): a
CUDA state at float32 whose terms are the built-in E, L, K, G and B in
the shape ``[Ep, Lp] (Kpq, Gpq, Bpq) [Lq, Eq]`` (any of E and L, G
optional) takes ``csrc/fused_dde.cu`` (:mod:`~africanus_tpu_torch.ops.cuda_fused`):
per source block the operands (the pairs kernel's two-float delays and
envelope coordinates, the brightness, E sampled once for every source
and both sides, L) and one launch that keeps the chain and a Kahan sum
over sources in registers; its block is chosen from that route's own
bytes (:meth:`RimeFactory.kernel_bytes`). Everything else — CPU tensors,
float64, custom terms, other orders — takes the eager chain above.

A call runs in ``utils.profiling`` spans: ``fused.call`` around
``fused.state`` and, per block, ``fused.sample`` and ``fused.sum`` on the
eager chain, or one ``fused.kernel`` on the kernel route; the class's
``calls``, ``blocks``, ``state_seconds`` and ``kernel_evaluations``
count while a profiler records.

The index state (unique times, antennas and feeds, their inverses) is
built on the host from numpy copies of ``time``, ``antenna*`` and
``feed*``; it and every array argument go to the device of the tensor
arguments, or to ``device`` (default ``"cuda"``) when all are numpy.
"""

from __future__ import annotations

import time
from functools import lru_cache

import numpy as np
import torch

from africanus_tpu_torch.model.shape.gaussian_shape import GAUSS_SCALE
from africanus_tpu_torch.ops import cuda_fused
from africanus_tpu_torch.ops._build import MEMORY_SHARE, free_bytes, plan_device
from africanus_tpu_torch.ops.dfloat import compensated_sum, two_sum
from africanus_tpu_torch.rime.fused.specification import RimeSpecification
from africanus_tpu_torch.rime.fused.terms import (
    BeamCubeDDE, Brightness, FeedRotation, Gaussian, Phase, hermitian, term_mul,
)
from africanus_tpu_torch.rime.fused.transformers import TRANSFORMERS, _host
from africanus_tpu_torch.utils.profiling import HostCount, span

__all__ = ["rime", "RimeFactory", "consolidate_args", "kernel_route"]

REQUIRED_ARGS = ("time", "antenna1", "antenna2", "feed1", "feed2")
_NCOMP = {"scalar": 1, "diag": 2, "full": 4}
# a blocked evaluation's bytes beside its blocks' chains, in outputs: the
# two accumulators while a block is sampled; they, the block's sums and
# their stack while it is summed; and the block sum's peak (the
# accumulators, the block's part and two_sum's temporaries)
ACCUMULATORS = 2
SUM_OUTPUTS = 4
SUM_PEAK = 8
# one grid's pairwise tree (``compensated_sum``) of a component, in complex
# (row, chan) grids a source: its temporaries, at most 7 (at three
# sources), and a conjugate's copy
SUM_TREE = 8
# the kernel route's (channel, correlation) complex grids a source: every
# allocation of the brightness and the spectral model (40 (source,
# channel) complex grids, 10 of 4 correlations, in a CPU memory profile)
SPECTRUM_GRIDS = 10
LOG2E = 1.4426950408889634


def consolidate_args(args, kwargs):
    """Merge mappings/datasets into one kwargs dict (reference core.py:215).

    Accepts dicts and objects with a ``data_vars``-like mapping interface.
    """
    out = {}
    for arg in args:
        if hasattr(arg, "data_vars"):
            for k, v in arg.data_vars.items():
                out[str(k).lower()] = getattr(v, "data", v)
        elif isinstance(arg, dict):
            out.update(arg)
        else:
            raise TypeError(f"Unhandled argument type {type(arg)}")
    out.update(kwargs)
    return out


def _state_device(kwargs, device="cuda"):
    """The device of the first tensor among ``kwargs``' values, else
    ``device`` resolved by ``plan_device`` (``"cuda"`` raises without a
    card)."""
    for v in kwargs.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return plan_device(device)


def _lookup(values, uniq):
    """The index of each of ``values`` in the sorted unique ``uniq``."""
    lookup = np.full(int(uniq.max()) + 1, -1, np.int64)
    lookup[uniq] = np.arange(uniq.shape[0])
    return lookup[values]


def kernel_route(spec, device, dtype, beam_corrs=4):
    """The route of an evaluation of ``spec`` on a state on ``device`` whose
    floating arguments are all of the real ``dtype`` (None where they
    differ): the flags of ``csrc/fused_dde.cu``
    (:class:`~africanus_tpu_torch.ops.cuda_fused.Route`) where the kernel
    takes it, else None, the eager chain.

    The kernel takes a CUDA state at float32 whose terms are all of the
    built-in classes (the exact class, not a subclass) in the order
    [left Jones] [scalar middle] [right Jones] over 4 correlations: on the
    left ``BeamCubeDDE``, ``FeedRotation``, both (either first) or none;
    in the middle ``Phase`` and ``Brightness``, with or without
    ``Gaussian``, each once in any order; on the right the left's terms
    in the mirror order. ``beam_corrs`` is the beam's correlations, which
    have to be 2×2. Any number of stations fits: the kernel stages a
    tile's own (``ops/cuda_fused.row_plan``)."""
    if torch.device(device).type != "cuda" or dtype != torch.float32:
        return None
    if len(spec.corrs) != 4:
        return None
    kinds = [type(t) for t in spec.terms]
    where = [t.configuration for t in spec.terms]
    nleft, nright = where.count("left"), where.count("right")
    if where != (["left"] * nleft + ["middle"] * (len(where) - nleft - nright)
                 + ["right"] * nright):
        return None
    left, right = kinds[:nleft], kinds[len(kinds) - nright:]
    middle = kinds[nleft:len(kinds) - nright]
    if (left != right[::-1] or len(set(left)) != nleft
            or not set(left) <= {BeamCubeDDE, FeedRotation}):
        return None
    if len(set(middle)) != len(middle) or set(middle) not in (
            {Phase, Brightness}, {Phase, Gaussian, Brightness}):
        return None
    beam, feed = BeamCubeDDE in left, FeedRotation in left
    if beam and beam_corrs != 4:
        return None
    return cuda_fused.Route(beam=beam, feed=feed, envelope=Gaussian in middle,
                            feed_first=feed and beam and left[0] is FeedRotation)


class RimeFactory:
    """Builds and caches the fused evaluation for one specification."""

    DEFAULT_SPEC = "(Kpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]"
    # summed while a profiler records, over every specification
    calls = HostCount()
    blocks = HostCount()
    state_seconds = HostCount()
    kernel_evaluations = HostCount()

    def __init__(self, rime_spec=None):
        if rime_spec is None:
            rime_spec = RimeSpecification(self.DEFAULT_SPEC)
        elif isinstance(rime_spec, str):
            rime_spec = RimeSpecification(rime_spec)
        self.rime_spec = rime_spec

    def _build_state(self, kwargs, device="cuda"):
        """Pack arguments + index arrays + transformer outputs."""
        with span("fused.state"):
            t0 = time.perf_counter()
            state = self._state(kwargs, device)
            if self.route(state) is not None:
                # the kernel route's block follows the memory free here
                state["free_bytes"] = free_bytes(state["time_inverse"].device)
            self.state_seconds.add(time.perf_counter() - t0)
        return state

    def _state(self, kwargs, device):
        missing = [a for a in REQUIRED_ARGS[:3] if a not in kwargs]
        if missing:
            raise ValueError(f"Missing required argument(s) {missing}")
        dev = _state_device(kwargs, device)

        def on(x):
            if isinstance(x, torch.Tensor):
                return x.to(dev)
            if isinstance(x, np.ndarray):
                return torch.as_tensor(x, device=dev)
            return x

        state = {k: on(v) for k, v in kwargs.items()}

        time = _host(kwargs["time"])
        utime, time_inv = np.unique(time, return_inverse=True)
        state["utime"] = on(utime)
        state["time_inverse"] = on(time_inv.astype(np.int64))

        ants = {name: _host(kwargs[name]) for name in ("antenna1", "antenna2")}
        uant = np.unique(np.concatenate(list(ants.values())))
        state["uantenna"] = on(uant)
        # the host's copies of the row indices, for the kernel route's
        # row plan and stations
        host = {"time_inverse": time_inv}
        for name, ant in ants.items():
            host[f"{name}_inverse"] = _lookup(ant, uant)
            state[f"{name}_inverse"] = on(host[f"{name}_inverse"])

        # one shared feed table over BOTH columns (like antennas): a
        # per-column unique would leave ufeed holding only feed2's set
        # while feed1_inverse indexed feed1's own — inconsistent tables
        feeds = {
            name: (_host(kwargs[name]) if name in kwargs
                   else np.zeros(time.shape, np.int64))
            for name in ("feed1", "feed2")
        }
        ufeed = np.unique(np.concatenate(list(feeds.values())))
        state["ufeed"] = on(ufeed)
        for name, feed in feeds.items():
            host[f"{name}_inverse"] = _lookup(feed, ufeed)
            state[f"{name}_inverse"] = on(host[f"{name}_inverse"])
        state["host_index"] = host

        # antenna_position may drive the parallactic transformer: the beam/
        # feed tables are indexed by the *inverse* antenna index, so subset
        if "antenna_position" in state:
            state["antenna_position"] = on(_host(kwargs["antenna_position"])[uant])

        # run transformers to create missing term inputs
        needed = set()
        for term in self.rime_spec.terms:
            needed.update(term.ARGS)
            # optional inputs trigger transformers too: BeamCubeDDE's
            # beam_parangle & co live in KWARGS
            needed.update(getattr(term, "KWARGS", ()))
        for tf in TRANSFORMERS:
            produces = set(tf.OUTPUTS)
            if produces & needed and not produces.issubset(state):
                if tf.can_create(state):
                    state.update(tf.transform(state))
        return state

    def _sample_chain(self, state):
        """Sample every term against ``state`` and fold the Jones chain."""
        chain = None
        for term in self.rime_spec.terms:
            val = term.sample(state)
            if term.configuration == "right":
                val = hermitian(val)
            chain = val if chain is None else term_mul(chain, val)

        ncorr = len(self.rime_spec.corrs)
        if chain.ncorr != ncorr:
            raise ValueError(
                f"Chain produced {chain.ncorr} correlations but the "
                f"specification wants {ncorr}"
            )
        return chain

    def _source_keys(self, state):
        """State keys carrying a leading source axis, and the source count.

        Terms declare their source-indexed arguments via ``SOURCE_ARGS``;
        terms that leave it None fall back to matching each argument's
        leading dimension against the source count (inferred from the
        first declared key, or lm/radec/stokes).
        """
        declared = set()
        undeclared_terms = []
        for term in self.rime_spec.terms:
            sa = getattr(term, "SOURCE_ARGS", None)
            if sa is None:
                undeclared_terms.append(term)
            else:
                declared.update(a for a in sa if state.get(a) is not None)

        nsrc = None
        for k in (*sorted(declared), "lm", "radec", "stokes"):
            v = state.get(k)
            if v is not None and getattr(v, "ndim", 0) >= 1:
                nsrc = v.shape[0]
                break
        if nsrc is None:
            return set(), None

        for term in undeclared_terms:
            for a in (*term.ARGS, *term.KWARGS):
                v = state.get(a)
                if (
                    v is not None
                    and getattr(v, "ndim", 0) >= 1
                    and v.shape[0] == nsrc
                ):
                    declared.add(a)
        return declared, nsrc

    def _lines(self, state, one_grid=False):
        """Lines (bytes, bytes a source) whose largest at a block's source
        count bounds the bytes an evaluation of ``state`` takes beyond the
        state, in blocks or (``one_grid``) in one grid of every source:
        while the chain is sampled and folded (what the terms' sampling
        shares, and a source's largest step: each term sampled beside the
        chain so far and the previous term's value, each product beside
        both factors, a full × full product holding two more grids), while
        it is summed (the chain beside its masked product, or beside the
        pairwise tree's ``SUM_TREE`` grids), and in blocks the block sum's
        peak. Each byte count is linear in the sources: nothing is
        evaluated."""
        nrow = state["time_inverse"].shape[0]
        nchan = state["chan_freq"].shape[0]
        real = state["chan_freq"].dtype
        if "uvw" in state:
            real = torch.promote_types(real, state["uvw"].dtype)
        itemsize = 2 * torch.finfo(real).bits // 8
        ncorr = len(self.rime_spec.corrs)
        out = nrow * nchan * ncorr * itemsize

        def grid(axes):
            return itemsize * (nrow if "r" in axes else 1) * (
                nchan if "f" in axes else 1) if "s" in axes else 0

        shared = fold = chain = prev = n = 0
        axes = ""
        for term in self.rime_spec.terms:
            common, sampling = term.sample_bytes(state, nrow, nchan, itemsize)
            shared += common
            tn = _NCOMP.get(term.KIND, ncorr)
            val = tn * grid(term.AXES)
            fold = max(fold, chain + prev + val + sampling)
            if n:
                axes = "".join(sorted(set(axes) | set(term.AXES)))
                temps = 2 if n == tn == 4 else 0
                fold = max(fold, chain + val + (max(n, tn) + temps) * grid(axes))
                chain, n, prev = max(n, tn) * grid(axes), max(n, tn), val
            else:
                chain, n, axes = val, tn, term.AXES
        if one_grid:
            return [(shared, fold), (2 * out, chain + SUM_TREE * grid("srf"))]
        return [(ACCUMULATORS * out + shared, fold),
                (SUM_OUTPUTS * out, chain + grid("srf")), (SUM_PEAK * out, 0)]

    def evaluation_bytes(self, state, block=None):
        """Bytes an evaluation of ``state`` takes at most beyond the state,
        in blocks of ``block`` sources or in one grid (None): the largest
        of :meth:`_lines` at that many sources."""
        if block is None:
            block = self._source_keys(state)[1] or 1
            return max(f + block * p for f, p in self._lines(state, True))
        return max(f + block * p for f, p in self._lines(state))

    def source_block(self, state, memory_budget):
        """The source block for ``state`` within ``memory_budget`` bytes:
        the largest at which every one of :meth:`_lines` fits, made even
        over the blocks it needs, at least 1; None where no argument is
        indexed by source."""
        _, nsrc = self._source_keys(state)
        if nsrc is None:
            return None
        fit = min([nsrc] + [int((memory_budget - f) // p)
                            for f, p in self._lines(state) if p])
        fit = max(fit, 1)
        return -(-nsrc // -(-nsrc // fit))

    def _block(self, state):
        """The block to evaluate ``state`` in where the caller gives none:
        None (one grid) where every source's grid fits ``MEMORY_SHARE`` of
        the device's free memory, else :meth:`source_block` within it."""
        if self._source_keys(state)[1] is None:
            return None
        budget = MEMORY_SHARE * free_bytes(state["time_inverse"].device)
        if self.evaluation_bytes(state) <= budget:
            return None
        return self.source_block(state, budget)

    def route(self, state):
        """:func:`kernel_route` of this specification on ``state``: read
        from the state's devices, dtypes and shapes alone."""
        names = {a for t in self.rime_spec.terms for a in (*t.ARGS, *t.KWARGS)}
        reals = {(v.real if v.is_complex() else v).dtype for v in
                 (state.get(a) for a in names)
                 if isinstance(v, torch.Tensor) and (v.is_floating_point()
                                                     or v.is_complex())}
        corrs = 4
        if any(type(t) is BeamCubeDDE for t in self.rime_spec.terms):
            corrs = int(np.prod(state["beam"].shape[3:]))
        return kernel_route(self.rime_spec, state["time_inverse"].device,
                            reals.pop() if len(reals) == 1 else None, corrs)

    def _kernel_lines(self, state, route):
        """(bytes, bytes a source) of the kernel route's evaluation beyond
        the state, counted from what it allocates on the card: shared,
        the output, the row plan, the frequencies, L, and the beam term's
        copy of the cube; a source, its (hi, lo, u1, v1) pairs, its
        brightness and the spectral model's temporaries, and the beam
        term's own (E's table and the kernels' raw sums). The compensation
        buffer is :meth:`kernel_bytes`' where there are several blocks."""
        nrow = state["time_inverse"].shape[0]
        nchan = state["chan_freq"].shape[0]
        shared = nrow * nchan * 4 * 8 + 16 * nrow + 16 * nchan
        per = 16 * nrow + 8 * SPECTRUM_GRIDS * 4 * nchan
        if route.feed:
            shared += 2 * state["feed_parangle"].numel() * 8
        if route.beam:
            term = next(t for t in self.rime_spec.terms if type(t) is BeamCubeDDE)
            cube, source = term.sample_bytes(state, nrow, nchan, 8)
            shared, per = shared + cube, per + source
        return shared, per

    def kernel_bytes(self, state, block, route=None):
        """Bytes an evaluation of ``state`` on the kernel route takes at
        most beyond the state, in blocks of ``block`` sources: with the
        compensation buffer where there are several."""
        shared, per = self._kernel_lines(state, route or self.route(state))
        nsrc = self._source_keys(state)[1]
        if block < nsrc:
            shared += state["time_inverse"].shape[0] * state["chan_freq"].shape[0] * 32
        return shared + block * per

    def _kernel_block(self, state, route, memory_budget):
        """The kernel route's source block within ``memory_budget`` bytes:
        every source where they fit, else the largest block that does with
        the compensation buffer, made even over the blocks, at least 1."""
        nsrc = self._source_keys(state)[1]
        if self.kernel_bytes(state, nsrc, route) <= memory_budget:
            return nsrc
        shared = self.kernel_bytes(state, 0, route)
        per = self.kernel_bytes(state, 1, route) - shared
        fit = max(min(nsrc, int((memory_budget - shared) // per)), 1)
        return -(-nsrc // -(-nsrc // fit))

    def _kernel_index(self, state, route):
        """:func:`~africanus_tpu_torch.ops.cuda_fused.row_plan` of the
        state's rows and their stations (feed·A + antenna with a feed
        rotation, else the antenna; none without Jones), made on the host
        and moved in one copy: (order, tiles, stations, local) as int32
        tensors on the state's device."""
        host = state["host_index"]
        nant = state["uantenna"].shape[0]
        sides = [None, None]
        if route.beam or route.feed:
            for i, (ant, feed) in enumerate((("antenna1", "feed1"), ("antenna2", "feed2"))):
                sides[i] = host[f"{ant}_inverse"]
                if route.feed:
                    sides[i] = host[f"{feed}_inverse"] * nant + sides[i]
        plan = cuda_fused.row_plan(host["time_inverse"], *sides)
        packed = torch.as_tensor(np.concatenate([x.ravel() for x in plan]),
                                 device=state["time_inverse"].device)
        parts, at = [], 0
        for x in plan:
            parts.append(packed[at:at + x.size].reshape(x.shape))
            at += x.size
        return tuple(parts)

    def kernel_operands(self, state, route=None, index=None):
        """The operands of :func:`~africanus_tpu_torch.ops.cuda_fused.fused_dde`
        for every source of ``state``: the two-float delays and envelope
        coordinates, the brightness, E sampled once for every source, L.
        ``index`` is :meth:`_kernel_index`'s, made here where None."""
        route = route or self.route(state)
        order, tiles, stations, local = index or self._kernel_index(state, route)
        terms = {type(t): t for t in self.rime_spec.terms}
        freq = state["chan_freq"].contiguous()
        shape = gscale = None
        if route.envelope:
            shape = state["gauss_shape"]
            sf = freq * GAUSS_SCALE
            gscale = (-LOG2E) * (sf * sf)
        pairs = cuda_fused.fused_pairs(state["lm"], state["uvw"], shape,
                                       state.get("convention", "fourier"))
        bright = torch.stack([c[:, 0] for c in terms[Brightness].sample(state).comps],
                             dim=-1)
        beam = feed = None
        if route.beam:
            beam = terms[BeamCubeDDE].table(state)
            beam = beam.reshape(beam.shape[:4] + (4,))
        if route.feed:
            feed = terms[FeedRotation].table(state).contiguous()
        return cuda_fused.Operands(pairs, bright, beam, feed, order, tiles, stations, local,
                                   freq, gscale, route.feed_first)

    def _evaluate_kernel(self, state, route, source_block):
        """The kernel route: per source block its operands and one launch
        of the kernel, the sum and its compensation carried from block to
        block in device memory."""
        src_keys, nsrc = self._source_keys(state)
        block = (self._kernel_block(state, route, MEMORY_SHARE * state["free_bytes"])
                 if source_block is None else max(min(int(source_block), nsrc), 1))
        nblocks = max(-(-nsrc // block), 1)
        self.calls.add(1)
        self.kernel_evaluations.add(1)
        with span("fused.kernel"):
            index = self._kernel_index(state, route)
            nrow = state["time_inverse"].shape[0]
            nchan = state["chan_freq"].shape[0]
            out = torch.empty((nrow, nchan, 4), dtype=torch.complex64,
                              device=state["time_inverse"].device)
            comp = torch.empty_like(out) if nblocks > 1 else None
            for b in range(nblocks):
                bstate = dict(state)
                bstate.update({k: state[k][b * block:(b + 1) * block] for k in src_keys})
                ops = self.kernel_operands(bstate, route, index)
                cuda_fused.fused_dde(ops, out, comp, first=b == 0, last=b == nblocks - 1)
                del ops
                self.blocks.add(1)
        return out

    def __call__(self, source_block=None, device="cuda", **kwargs):
        """Evaluate the RIME: a (row, chan, corr) complex tensor.

        ``source_block`` bounds the source dimension materialised at once
        (see :meth:`evaluate`); ``device`` takes numpy arguments (see
        :meth:`build_state`)."""
        with span("fused.call"):
            state = self._build_state(kwargs, device)
            return self.evaluate(state, source_block=source_block)

    def build_state(self, device="cuda", **kwargs):
        """Public host-side state construction (index arrays, inverse
        lookups, transformer outputs) — everything :meth:`evaluate` needs,
        on the device of the tensor arguments, or on ``device`` when all
        are numpy. ``time``/``antenna*``/``feed*`` are read on the host."""
        return self._build_state(kwargs, device)

    def evaluate(self, state, source_block=None):
        """Evaluate the RIME against a prebuilt state.

        ``source_block`` bounds the source dimension materialised at once:
        the (block, row, chan) grids are evaluated one block at a time and
        Kahan-accumulated (``two_sum``) into the output, so memory is
        O(block·row·chan) instead of O(source·row·chan) — the reference's
        LinearReduction (dask_predict.py:64-254) with the Kahan sum of
        its fused kernel (fused/core.py:97-118). None evaluates all
        sources in one grid, summed by a two-float pairwise tree
        (``compensated_sum``), so that blocked and one-grid evaluation
        agree to ulps — unless that grid would not fit the device's free
        memory: then in the block :meth:`source_block` chooses.
        """
        for term in self.rime_spec.terms:
            term.validate(state)
        route = self.route(state)
        if route is not None:
            return self._evaluate_kernel(state, route, source_block)

        nrow = state["time_inverse"].shape[0]
        nchan = state["chan_freq"].shape[0]
        if source_block is None:
            source_block = self._block(state)
        self.calls.add(1)

        if source_block is None:
            with span("fused.sample"):
                chain = self._sample_chain(state)
            self.blocks.add(1)
            with span("fused.sum"):
                outs = []
                for comp in chain.comps:
                    full = comp.resolve_conj().expand(comp.shape[0], nrow, nchan)
                    outs.append(torch.view_as_complex(
                        compensated_sum(torch.view_as_real(full), axis=0)))
                return torch.stack(outs, dim=-1)

        src_keys, nsrc = self._source_keys(state)
        if nsrc is None:
            raise ValueError(
                "source_block given but no source-indexed argument "
                "was found to block over"
            )
        block = min(int(source_block), int(nsrc))
        nblocks = -(-nsrc // block)
        spad = nblocks * block

        def pad(v):
            if spad == nsrc:
                return v
            return torch.cat([v, v.new_zeros((spad - nsrc,) + v.shape[1:])])

        padded = {k: pad(state[k]) for k in src_keys}
        # padded tail sources are masked out of every block's partial sum
        # (zero-padding alone is wrong for e.g. a bare K chain, where a
        # zeroed lm still contributes e^{i0} = 1)
        valid = torch.arange(spad, device=state["time_inverse"].device) < nsrc

        acc = comp_err = None
        for b in range(nblocks):
            rows = slice(b * block, (b + 1) * block)
            bstate = dict(state)
            bstate.update({k: v[rows] for k, v in padded.items()})
            with span("fused.sample"):
                chain = self._sample_chain(bstate)
            self.blocks.add(1)
            with span("fused.sum"):
                real = chain.comps[0].real.dtype
                mask = valid[rows].to(real)[:, None, None]
                part = torch.view_as_real(torch.stack([
                    (c.expand(block, nrow, nchan) * mask).sum(dim=0)
                    for c in chain.comps], dim=-1))
                del chain
                if acc is None:
                    acc, comp_err = part, torch.zeros_like(part)
                else:
                    acc, err = two_sum(acc, part)
                    comp_err = comp_err + err
                    del err
                del part
        return torch.view_as_complex(acc + comp_err)


@lru_cache(maxsize=16)
def _cached_factory(spec_str):
    return RimeFactory(spec_str)


def rime(spec, *args, **kwargs):
    """Evaluate a RIME specification against argument mappings/kwargs
    (reference core.py:233). Returns a (row, chan, corr) complex tensor;
    ``source_block`` and ``device`` pass to :class:`RimeFactory`."""
    if isinstance(spec, RimeSpecification):
        factory = RimeFactory(spec)
    else:
        factory = _cached_factory(str(spec))
    merged = consolidate_args(args, kwargs)
    return factory(**merged)
