"""The port's fused RIME (rime/fused/: specification, terms, transformers,
core) against the JAX package on the CPU.

Every chain runs through both packages on the same seeded inputs: in
float64 they agree to 1e-12 of max (the terms' arithmetic is the same up
to rounding order), in float32 to 1e-6 of max (two-float phases on both
sides; cos/sin and the source sums round differently). The E term
reaches the JAX package's plain (XLA) beam route and the port's plain
versions of ``beam_interp`` and ``beam_blend``.
"""

import numpy as np
import pytest
import torch

from africanus_tpu.ops.cplx import to_numpy
from africanus_tpu.rime.fused import rime as jax_rime
from africanus_tpu.rime.fused import RimeSpecification as JaxSpec
from africanus_tpu_torch.ops import cuda_beam
from africanus_tpu_torch.rime.fused import (
    RimeFactory, RimeParseError, RimeSpecification, RimeSpecificationError,
    Term, TermValue, rime,
)
from africanus_tpu_torch.rime.fused.inputs import (
    from_numpy, fused_inputs, fused_oracle_f64,
)

F64, F32 = 1e-12, 1e-6
KB = "(Kpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]"
KGB = "(Kpq, Gpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]"


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture
def obs(rng, wsrt_ants):
    """tests/test_fused_rime.py's observation."""
    nsrc, ntime, nchan = 5, 3, 4
    nant = wsrt_ants.shape[0]
    a1, a2 = np.triu_indices(nant, 1)
    time = np.repeat(5.03e9 + np.arange(ntime) * 8.0, a1.size)
    nrow = time.shape[0]
    return dict(
        time=time,
        antenna1=np.tile(a1, ntime),
        antenna2=np.tile(a2, ntime),
        feed1=np.zeros(nrow, np.int32),
        feed2=np.zeros(nrow, np.int32),
        radec=rng.uniform(-0.01, 0.01, (nsrc, 2)) + np.array([0.2, -0.6]),
        phase_dir=np.array([0.2, -0.6]),
        uvw=rng.uniform(-1000, 1000, (nrow, 3)),
        chan_freq=np.linspace(0.856e9, 1.712e9, nchan),
        stokes=rng.uniform(0.5, 2.0, (nsrc, 4)),
        spi=rng.normal(scale=0.2, size=(nsrc, 2, 4)),
        ref_freq=np.full(nsrc, 1.2e9),
        gauss_shape=np.abs(rng.normal(size=(nsrc, 3))) * 1e-4,
        antenna_position=wsrt_ants,
    )


def _both(spec, obs, tol=F64, terms=None, **kw):
    port_spec = spec if terms is None else RimeSpecification(spec, terms=terms)
    jspec = spec if terms is None else JaxSpec(spec, terms=terms)
    got = rime(port_spec, obs, device="cpu", **kw)
    want = to_numpy(jax_rime(jspec, obs, **kw))
    assert isinstance(got, torch.Tensor) and got.is_complex()
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= tol
    return got


@pytest.mark.parametrize("spec,stokes", [
    (KB, [0, 1, 2, 3]), (KGB, [0, 1, 2, 3]),
    ("(Kpq, Bpq): [I,Q] -> [XX,YY]", [0, 1]),
    ("(Kpq, Bpq): [I,Q,U,V] -> [RR,RL,LR,LL]", [0, 1, 2, 3]),
    ("(Kpq, Bpq): [I,V] -> [RR,LL]", [0, 3]),
    ("(Kpq, Gpq, Bpq): [I,Q] -> [XX]", [0, 1]),
])
def test_port_chains_equal_jax(obs, spec, stokes):
    """Scalar, diagonal and full chains, linear and circular."""
    _both(spec, dict(obs, stokes=obs["stokes"][:, stokes],
                     spi=obs["spi"][..., stokes]))


@pytest.mark.parametrize("corrs", ["[XX,XY,YX,YY]", "[RR,RL,LR,LL]"])
def test_port_feed_rotation_equals_jax(obs, corrs):
    """L with linear and circular feeds: the parallactic transformer on
    the host, the sandwich L1 · V · L2ᴴ."""
    _both(f"[Lp, (Kpq, Bpq), Lq]: [I,Q,U,V] -> {corrs}", obs)


def test_port_feed_rotation_with_receptor_angles(obs):
    nant = obs["antenna_position"].shape[0]
    ra = np.random.default_rng(2).uniform(-0.3, 0.3, (nant, 2))
    _both("[Lp, (Kpq, Gpq, Bpq), Lq]: [I,Q,U,V] -> [XX,XY,YX,YY]",
          dict(obs, receptor_angle=ra))


@pytest.mark.parametrize("base", ["standard", "log", "log10"])
def test_port_spectral_bases_equal_jax(obs, base):
    _both(KB, obs, spi_base=base)


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_port_phase_conventions_equal_jax(obs, convention):
    _both(KGB, obs, convention=convention)


@pytest.mark.parametrize("block", [1, 2, 3, 5, 100])
def test_port_source_block_invariance(obs, block):
    """Blocked (Kahan two_sum over blocks, the padded tail masked) and
    one-grid (two-float tree) evaluation agree, and each equals the JAX
    package's."""
    full = rime(KGB, obs, device="cpu")
    blocked = _both(KGB, obs, source_block=block)
    assert _rel(blocked.numpy(), full.numpy()) <= F64


def test_port_source_block_float32(obs):
    """Float32 inputs: blocked and one-grid agree to f32 ulps of the
    result, and both track the JAX package's float32 chain."""
    o32 = {k: (v.astype(np.float32) if isinstance(v, np.ndarray)
               and v.dtype == np.float64 and k != "time" else v)
           for k, v in obs.items()}
    full = _both(KGB, o32, tol=F32)
    assert full.dtype == torch.complex64
    blocked = _both(KGB, o32, tol=F32, source_block=2)
    assert _rel(blocked.numpy(), full.numpy()) <= 4e-7


def test_port_custom_term_by_name(obs):
    """terms={"C": "Gaussian"} resolves a string to a Term class and
    gives the KGB chain."""
    got = _both("(Cpq, Kpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]", obs,
                terms={"C": "Gaussian"})
    want = rime(KGB, obs, device="cpu")
    assert _rel(got.numpy(), want.numpy()) <= F64


def test_port_custom_term_source_heuristic(obs):
    """A custom term without SOURCE_ARGS still blocks correctly via the
    leading-dimension heuristic."""
    class Flux(Term):
        ARGS = ("model_flux",)

        def sample(self, state):
            f = state["model_flux"][:, None, :]  # (src, 1, chan)
            c = torch.complex(f, torch.zeros_like(f))
            return TermValue("diag", (c, c))

    nsrc, nchan = obs["radec"].shape[0], obs["chan_freq"].shape[0]
    ds = dict(obs, model_flux=np.random.default_rng(3).uniform(0.5, 1.5, (nsrc, nchan)))
    spec = RimeSpecification("(Kpq, Fpq): [I,Q] -> [XX,YY]", terms={"F": Flux})
    full = rime(spec, ds, device="cpu")
    blocked = rime(spec, ds, device="cpu", source_block=2)
    assert _rel(blocked.numpy(), full.numpy()) <= F64


def test_port_spec_parsing_and_errors():
    spec = RimeSpecification(KB)
    want = JaxSpec(KB)
    assert spec.equation == want.equation == ["Kpq", "Bpq"]
    assert spec.stokes == want.stokes and spec.corrs == want.corrs
    assert spec.feed_type == "linear" and hash(spec) == hash(RimeSpecification(KB))
    assert [type(t).__name__ for t in spec.terms] == ["Phase", "Brightness"]
    assert set(RimeSpecification.TERM_MAP) == set("KBLEG")
    assert RimeSpecification("(Kpq, Bpq): [I,V] -> [RR,LL]").feed_type == "circular"
    for bad, err in (("no colon here", RimeParseError),
                     ("(Kpq): [I] - [XX]", RimeParseError),
                     ("(Kpq): I -> [XX]", RimeParseError),
                     ("(Zpq, Bpq): [I] -> [XX]", RimeSpecificationError),
                     ("(Kpq, Bpq): [I,W] -> [XX]", RimeSpecificationError),
                     ("(Kpq, Bpq): [I] -> [XX,RR]", RimeSpecificationError)):
        with pytest.raises(err):
            RimeSpecification(bad)
    with pytest.raises(RimeSpecificationError, match="Can't find a type"):
        RimeSpecification("(Cpq, Kpq, Bpq): [I] -> [XX]", terms={"C": "NoSuchTerm"})
    with pytest.raises(ValueError, match="'left' or 'right'"):
        RimeSpecification("(Kpq, Lpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]")
    with pytest.raises(ValueError, match="requires argument"):
        rime(KB, dict(time=np.zeros(1), antenna1=np.zeros(1, int),
                      antenna2=np.ones(1, int)), device="cpu")


def test_port_factory_cached():
    from africanus_tpu_torch.rime.fused.core import _cached_factory

    assert _cached_factory(KB) is _cached_factory(KB)


def test_port_ufeed_shared_over_both_columns(obs):
    nrow = obs["time"].shape[0]
    obs = dict(obs, feed1=np.ones(nrow, np.int32), feed2=np.zeros(nrow, np.int32))
    state = RimeFactory(KB).build_state(device="cpu", **obs)
    ufeed = state["ufeed"].numpy()
    f1, f2 = state["feed1_inverse"].numpy(), state["feed2_inverse"].numpy()
    assert list(ufeed) == [0, 1]
    assert (ufeed[f1] == 1).all() and (ufeed[f2] == 0).all()


def test_port_state_on_the_tensors_device(obs, monkeypatch):
    """numpy arguments go to ``device`` ("cuda" by default, raising
    without a card); tensor arguments keep theirs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rime(KB, obs)
    tobs = dict(obs, uvw=torch.as_tensor(obs["uvw"]))
    assert rime(KB, tobs).device.type == "cpu"


def _cube(seed, nchan, dtype):
    """A smooth 10 x 10 x 6 2x2 complex beam spanning the band."""
    rng = np.random.default_rng(seed)
    ll, mm = np.meshgrid(np.linspace(-1, 1, 10), np.linspace(-1, 1, 10),
                         indexing="ij")
    amp = np.cos(np.minimum(np.hypot(ll, mm), 1.0))[:, :, None, None]
    ph = rng.uniform(-0.3, 0.3, (1, 1, 6, 4))
    beam = (amp * np.exp(1j * (ph + 0.2 * ll[..., None, None]))).reshape(10, 10, 6, 2, 2)
    return dict(beam=beam.astype(dtype), beam_lm_extents=np.array([[-0.02, 0.02],
                                                                  [-0.02, 0.02]]),
                beam_freq_map=np.linspace(0.8e9, 1.8e9, 6))


@pytest.mark.parametrize("parangle", ["given", "transformer", "zero"])
def test_port_beam_term_small_cube(obs, parangle):
    """[Ep, (Kpq, Bpq), Eq] at a small cube in float64: the port's beam
    term (the plain versions of beam_interp and beam_blend, chan-invariant
    route, twice per evaluation) against the JAX package's; the beam
    parallactic angles given, from the transformer, or absent (zero)."""
    obs = dict(obs, lm=obs["radec"] - obs["phase_dir"], **_cube(4, 4, complex))
    if parangle == "given":
        obs["beam_parangle"] = np.random.default_rng(5).uniform(-np.pi, np.pi, (3, 14))
    elif parangle == "zero":
        del obs["antenna_position"]
    before = (cuda_beam.beam_interp.launches, cuda_beam.beam_blend.launches)
    got = _both("[Ep, (Kpq, Bpq), Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]", obs)
    # CPU tensors take the plain versions: nothing is launched
    assert (cuda_beam.beam_interp.launches, cuda_beam.beam_blend.launches) == before
    assert bool(torch.isfinite(torch.view_as_real(got)).all())


def test_port_beam_term_blocked_and_float32(obs):
    """The E chain in source blocks equals the one-grid chain; in float32
    (complex64 beam) it tracks the JAX package's one-grid float32 chain to
    1e-5 of max (the interpolation's f32 roundings, as
    tests/test_torch_beam.py) and its own blocked chain to 1e-6."""
    o = dict(obs, lm=obs["radec"] - obs["phase_dir"], **_cube(6, 4, complex))
    spec = "[Ep, (Kpq, Gpq, Bpq), Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]"
    full = rime(spec, o, device="cpu")
    blocked = _both(spec, o, source_block=2)
    assert _rel(blocked.numpy(), full.numpy()) <= F64
    o32 = {k: (v.astype(np.complex64) if np.iscomplexobj(v) else
               v.astype(np.float32) if isinstance(v, np.ndarray)
               and v.dtype == np.float64 and k not in ("time", "antenna_position",
                                                       "phase_dir", "radec") else v)
           for k, v in o.items()}
    full32 = _both(spec, o32, tol=1e-5)
    blocked32 = rime(spec, o32, device="cpu", source_block=3)
    assert _rel(blocked32.numpy(), full32.numpy()) <= F32


def test_port_fused_inputs_kgb_against_f64_oracle():
    """The fused cell's draws at a small size: KGB on the CPU against
    the float64 oracle, at the flagship's float32 bar (5e-6 of max)."""
    args = fused_inputs(nsrc=6, ntime=2, nant=5, nchan=32, seed=7)
    got = rime(KGB, **from_numpy(args, "cpu"), source_block=4).numpy()
    want = fused_oracle_f64(args, slice(None), slice(None))
    assert _rel(got, want) <= 5e-6
