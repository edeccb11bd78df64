"""The port's log marginal likelihood (temporalgps_torch) against the
reference package, end to end, on the CPU.

Inputs come from numpy and go through both packages. The reference runs its
plain engines only: engine="sequential" and engine="block" with pallas=False
(never interpret-mode Pallas). Tolerances: rtol 1e-10 in float64; 1e-5 in
float32, where the two packages pad and accumulate in different orders.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import temporalgps_tpu.gp as jgp
from temporalgps_tpu import RegularSpacing as JRegularSpacing
from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.models import lgssm as jlgssm

import temporalgps_torch as tt
from temporalgps_torch import convert
from temporalgps_torch.gp import GP, ArrayStorage, Matern12, Matern32, Matern52, to_sde
from temporalgps_torch.gp.lti_sde import build_lgssm
from temporalgps_torch.models import lgssm as tlgssm

torch.set_num_threads(1)

N, NAN_AT = 37, 11  # not a multiple of any block count used here
S2, SC, NOISE = 1.3, 0.7, 0.2
TORCH_KERNEL = {"Matern12": Matern12, "Matern32": Matern32, "Matern52": Matern52}
JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _y(seed, dtype=np.float64):
    y = np.random.default_rng(seed).standard_normal(N).astype(dtype)
    y[NAN_AT] = np.nan
    return y


def _jax_fx(name, dtype, x=None):
    kern = (S2 * getattr(jgp, name)()).stretch(SC)
    x = JRegularSpacing(0.0, 0.1, N) if x is None else x
    return jgp.to_sde(jgp.GP(kern), jgp.ArrayStorage(JAX_DTYPE[dtype]))(x, NOISE)


def _torch_fx(name, dtype, x=None):
    kern = (S2 * TORCH_KERNEL[name]()).stretch(SC)
    x = tt.RegularSpacing(0.0, 0.1, N) if x is None else x
    return to_sde(GP(kern), ArrayStorage(dtype), device="cpu")(x, NOISE)


def _jax_lml(fx, y, **engine):
    return float(jax.jit(lambda yy: japi.logpdf(fx, yy, **engine))(jnp.asarray(y)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["Matern12", "Matern32", "Matern52"])
def test_block_logpdf_matches_reference(name, dtype):
    y = _y(seed=len(name) + dtype.itemsize, dtype=np.float32 if dtype == torch.float32 else np.float64)
    fx_j = _jax_fx(name, dtype)
    ref_block = _jax_lml(fx_j, y, engine="block", pallas=False, n_blocks=4)
    ref_seq = _jax_lml(fx_j, y, engine="sequential")
    fx_t = _torch_fx(name, dtype)
    for fused in (None, True):
        lml = tt.logpdf(fx_t, y, engine="block", fused=fused)
        assert lml.dtype == dtype and lml.shape == ()
        np.testing.assert_allclose(lml.item(), ref_block, rtol=TOL[dtype])
        np.testing.assert_allclose(lml.item(), ref_seq, rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sequential_logpdf_matches_reference(dtype):
    y = _y(seed=5, dtype=np.float32 if dtype == torch.float32 else np.float64)
    ref = _jax_lml(_jax_fx("Matern52", dtype), y, engine="sequential")
    lml = tt.logpdf(_torch_fx("Matern52", dtype), y, engine="sequential")
    np.testing.assert_allclose(lml.item(), ref, rtol=TOL[dtype])


@pytest.mark.parametrize("n_blocks", [1, 3, 8, N])
def test_block_count_does_not_change_the_lml(n_blocks):
    y = _y(seed=6)
    fx = _torch_fx("Matern32", torch.float64)
    ref = tt.logpdf(fx, y, engine="sequential").item()
    lml = tt.logpdf(fx, y, engine="block", n_blocks=n_blocks, fused=True).item()
    np.testing.assert_allclose(lml, ref, rtol=1e-10)


def test_irregular_times_run_sequential_and_block_refuses():
    times = np.sort(np.random.default_rng(7).uniform(0.0, 4.0, N))
    y = _y(seed=8)
    ref = _jax_lml(_jax_fx("Matern32", torch.float64, x=jnp.asarray(times)), y,
                   engine="sequential")
    fx = _torch_fx("Matern32", torch.float64, x=torch.from_numpy(times))
    np.testing.assert_allclose(tt.logpdf(fx, y).item(), ref, rtol=1e-10)
    # The general block schedule takes per-step transitions: the lane path
    # and the streamed kernels' plain versions.
    for fused in (False, True):
        np.testing.assert_allclose(tt.logpdf(fx, y, engine="block", fused=fused).item(), ref,
                                   rtol=1e-10)


def test_engine_resolution_on_cpu_is_sequential():
    model = build_lgssm(_torch_fx("Matern52", torch.float64))
    assert tlgssm._resolve_engine(None, model) == "sequential"
    assert tlgssm._resolve_engine("block", model) == "block"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlgssm.logpdf(model, torch.zeros(N, dtype=torch.float64), engine="steady")


def _spec(k):
    """The reference kernel as convert.kernel_from_spec's nested spec."""
    name = type(k).__name__
    if name == "Scaled":
        return ("Scaled", _spec(k.kernel), np.asarray(k.sigma2))
    if name == "Stretched":
        return ("Stretched", _spec(k.kernel), np.asarray(k.s))
    return (name,)


def test_lgssm_from_numpy_gives_the_reference_lml():
    y = _y(seed=9)
    fx_j = _jax_fx("Matern52", torch.float64)
    model_j = japi.build_lgssm(fx_j)
    ref = float(jax.jit(lambda yy: jlgssm.logpdf(model_j, yy, engine="sequential"))(
        jnp.asarray(np.nan_to_num(y))))
    t, e = model_j.trans, model_j.emis
    s = np.full(N, float(e.s.value))
    model_t = convert.lgssm_from_numpy(
        np.asarray(t.As.value), np.asarray(t.offs.value), np.asarray(t.Qs.value),
        np.asarray(e.H.value), np.asarray(e.h.value), s,
        np.asarray(t.x0.mean), np.asarray(t.x0.cov), N, dtype=torch.float64, device="cpu",
    )
    y0 = torch.from_numpy(np.nan_to_num(y))
    for engine in ("sequential", "block"):
        np.testing.assert_allclose(
            tlgssm.logpdf(model_t, y0, engine=engine).item(), ref, rtol=1e-10)


def test_kernel_from_spec_rebuilds_the_reference_model():
    fx_j = _jax_fx("Matern52", torch.float64)
    kern = convert.kernel_from_spec(_spec(fx_j.f.f.kernel))
    model_t = build_lgssm(to_sde(GP(kern), device="cpu")(tt.RegularSpacing(0.0, 0.1, N), NOISE))
    model_j = japi.build_lgssm(fx_j)
    pairs = [
        (model_t.trans.As.value, model_j.trans.As.value),
        (model_t.trans.Qs.value, model_j.trans.Qs.value),
        (model_t.emis.H.value, model_j.emis.H.value),
        (model_t.trans.x0.cov, model_j.trans.x0.cov),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", ["Matern12", "Matern32", "Matern52"])
def test_sde_atoms_match_reference(name):
    from temporalgps_tpu.gp import kernels as jkernels
    from temporalgps_torch.gp import kernels as tkernels

    atoms_j = jkernels.sde_atoms((S2 * getattr(jgp, name)()).stretch(SC))
    atoms_t = tkernels.sde_atoms((S2 * TORCH_KERNEL[name]()).stretch(SC), device="cpu")
    dts = np.array([0.01, 0.3, 2.0])
    pairs = [
        (atoms_t.P_inf, atoms_j.P_inf),
        (atoms_t.H, atoms_j.H),
        (atoms_t.transition(torch.from_numpy(dts)), atoms_j.transition(jnp.asarray(dts))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


def test_time_array_matches_reference():
    from temporalgps_tpu.utils.regular_spacing import time_array as jtime_array
    from temporalgps_torch.utils import time_array

    x = tt.RegularSpacing(0.5, 0.1, 7)
    np.testing.assert_allclose(
        time_array(x).numpy(), np.asarray(jtime_array(JRegularSpacing(0.5, 0.1, 7))),
        rtol=1e-15)
    np.testing.assert_allclose(
        time_array(x.stretch(2.0)).numpy(), 2.0 * time_array(x).numpy(), rtol=1e-15)


def test_port_imports_no_jax():
    root = pathlib.Path(__file__).resolve().parent.parent / "temporalgps_torch"
    files = sorted(root.rglob("*.py"))
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "temporalgps_tpu"), f"{path}: {name}"
