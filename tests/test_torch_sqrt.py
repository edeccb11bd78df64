"""The port's square-root engine (temporalgps_torch/ops/sqrt.py,
engine="sqrt") and the block engine's phase2="sqrt", against the reference
package (temporalgps_tpu/ops/sqrt.py, ops/block.py) on the CPU.

Models are tests/test_torch_assoc.py's (sum3, D = 3, N = 40, NaNs at both ends
filled), and the D = 5 sum for the block matrix path. Tolerance 1e-10
relative to the largest entry in float64 (the same algebra; the QR factors
may differ in the signs of their rows, which the roots' products do not
see); float32 within 1e-3 of float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from temporalgps_tpu.gp import lti_sde as japi
from temporalgps_tpu.models import missings as jmissings
from temporalgps_tpu.ops import block as jblock
from temporalgps_tpu.ops import sqrt as jsqrt
from test_torch_assoc import _case, _close_model
from torch_composite_cases import B, N, carry, close, fxs, jitted, make_y

from temporalgps_torch import convert
from temporalgps_torch.models import lgssm as tlgssm
from temporalgps_torch.ops import block, sqrt

torch.set_num_threads(1)


@pytest.mark.parametrize("forward,irregular", [(True, False), (False, True)],
                         ids=["forward-regular", "reverse-irregular"])
def test_sqrt_engine_matches_reference(forward, irregular):
    """logpdf, filter_ and posterior with engine="sqrt", float64."""
    jm, jy, tm, ty = _case(forward, irregular)
    close(tlgssm.logpdf(tm, ty, engine="sqrt").reshape(1),
          np.reshape(jitted(jsqrt.logpdf)(jm, jy), 1), rtol=1e-10)
    xf, xf_ref = tlgssm.filter_(tm, ty, engine="sqrt"), jitted(jsqrt.filter_)(jm, jy)
    close(xf.mean, xf_ref.mean, rtol=1e-10)
    close(xf.cov, xf_ref.cov, rtol=1e-10)
    _close_model(tlgssm.posterior(tm, ty, engine="sqrt"), jitted(jsqrt.posterior)(jm, jy))


@pytest.mark.parametrize("name", ["sum3", "sum5"], ids=["lanes", "matrix"])
def test_block_phase2_sqrt_matches_reference(name):
    """block.logpdf(..., phase2="sqrt") (sum3: K1's and K3's plain versions
    around the square-root prefix of the block aggregates, also through the
    kernels' autograd Function with fused=True; sum5: the matrix path)
    against the reference's `_logpdf_xla` with phase2="sqrt", B = 4 blocks,
    float64; and the covariance-form phase 2 beside it."""
    jfx, tfx = fxs(name, irregular=True)
    jm, jy, _ = jmissings.transform_model_and_obs(japi.build_lgssm(jfx),
                                                   jnp.asarray(make_y(nan_at=(0, N - 1))))
    tm, ty = carry(jm, True), torch.as_tensor(np.asarray(jy))
    for phase2 in ("sqrt", None):
        want = float(jitted(jblock.logpdf, n_blocks=B, pallas=False, phase2=phase2)(jm, jy))
        for fused in (None, True):
            got = tlgssm.logpdf(tm, ty, engine="block", n_blocks=B, phase2=phase2,
                                fused=fused).item()
            np.testing.assert_allclose(got, want, rtol=1e-10)


def test_sqrt_refusals():
    """SQRT_MAX_D refuses a larger state with the reference's message, on
    the engine and on phase2="sqrt"; an unknown phase2 raises."""
    D, n = sqrt.SQRT_MAX_D + 1, 2
    eye = np.broadcast_to(np.eye(D), (n, D, D))
    big = convert.lgssm_from_numpy(0.5 * eye, np.zeros((n, D)), eye, np.ones((n, D)),
                                   np.zeros(n), np.ones(n), np.zeros(D), np.eye(D), n,
                                   dtype=torch.float64, device="cpu")
    y = torch.zeros(n, dtype=torch.float64)
    for kwargs in ({"engine": "sqrt"}, {"engine": "block", "phase2": "sqrt"}):
        with pytest.raises(ValueError, match="square-root combine rejected"):
            tlgssm.logpdf(big, y, **kwargs)
    _, _, tm, ty = _case(True, False)
    with pytest.raises(ValueError, match="unknown phase2"):
        block.logpdf(tm, ty, phase2="qr")


def test_sqrt_engine_float32():
    """float32 on the sqrt engine and on phase2="sqrt": lml and filtering
    states within 1e-3 of the reference's float64, relative to the largest
    entry."""
    jm, jy, tm, ty = _case(True, True)
    to32 = lambda leaf: type(leaf)(leaf.value.float(), leaf.N) if hasattr(leaf, "N") else leaf.float()
    t, e = tm.trans, tm.emis
    m32 = tlgssm.LGSSM(
        type(t)(As=to32(t.As), offs=to32(t.offs), Qs=to32(t.Qs),
                x0=type(t.x0)(t.x0.mean.float(), t.x0.cov.float()), forward=True),
        type(e)(H=to32(e.H), h=to32(e.h), s=to32(e.s)))
    y32 = ty.float()
    want = float(jitted(jsqrt.logpdf)(jm, jy))
    for kwargs in ({"engine": "sqrt"}, {"engine": "block", "phase2": "sqrt", "n_blocks": B}):
        close(tlgssm.logpdf(m32, y32, **kwargs).double().reshape(1), np.reshape(want, 1),
              rtol=1e-3)
    xf, xf_ref = tlgssm.filter_(m32, y32, engine="sqrt"), jitted(jsqrt.filter_)(jm, jy)
    close(xf.mean.double(), xf_ref.mean, rtol=1e-3)
    close(xf.cov.double(), xf_ref.cov, rtol=1e-3)
