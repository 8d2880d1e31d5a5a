"""(a) Noise schedules: the port's float64 host tables against the JAX
package's float32 ones and against an independent float64 evaluation."""

import numpy as np
import pytest

from osteosarcoma_diffusionmodel_tpu.ops import schedules as jax_sched
from osteosarcoma_diffusionmodel_torch.ops import schedules as port_sched

FIELDS = (
    "betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "posterior_coef_x0", "posterior_coef_xt", "posterior_variance",
)


@pytest.mark.parametrize("kind", ["linear", "cosine", "sigmoid"])
@pytest.mark.parametrize("steps", [6, 20, 1000])
def test_schedule_tables_match_jax(kind, steps):
    """Tolerance: the JAX tables are float32 and round every
    intermediate; 1 - alpha_cumprod near t = 0 and 1 - ratio of the
    cosine schedule cancel, so a float32 entry sits up to ~8e-4 relative
    from the exact value where those are small (1e-3 allowed), and
    within a few float32 ulps (3e-7 absolute) elsewhere."""
    ref = jax_sched.DiffusionSchedule.create(kind, steps)
    got = port_sched.DiffusionSchedule.create(kind, steps)
    assert got.num_steps == ref.num_steps == steps
    for name in FIELDS:
        a = getattr(got, name)
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, np.asarray(getattr(ref, name), np.float64),
                                   rtol=1e-3, atol=3e-7, err_msg=name)


@pytest.mark.parametrize("steps", [6, 20, 1000])
def test_cosine_schedule_exact_in_float64(steps):
    """The port's tables are the float64 evaluation of the formulas:
    equal to an independent numpy float64 transcription, bit for bit."""
    s = np.arange(steps + 1, dtype=np.float64) / steps
    acp = np.cos((s + 0.008) / 1.008 * np.pi / 2) ** 2
    acp = acp / acp[0]
    betas = np.clip(1.0 - acp[1:] / acp[:-1], 0.0001, 0.9999)
    alphas = 1.0 - betas
    cum = np.cumprod(alphas)
    prev = np.concatenate([[1.0], cum[:-1]])
    got = port_sched.DiffusionSchedule.create("cosine", steps)
    np.testing.assert_array_equal(got.betas, betas)
    np.testing.assert_array_equal(got.alphas_cumprod, cum)
    np.testing.assert_array_equal(got.posterior_coef_x0, np.sqrt(prev) * betas / (1.0 - cum))
    np.testing.assert_array_equal(got.posterior_variance, (1.0 - prev) / (1.0 - cum) * betas)


@pytest.mark.parametrize("train,sample", [(1000, 50), (1000, 1000), (20, 7), (6, 10)])
def test_ddim_timesteps_exact(train, sample):
    np.testing.assert_array_equal(port_sched.ddim_timesteps(train, sample),
                                  jax_sched.ddim_timesteps(train, sample))


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        port_sched.get_beta_schedule("quadratic", 10)
