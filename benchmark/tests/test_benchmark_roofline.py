"""The roofline's bytes and operations reproduce the bound column of
PERF.md's kernel table (at 32,768 and at 333 rows) and the denoiser's
multiply-accumulates a row."""

import pytest

from benchmark.roofline import (
    bound_s,
    k1,
    k1_gn,
    k1_posterior,
    macs_per_row,
    step_bounds,
    step_products,
)

HIDDEN, D = [256, 512, 256], 5142


@pytest.mark.parametrize("mode, ms", [("philox", 0.2070), ("buffer", 0.4082), ("none", 0.2070)])
def test_k1_posterior_bound_at_bench_rows(mode, ms):
    flops, nbytes = k1_posterior(32768, 256, D, mode)
    assert bound_s(flops, nbytes) * 1e3 == pytest.approx(ms, abs=1e-4)


@pytest.mark.parametrize("k, n, ms", [(256, 512, 0.0151), (512, 512, 0.0202), (512, 256, 0.0151),
                                      (256, 256, 0.0101), (1024, 256, 0.0252)])
def test_k1_gn_bounds_at_bench_rows(k, n, ms):
    assert bound_s(*k1_gn(32768, k, n)) * 1e3 == pytest.approx(ms, abs=1e-4)


def test_k1_posterior_bytes_philox():
    # 32,768x256 . 256x5142, "philox": the carry read and written, ~694 MB.
    assert k1_posterior(32768, 256, D, "philox")[1] == pytest.approx(694e6, rel=2e-3)


def test_k1_input_product_and_the_step():
    assert bound_s(*k1(32768, D, 256)) * 1e3 == pytest.approx(0.1164, abs=1e-4)
    step = step_bounds(32768, HIDDEN, D, "philox")
    assert sum(step.values()) * 1e3 == pytest.approx(0.4796, abs=5e-4)


def test_k1_posterior_bound_at_333_rows():
    # PERF.md: 0.0029 (philox, none) / 0.0049 (buffer) ms at 333 rows.
    assert bound_s(*k1_posterior(333, 256, D, "philox")) * 1e3 == pytest.approx(0.0029, abs=1e-4)
    assert bound_s(*k1_posterior(333, 256, D, "buffer")) * 1e3 == pytest.approx(0.0049, abs=1e-4)


def test_the_step_has_the_published_products():
    prods = step_products(HIDDEN, D)
    assert sorted(prods["k1_gn"]) == sorted([(256, 512), (512, 512), (512, 256), (256, 256),
                                            (256, 256), (256, 256), (512, 512), (512, 512),
                                            (1024, 256), (256, 256)])
    assert prods["k1_posterior"] == [(256, D)] and prods["k1"] == [(D, 256)]
    assert macs_per_row(HIDDEN, D) == 4_205_568


def test_unknown_noise_mode_raises():
    with pytest.raises(ValueError):
        k1_posterior(1, 256, D, "gauss")
