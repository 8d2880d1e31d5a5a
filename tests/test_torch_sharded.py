"""The port's sharded kernel sampler and sharded generator against the
unsharded port and the JAX package's mesh.

One world of 4 gloo ranks on the CPU (tests/torch_dist.py
``sampler_world``, spawned once for the module; the kernels' plain
versions) runs ``FusedSampler.sample_sharded`` in "buffer", "none" and
"philox" modes on a 32-row cohort and a ragged 10-row one (padded to 12,
as JAX ``test_fused_sharded_pads_ragged_cohort``), and the generator under
a 4-rank mesh on each route (the kernel sampler with DDIM, the scan
sampler with DDPM as JAX ``tests/test_sharded_generation.py``, the cVAE),
64 rows with host calibration on rank 0.

- The port's sharded cohort equals its unsharded ``sample`` bit for bit in
  "buffer" and "none" modes (rows are independent; each rank runs the same
  kernels on its rows).
- It agrees with JAX ``sample_sharded(make_mesh(4), ...)`` in interpret
  mode on the same weights, ``x_init`` and noise within
  tests/test_torch_sampler.py's bf16-carry bound (atol 0.15, rtol 0.05):
  the port's unsharded sampler is held to JAX's there by that bound, and
  the JAX tests' own 1e-2 holds JAX's sharded output to JAX's unsharded
  one.
- The sharded generator agrees with the unsharded one within
  tests/test_sharded_generation.py's bounds (rtol 1e-3, atol 5e-3; under
  1% of the mutation bits flipped).
- With ``OSDM_DUMP_RAW`` set (a path per rank), only data-rank 0, the rank
  that calibrates, dumps the raw cohort.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osteosarcoma_diffusionmodel_tpu.ops.fused_sampler import FusedSampler as JaxFusedSampler
from osteosarcoma_diffusionmodel_tpu.parallel.mesh import make_mesh as jax_make_mesh
from osteosarcoma_diffusionmodel_torch.config import Config
from osteosarcoma_diffusionmodel_torch.data.dummy import cohort_arrays, make_dummy_cohort
from osteosarcoma_diffusionmodel_torch.generation import generator as gen_module
from osteosarcoma_diffusionmodel_torch.generation.generator import SyntheticPatientGenerator
from osteosarcoma_diffusionmodel_torch.models.networks import init_flax
from osteosarcoma_diffusionmodel_torch.training.checkpoint import data_stats_from_arrays
from osteosarcoma_diffusionmodel_torch.training.trainer import build_model
from torch_dist import results, spawn
from torch_parity import DATA_DIMS, TILE_B, make_pair

WORLD = 4
T, DDIM_STEPS = 6, 3
D = sum(DATA_DIMS)
COHORTS = {"even": 2 * TILE_B, "ragged": 10}
ATOL, RTOL = 0.15, 0.05  # the bf16-carry bound of tests/test_torch_sampler.py
GEN_ROWS = 64
SCENARIO = {"survival_time": 700, "event_occurred": 1}
GEN_RTOL, GEN_ATOL, GEN_FLIPS = 1e-3, 5e-3, 0.01  # tests/test_sharded_generation.py


def _generator_case(arch: str, hidden, data_dims, sampler: str):
    """(model, config, dims, data_stats) of a seeded model and a dummy
    cohort's statistics (host calibration, copula_joint)."""
    cfg = Config()
    cfg.model.architecture = arch
    cfg.model.hidden_dims = list(hidden)
    cfg.model.latent_dim = 16
    cfg.model.diffusion.num_steps = T
    cfg.model.compute_dtype = "float32"
    cfg.model.constraints.enabled = False
    cfg.generation.sampler = sampler
    cfg.generation.sampling_steps = DDIM_STEPS
    cohort = make_dummy_cohort(n_samples=40, n_mutation_genes=data_dims[0],
                               n_expression_genes=data_dims[1], n_pathways=data_dims[2])
    data, conditions, dims = cohort_arrays(cohort, cfg)
    model = build_model(cfg, dims)
    init_flax(model.module, torch.Generator().manual_seed(3))
    model.module.eval()
    return model, cfg, dims, data_stats_from_arrays(data, conditions, data_dims[0])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX side in this process, the port's on 4 spawned ranks."""
    work = tmp_path_factory.mktemp("sampler_world")
    jmodel, params, pmodel = make_pair(num_steps=T, compute_dtype="float32")
    rng = np.random.default_rng(11)
    jax_out, cohorts = {}, {}
    mesh = jax_make_mesh(WORLD)
    for case, b in COHORTS.items():
        cond = rng.standard_normal((b, 3)).astype(np.float32)
        noise = rng.standard_normal((T, b, D)).astype(np.float32)
        key = jax.random.PRNGKey(b)
        for mode, ddim in (("buffer", None), ("none", DDIM_STEPS)):
            js = JaxFusedSampler(jmodel, params, tile_b=TILE_B, interpret=True, gn_mode="f32",
                                 ddim_steps=ddim)
            kw = {"noise": jnp.asarray(noise)} if mode == "buffer" else {}
            jax_out[f"{case}/{mode}"] = np.asarray(
                js.sample_sharded(mesh, jnp.asarray(cond), key, **kw))
        # JAX's x_T: its rows of the padded cohort's draw (sample_sharded :944-952).
        b_padded = -(-b // (WORLD * TILE_B)) * WORLD * TILE_B
        init_rng, _ = jax.random.split(key)
        x_init = np.asarray(js._x_init(init_rng, b_padded).astype(jnp.float32))[:b]
        cohorts[case] = tuple(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (cond, x_init, noise))
    generators = {
        "kernel": _generator_case("diffusion", (128, 256, 128), DATA_DIMS, "ddim"),
        "scan": _generator_case("diffusion", (32, 64, 32), (5, 12, 3), "ddpm"),
        "cvae": _generator_case("cvae", (32, 64, 32), (5, 12, 3), "ddpm"),
    }
    torch.save({"model": pmodel, "ddim_steps": DDIM_STEPS, "cohorts": cohorts,
                "generators": generators, "gen_rows": GEN_ROWS, "scenario": SCENARIO},
               work / "inputs.pt")
    spawn("sampler_world", WORLD, work, timeout=240)
    return results(work, WORLD), jax_out, generators


@pytest.mark.parametrize("case", list(COHORTS))
@pytest.mark.parametrize("mode", ["buffer", "none"])
def test_sample_sharded_is_bit_equal_to_sample(world, case, mode):
    out, _, _ = world
    for res in out:
        got, ref = res[f"{case}/{mode}"], res[f"{case}/{mode}_ref"]
        assert got.shape == (COHORTS[case], D) and got.dtype == torch.float32
        assert torch.equal(got, ref)
        assert torch.equal(got, out[0][f"{case}/{mode}"])  # every rank holds the cohort


@pytest.mark.parametrize("case", list(COHORTS))
@pytest.mark.parametrize("mode", ["buffer", "none"])
def test_sample_sharded_matches_jax_mesh(world, case, mode):
    out, jax_out, _ = world
    ref = jax_out[f"{case}/{mode}"]
    np.testing.assert_allclose(out[0][f"{case}/{mode}"].numpy(), ref, atol=ATOL, rtol=RTOL)
    assert float(np.std(ref)) > 0.05  # the comparison sees real signal


def test_sample_sharded_philox(world):
    """In-kernel noise: one seed per rank, finite, the same cohort on every
    rank, bf16 on request."""
    out, _, _ = world
    for case, b in COHORTS.items():
        got = out[0][f"{case}/philox"]
        assert got.dtype == torch.bfloat16 and got.shape == (b, D)
        assert torch.isfinite(got.float()).all() and float(got.float().std()) > 0.05
        for res in out[1:]:
            assert torch.equal(res[f"{case}/philox"], got)


@pytest.mark.parametrize("name", ["kernel", "scan", "cvae"])
def test_sharded_generator_matches_unsharded(world, name):
    """Each route under a 4-rank mesh against the same generator without
    one; rank 0 calibrates on the host and every rank returns its cohort."""
    out, _, generators = world
    model, cfg, dims, stats = generators[name]
    gen_module.SAMPLERS.clear()
    gen_module.CALIBRATIONS.clear()
    plain = SyntheticPatientGenerator(copy.deepcopy(model), cfg, dims, stats, device="cpu")
    want = plain.generate(GEN_ROWS, SCENARIO, torch.Generator().manual_seed(5))
    route = dict(gen_module.SAMPLERS)
    assert dict(gen_module.CALIBRATIONS) == {"host": 1}
    for r, res in enumerate(out):
        got = res[f"gen/{name}"]
        samplers, calibrations = res[f"gen/{name}/routes"]
        assert samplers == route
        assert calibrations == ({"host": 1} if r == 0 else {})
        np.testing.assert_allclose(got["expression"], want["expression"], rtol=GEN_RTOL,
                                   atol=GEN_ATOL)
        np.testing.assert_allclose(got["pathways"], want["pathways"], rtol=GEN_RTOL,
                                   atol=GEN_ATOL)
        assert (got["mutations"] != want["mutations"]).mean() < GEN_FLIPS
        np.testing.assert_array_equal(got["conditions"], want["conditions"])
    assert route == {name: 1}  # each case is named after its route


@pytest.mark.parametrize("name", ["kernel", "scan", "cvae"])
def test_sharded_generator_dumps_from_data_rank_0(world, name):
    """One dump under the mesh, from data-rank 0: the gathered raw cohort
    and the conditions that rank returns."""
    out, _, generators = world
    dims = generators[name][2]
    assert all(f"gen/{name}/dump" not in res for res in out[1:])
    dump = out[0][f"gen/{name}/dump"]
    assert dump["samples"].shape == (GEN_ROWS, dims.data_dim)
    assert dump["samples"].dtype == np.float32 and np.isfinite(dump["samples"]).all()
    np.testing.assert_array_equal(dump["conditions"], out[0][f"gen/{name}"]["conditions"])
