"""The port's modeling core against the reference's, on the CPU.

Same seeded (params, times) through ``repro.core`` and ``repro_torch.core``:
the float64 fit must give the same coefficients bit for bit, the float32
fit agree within the reference's own tolerance (rtol 1e-4, atol 1e-6,
tests/test_regression.py), and the design matrix within rtol 1e-6.
Fitted models cross between the packages through their shared JSON
format.  Also: the port imports neither JAX nor the reference.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from benchmarks import common as ref_common
from repro_torch import runner
from repro_torch.convert import regression_model_from_reference

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _cubic_surface(p):
    m, r = p[..., 0], p[..., 1]
    return (
        120.0 + 2.0 * m - 0.05 * m**2 + 0.0008 * m**3
        + 4.0 * r - 0.09 * r**2 + 0.0011 * r**3
    )


def _noisy_times(space, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    return _cubic_surface(space) * (1 + rng.normal(0, noise, len(space)))


SPACE = ref.grid([(5, 40, 5), (5, 40, 5)])
FIT_OPTIONS = [
    {},                                                   # paper-faithful
    {"scale": True, "lam": 1e-6, "cross_terms": True},    # tuner defaults
    {"robust": True},
    {"degree": 2, "scale": True},
]


@pytest.mark.parametrize("opts", FIT_OPTIONS)
def test_design_matrix_matches(opts):
    spec_opts = {k: v for k, v in opts.items() if k in ("degree", "scale",
                                                         "cross_terms")}
    rng = np.random.default_rng(4)
    params = rng.uniform(1, 40, size=(30, 2))
    spec = ref.fit_feature_spec(params, **spec_opts)
    assert port.fit_feature_spec(params, **spec_opts) == port.FeatureSpec(
        **dataclasses.asdict(spec))
    np.testing.assert_allclose(
        port.design_matrix(spec, params, device="cpu").numpy(),
        np.asarray(ref.design_matrix(spec, params)), rtol=1e-6)


@pytest.mark.parametrize("opts", FIT_OPTIONS)
def test_float64_fit_equals_reference(opts):
    times = _noisy_times(SPACE)
    want = ref.fit(SPACE, times, **opts)
    got = port.fit(SPACE, times, device="cpu", **opts)
    np.testing.assert_array_equal(got.coef, want.coef)
    assert (got.train_rmse, got.train_mape, got.r2) == (
        want.train_rmse, want.train_mape, want.r2)


@pytest.mark.parametrize("robust", [False, True])
def test_float32_fit_within_reference_tolerance(robust):
    times = _noisy_times(SPACE, seed=1, noise=0.005)
    kw = dict(scale=True, lam=1e-9, robust=robust)
    want = ref.fit(SPACE, times, dtype=jnp.float32, **kw)
    got = port.fit(SPACE, times, dtype=torch.float32, device="cpu", **kw)
    np.testing.assert_allclose(
        got.predict(SPACE, device="cpu").numpy(),
        np.asarray(want.predict(SPACE)), rtol=1e-4, atol=1e-6)


def test_prediction_error_stats_match():
    times = _noisy_times(SPACE)
    model = ref.fit(SPACE, times)
    test = np.array([[7, 13], [22, 31], [38, 9]], dtype=float)
    want = ref.prediction_error_stats(model, test, _cubic_surface(test))
    got = port.prediction_error_stats(
        regression_model_from_reference(model.to_dict()), test,
        _cubic_surface(test), device="cpu")
    # Predictions are float32 near 200, one ulp ~1.5e-5 apart, and the two
    # frameworks sum the 7-term dot in different orders: a few ulps of the
    # prediction move its error by ~1e-5 percentage points.
    np.testing.assert_allclose(got["per_experiment_pct"],
                               want["per_experiment_pct"], rtol=0, atol=1e-4)


def test_model_database_crosses_packages(tmp_path):
    times = _noisy_times(SPACE)
    ref_db = ref.ModelDatabase()
    ref_db.put("wordcount", "cluster-A", ref.fit(SPACE, times))
    ref_db.put("eximparse", "cluster-A", ref.fit(SPACE, times * 2, scale=True),
               backend="pallas")
    ref_path = str(tmp_path / "ref.json")
    ref_db.save(ref_path)

    port_db = port.ModelDatabase.load(ref_path)
    assert port_db.applications() == ref_db.applications()
    for app, plat, backend in ref_db.applications():
        for cfg in ([10, 10], [24, 7], [37, 30]):
            np.testing.assert_allclose(
                port_db.predict(app, plat, cfg, backend=backend, device="cpu"),
                ref_db.predict(app, plat, cfg, backend=backend), rtol=1e-6)

    port_path = str(tmp_path / "port.json")
    port_db.save(port_path)
    back = ref.ModelDatabase.load(port_path)
    np.testing.assert_array_equal(back.get("wordcount", "cluster-A").coef,
                                  ref_db.get("wordcount", "cluster-A").coef)
    with pytest.raises(KeyError, match="platform"):
        port_db.get("wordcount", "cluster-B")


def _analytic_run_fns(pkg_seed):
    """Deterministic per-category surfaces with a little seeded noise."""
    def make(offset, tilt, seed):
        rng = np.random.default_rng(seed)
        noise = {}

        def run(cfg):
            key = tuple(float(x) for x in cfg)
            if key not in noise:
                noise[key] = 1 + rng.normal(0, 0.01)
            return (_cubic_surface(np.asarray(cfg)) + offset
                    + tilt * cfg[0]) * noise[key]
        return run
    return {"a": make(0.0, 0.5, pkg_seed), "b": make(-15.0, 1.5, pkg_seed + 1),
            "c": make(5.0, -0.2, pkg_seed + 2)}


def test_tune_categorical_same_argmin():
    space = ref.grid([(5, 40, 5), (5, 40, 5)])
    want = ref.tune_categorical(_analytic_run_fns(0), space, seed=3)
    got = port.tune_categorical(_analytic_run_fns(0), space, seed=3,
                                device="cpu")
    assert got.best_category == want.best_category
    np.testing.assert_array_equal(got.best_config, want.best_config)
    for cat in want.per_category:
        np.testing.assert_array_equal(got.per_category[cat].sampled_configs,
                                      want.per_category[cat].sampled_configs)


def test_profile_experiments_matches():
    configs = runner.training_configs()
    run = lambda cfg: float(_cubic_surface(np.asarray(cfg)))  # noqa: E731
    want = ref.profile_experiments(run, configs, repeats=3)
    got = port.profile_experiments(run, configs, repeats=3)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.raw_times, want.raw_times)


def test_runner_settings_match_benchmarks():
    np.testing.assert_array_equal(runner.training_configs(),
                                  ref_common.training_configs())
    np.testing.assert_array_equal(runner.heldout_configs(),
                                  ref_common.heldout_configs())
    app, corpus = runner.make_app("eximparse", 3000)
    ref_app, ref_corpus = ref_common.make_app("eximparse", 3000)
    np.testing.assert_array_equal(corpus, ref_corpus)
    assert app.key_space == ref_app.key_space


def test_job_runner_times_a_job_on_cpu():
    app, corpus = runner.make_app("wordcount", 2048)
    run = runner.JobRunner(app, corpus, device="cpu", reduce_backend="cuda")
    t = run((5.0, 7.0))
    assert t > 0 and (5, 7) in run._cache
    assert port.timeit(lambda: None, device="cpu") >= 0


def test_cuda_entry_points_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = port.fit_feature_spec(SPACE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.design_matrix(spec, SPACE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.fit(SPACE, _noisy_times(SPACE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.JobRunner(*runner.make_app("wordcount", 64))


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch import quickstart

    quickstart.main(["--device", "cpu", "--tokens", "4096"])
    out = capsys.readouterr().out
    assert "fit: train MAPE" in out and out.count("predicted") == 3


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, found by walking the package, imports."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in names:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 99 else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
