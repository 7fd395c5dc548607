"""The registry-wide behavior-spec sweep on the port, and every case against
the JAX package.

- The reference's ``tests/test_stage_registry_specs.py`` with the import
  swapped, on the CPU: every class in the port's ``STAGE_REGISTRY`` passes
  ``assert_transformer_spec`` / ``assert_estimator_spec`` through a case of
  ``tests/torch_registry_cases.py``, is the fitted product of an estimator
  case, or carries an exemption with a reason.
- Cross-package: each case is built in both packages on the same values,
  fitted where the stage is an estimator, transformed, and the two output
  columns held to one type, layout, mask and slot metadata, and their values
  to the case's tolerance in :data:`XPKG_TOL` (0.0: bitwise).  The stages
  that draw random numbers are fed the reference's ``jax.random`` draws
  through the port's seams (``models/trees.py::draw_bootstrap``,
  ``models/mlp.py::draw_mlp_init``, ``ops/embeddings.py::draw_word2vec_init``,
  ``draw_lda_init``), as the families' own parity tests do.
"""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import transmogrifai_tpu
from transmogrifai_tpu import types as JT
from transmogrifai_tpu.data import dataset as JD
from transmogrifai_tpu.features import builder as JFB
from transmogrifai_tpu.models import mlp as JM
from transmogrifai_tpu.stages import base as JB
from transmogrifai_tpu.utils import vector_metadata as JVM
import transmogrifai_tpu_torch
from transmogrifai_tpu_torch import types as TT
from transmogrifai_tpu_torch.data import dataset as TD
from transmogrifai_tpu_torch.features import builder as TFB
from transmogrifai_tpu_torch.models import mlp as TM
from transmogrifai_tpu_torch.models import trees as TTR
from transmogrifai_tpu_torch.ops import embeddings as TE
from transmogrifai_tpu_torch.perf.kernels.dispatch import use_device
from transmogrifai_tpu_torch.stages import base as TB
from transmogrifai_tpu_torch.stages.base import STAGE_REGISTRY, Estimator
from transmogrifai_tpu_torch.testkit.specs import (
    assert_estimator_spec,
    assert_transformer_spec,
)
from transmogrifai_tpu_torch.utils import vector_metadata as TVM

import torch_registry_cases as RC

# populate both registries: stages register at class-definition time, so
# every module must be imported before the sweep enumerates STAGE_REGISTRY
for _pkg in (transmogrifai_tpu, transmogrifai_tpu_torch):
    for _m in pkgutil.walk_packages(_pkg.__path__, prefix=_pkg.__name__ + "."):
        if "__main__" not in _m.name:
            importlib.import_module(_m.name)

TPKG = RC.namespace(TD, TB, TT, TVM, TFB)
JPKG = RC.namespace(JD, JB, JT, JVM, JFB)

CASES = RC.CASES
EXPECTED_MODEL = RC.EXPECTED_MODEL
EXEMPT = {
    **RC.EXEMPT,
    "EstimatorStub":
        "DAG placeholder for a saved estimator node; covered by the serde tests",
}


@pytest.fixture(autouse=True)
def _cpu():
    with use_device("cpu"):
        yield


def test_case_tables_are_disjoint_and_known():
    assert not set(CASES) & set(EXEMPT)
    unknown = (set(CASES) | set(EXEMPT) | set(EXPECTED_MODEL.values())) \
        - set(STAGE_REGISTRY)
    assert not unknown, f"case tables reference unregistered stages: {unknown}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_stage_spec(name):
    stage, ds, flags = RC.build(TPKG, name)
    if isinstance(stage, Estimator):
        model = assert_estimator_spec(stage, ds, **flags)
        assert type(model).__name__ == EXPECTED_MODEL[name], (
            f"update EXPECTED_MODEL: {name} produced {type(model).__name__}")
    else:
        assert_transformer_spec(stage, ds, **flags)


def test_registry_fully_covered():
    """Every PACKAGE stage is swept, a swept estimator's model product, or
    explicitly exempted with a reason.  Stage classes test modules define for
    their own fixtures register too — those are out of scope."""
    covered = set(CASES) | set(EXPECTED_MODEL.values()) | set(EXEMPT)
    package = {n for n, c in STAGE_REGISTRY.items()
               if c.__module__.startswith("transmogrifai_tpu_torch.")}
    missing = sorted(package - covered)
    assert not missing, (
        f"stages registered without spec coverage or exemption: {missing}")


# ---------------------------------------------------------------------------
# Each case against the JAX package
# ---------------------------------------------------------------------------

#: case -> (max |port - JAX| of the output values, the family's rule from
#: ROADMAP.md and the families' parity tests).  Every case not listed is
#: bitwise (0.0): the host stages are copies of the reference's code, and the
#: encode and bucketize slots, RF's int8 path and hashing are pinned bitwise.
#: Measured on these cases: GBT/XGBoost 1.2e-7, LR 9.3e-7, multinomial LR
#: 5.0e-6, SVC 4.5e-7, linear 3.9e-7, GLM 2.9e-7, NaiveBayes 5.7e-7, MLP
#: 3.2e-5, LDA 6.0e-7, Word2Vec 7.5e-9.
XPKG_TOL = {
    "GradientBoostedTreesClassifier": (1e-3, "GBT float histograms: 1e-3"),
    "GradientBoostedTreesRegressor": (1e-3, "GBT float histograms: 1e-3"),
    "XGBoostClassifier": (1e-3, "GBT float histograms: 1e-3"),
    "XGBoostRegressor": (1e-3, "GBT float histograms: 1e-3"),
    "LogisticRegression": (1e-6, "LR fits: coefficients within 1e-6"),
    "MultinomialLogisticRegression": (
        1e-5, "multinomial LR: coefficients within atol 1e-5"),
    "NaiveBayes": (1e-5, "NaiveBayes: 1e-5"),
    "LinearSVC": (1e-6, "linear fits: coefficients within 1e-6"),
    "LinearRegression": (1e-6, "linear fits: coefficients within 1e-6"),
    "GeneralizedLinearRegression": (1e-6, "linear fits: coefficients within 1e-6"),
    "MultilayerPerceptronClassifier": (
        1e-4, "the MLP's float32 Adam steps, fed the reference's draws: 1e-4"),
    "LDA": (1e-5, "LDA's float32 digamma E-step: 1e-5"),
    "Word2Vec": (1e-6, "Word2Vec fed the reference's draws: 1e-6"),
}


def _jax_bootstrap(seed, rate, n_trees, n, device):
    draws = jax.random.poisson(jax.random.PRNGKey(int(seed)), float(rate),
                               (int(n_trees), int(n)))
    return torch.from_numpy(np.asarray(draws).astype(np.float32)).to(device)


def _jax_mlp_init(sizes, seed, device):
    return [(torch.from_numpy(np.array(w)).to(device),
             torch.from_numpy(np.array(b)).to(device))
            for w, b in JM._init_params(tuple(sizes), jax.random.PRNGKey(seed))]


def _jax_w2v_init(seed, v, dim, device):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return tuple(torch.from_numpy(np.array(jax.random.uniform(
        k, (v, dim), jnp.float32, -0.5 / dim, 0.5 / dim))).to(device)
        for k in (k1, k2))


def _jax_lda_init(seed, k, v, device):
    lam = jax.random.gamma(jax.random.PRNGKey(seed), 100.0, (k, v)) / 100.0
    return torch.from_numpy(np.array(lam.astype(jnp.float32))).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(TTR, "draw_bootstrap", _jax_bootstrap)
    monkeypatch.setattr(TM, "draw_mlp_init", _jax_mlp_init)
    monkeypatch.setattr(TE, "draw_word2vec_init", _jax_w2v_init)
    monkeypatch.setattr(TE, "draw_lda_init", _jax_lda_init)


def _output(pkg, name):
    stage, ds, _flags = RC.build(pkg, name)
    model = stage.fit(ds) if isinstance(stage, pkg.Estimator) else stage
    return model.transform(ds)[model.output_name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_the_jax_package(name, reference_draws):
    tol, rule = XPKG_TOL.get(name, (0.0, "bitwise"))
    diff = RC.column_diff(_output(TPKG, name), _output(JPKG, name))
    assert diff <= tol, f"{name}: max |port - JAX| {diff:.3g} over {tol} ({rule})"


def test_tolerance_table_names_cases():
    assert set(XPKG_TOL) <= set(CASES)
