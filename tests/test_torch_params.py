"""The port's MLP weights equal the JAX package's, and the port imports no
jax, flax or msgpack, and nothing of the JAX package."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdpcutsel_tpu.models.scorer import MLPScorer as FlaxMLP
from sdpcutsel_tpu.models.scorer import load_params as flax_load_params
from sdpcutsel_tpu_torch.models.scorer import MLPScorer, load_params, params_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_npz_weights_equal_flax_artifacts(k):
    flax_params, trained = flax_load_params(k)
    assert trained
    want = params_from_flax(flax_params)
    got = load_params(k)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_params_from_flax_round_trips(tmp_path):
    flax_params, _ = flax_load_params(3)
    path = str(tmp_path / "mlp.npz")
    np.savez(path, **params_from_flax(flax_params))
    params = load_params(3, path)
    feats = np.random.default_rng(0).standard_normal((64, 15)).astype(np.float32)
    want = np.asarray(FlaxMLP(hidden=(64, 64)).apply(flax_params, jnp.asarray(feats)))
    got = MLPScorer(params, "cpu")(torch.as_tensor(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_params(3, str(tmp_path / "absent.npz"))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sdpcutsel_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in ('jax', 'flax', 'msgpack') if m in sys.modules]\n"
        "bad += [m for m in sys.modules\n"
        "        if m == 'sdpcutsel_tpu' or m.startswith('sdpcutsel_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('loop.solver', 'utils.debug', 'scoring_variants', 'nn_precision',\n"
        "          'cuts.triangle', 'models.labels', 'utils.checkpoint', 'parallel.round',\n"
        "          'parallel.sharding', 'parallel.mesh', 'bench_batched',\n"
        "          'loop.sdp_bound', 'loop.sdp_primal', 'loop.sdp_dual', 'utils.registry',\n"
        "          'utils.logging', 'bench.suite', 'cli', 'validate_sdp_bounds',\n"
        "          'validate_qcqp_bounds', 'models.train', 'parallel.distributed',\n"
        "          'run_multihost', 'multichip_dryrun', 'bench.plots', 'run_suite_incremental',\n"
        "          'run_qcqp_suite', 'rerun_cell', 'run_parity', 'run_qcqp_parity',\n"
        "          'ops.launches'):\n"
        "    assert 'sdpcutsel_tpu_torch.' + m in sys.modules, m\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
