"""Port vs JAX: the network-free T-game (simt_tpu_torch/tools/tgame.py against
experiments/ntm_identification/tgame.py).

  - both problems (toy C=8/O=2, the reference C=19/O=3 on ClassDist_bapa) under the
    four force settings, ``STEPS`` outer steps of ``run_game`` from JAX's
    ``ntm_init(PRNGKey(0))``: T after the last step within 1e-5 and the distances
    ``d0``/``d1`` within 1e-4 of the JAX game's;
  - the problems' priors and T* equal to the JAX program's, and the port's
    ``models/ntm.py::ntm_invert`` equal to tgame.py's own copy on both T* with a
    float64 class distribution; with the game's float32 one both give parameters
    that reproduce T* within 1e-5 (under NumPy 2's promotion rules the copy adds a
    Python float to a float32 scalar in float32, where the port's casts to float64
    first, so their parameters differ in the last digits of a cancellation);
  - ``main`` on the CPU: its four lines a problem.

The JAX program pins JAX to the CPU and puts the repository on ``sys.path`` when it is
imported; it is loaded from its file and its games compile without XLA's optimisation
passes (a fifth of the compile time; float reassociation at most). Both run on one
thread: the games are products of matrices of at most 22 x 22, which several threads
only slow down.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

from simt_tpu.models import ntm as jntm
from simt_tpu_torch.models import ntm as ntm_lib
from simt_tpu_torch.tools import tgame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 20


@pytest.fixture(scope="module")
def jgame():
    path = os.path.join(REPO, "experiments", "ntm_identification", "tgame.py")
    spec = importlib.util.spec_from_file_location("jax_tgame", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    saved = jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", saved)
    torch.set_num_threads(n)


PROBLEMS = ["toy_problem", "ref_problem"]


@pytest.mark.parametrize("problem", PROBLEMS)
def test_problems_and_ntm_invert_match_jax(jgame, problem):
    c, o, pi, t_star = getattr(tgame, problem)()
    jc, jo, jpi, jt = getattr(jgame, problem)()
    assert (c, o) == (jc, jo)
    np.testing.assert_array_equal(pi, jpi)
    np.testing.assert_array_equal(t_star, jt)
    cd = pi @ t_star
    np.testing.assert_array_equal(ntm_lib.ntm_invert(t_star, cd, c),
                                  jgame.ntm_invert(t_star, cd, c))
    cd = cd.astype(np.float32)
    for p in (ntm_lib.ntm_invert(t_star, cd, c), jgame.ntm_invert(t_star, cd, c)):
        t = ntm_lib.ntm_forward(torch.from_numpy(p), torch.from_numpy(cd), c, o)
        np.testing.assert_allclose(t.numpy(), t_star, rtol=0, atol=1e-5)


@pytest.mark.parametrize("setting", [kw for _, kw in tgame.SETTINGS],
                         ids=[label.split(" (")[0] for label, _ in tgame.SETTINGS])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_game_matches_jax(jgame, problem, setting):
    prob = getattr(tgame, problem)()
    c, o = prob[:2]
    jd0, jd1, jt = jgame.run_game(*prob, steps=STEPS, seed=0, verbose=False, **setting)
    init = torch.tensor(np.asarray(jntm.ntm_init(jax.random.PRNGKey(0), c, o)))
    d0, d1, t = tgame.run_game(*prob, steps=STEPS, init=init, device="cpu",
                               verbose=False, **setting)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-5)
    assert d0 == pytest.approx(jd0, abs=1e-4) and d1 == pytest.approx(jd1, abs=1e-4)
    assert d1 != d0  # T moved


def test_main_prints_every_setting_on_both_problems(capsys):
    out = tgame.main(["--device", "cpu", "--steps", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert len(out) == 2 * len(tgame.SETTINGS) == sum("dT" in s for s in lines)
    assert [s for s in lines if s.startswith("==")] == ["== toy C=8/O=2 ==",
                                                        "== reference C=19/O=3 =="]
    assert all(np.isfinite([r["d0"], r["d1"]]).all() for r in out)
