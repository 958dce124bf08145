"""Port vs JAX: the planted-noise run (simt_tpu_torch/tools/planted_noise.py against
experiments/planted_noise_tpu/run.py) and ``ntm_invert`` (against
simt_tpu/models/ntm.py::ntm_invert):

  - ``ntm_invert`` on the full and the smoke fixture's T* to 1e-6, and the same raise
    on a leak above its structural cap;
  - the ``Fixture`` at the smoke geometry (64x128, 5 + 3 classes) and at 512x1024 (19 +
    15): PI, T*, class_dist, T_ATTR and P* to 1e-6, the feature means, two seeded
    examples (images and teacher posteriors to 1e-6, clean and noisy labels exactly)
    and the teacher routing exactly; run.py's own smoke priors fail the fixture's check
    in both packages alike;
  - the arms at the smoke geometry from one flax init (the student's; the warm model
    takes its closed-set part) carried across by ``state_dict_from_flax``, with
    JAX's T1/T2: 2 warmup steps, 2
    CE steps and 2 steps of each SimT arm against the JAX step functions wired as
    run.py wires them. Each step's losses within rel 1e-3 (abs 1e-4), the final
    ``t_metrics`` within 1e-5, each SimT arm's student and T changes within 1e-2 of
    their L2 norm (the loop tests' parameter tolerance), the oracle's T exactly P*.

run.py parses ``sys.argv`` and turns on a persistent compile cache when it is imported,
so it is imported with ``sys.argv`` patched to its ``--smoke`` form and the cache in a
temporary directory, and the JAX settings and ``sys.path`` it changed are restored.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simt_tpu.models import ntm as jntm
from simt_tpu_torch.models import ntm as tntm
from simt_tpu_torch.models import from_jax as pn_from_jax
from simt_tpu_torch.models.from_jax import state_dict_from_flax
from simt_tpu_torch.tools import planted_noise as pn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_PY = os.path.join(REPO, "experiments", "planted_noise_tpu", "run.py")
RUN_SMOKE_PI = [0.22, 0.13, 0.20, 0.12, 0.18]  # run.py:282-284
GEOMETRIES = {"smoke": dict(pairs=2, extra=1, opens=3, hw=(64, 128),
                            known_pi=pn.SMOKE_KNOWN_PI),
              "full": dict(pairs=9, extra=1, opens=15, hw=(512, 1024),
                           known_pi=pn.FULL_KNOWN_PI)}
WARM, TRAIN = 2, 2  # warmup and arm steps of the parity run
TOL_LOSS = dict(rel=1e-3, abs=1e-4)
TOL_CHANGE = 1e-2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny steps run faster on one thread than on threads that the test run's
    other workers share."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jrun(tmp_path_factory):
    saved = (list(sys.path), jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", ["run.py", "--smoke"])
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    try:
        spec = importlib.util.spec_from_file_location("planted_noise_tpu_run", RUN_PY)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
        sys.path[:] = saved[0]
        jax.config.update("jax_compilation_cache_dir", saved[1])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[2])
    return mod


@pytest.fixture(scope="module")
def fixtures(jrun):
    return {g: (jrun.Fixture(**kw), pn.Fixture(**kw)) for g, kw in GEOMETRIES.items()}


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_ntm_invert_matches_jax(fixtures, geom):
    jfx, _ = fixtures[geom]
    c = jfx.C
    want = jntm.ntm_invert(jfx.T_STAR, jfx.CLASS_DIST, c)
    got = tntm.ntm_invert(jfx.T_STAR, jfx.CLASS_DIST, c)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    t = tntm.ntm_forward(torch.from_numpy(got), torch.from_numpy(jfx.CLASS_DIST), c,
                         jfx.O).numpy()
    np.testing.assert_allclose(t, jfx.T_STAR, atol=1e-5)


def test_ntm_invert_raises_on_a_leak_over_its_cap(fixtures):
    jfx, _ = fixtures["full"]
    t = jfx.T_STAR.copy()
    t[1, 0] = 0.5  # far above class 0's cap cd_0
    t[1, 1] = 1.0 - (t[1].sum() - t[1, 1])
    with pytest.raises(ValueError) as want:
        jntm.ntm_invert(t, jfx.CLASS_DIST, jfx.C)
    with pytest.raises(ValueError, match="row 1: leak above structural cap") as got:
        tntm.ntm_invert(t, jfx.CLASS_DIST, jfx.C)
    assert str(got.value) == str(want.value)


def test_run_py_smoke_priors_fail_the_fixture_check_in_both(jrun):
    kw = {**GEOMETRIES["smoke"], "known_pi": RUN_SMOKE_PI}
    with pytest.raises(AssertionError) as want:
        jrun.Fixture(**kw)
    with pytest.raises(AssertionError) as got:
        pn.Fixture(**kw)
    assert str(got.value) == str(want.value)  # class_dist's max, 0.3047


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_fixture_matches_jax(fixtures, geom):
    jfx, tfx = fixtures[geom]
    assert (tfx.C, tfx.O, tfx.HW, tfx.G, tfx.G8) == (jfx.C, jfx.O, jfx.HW, jfx.G, jfx.G8)
    for name in ("PI", "T_STAR", "CLASS_DIST", "T_ATTR", "P_STAR"):
        np.testing.assert_allclose(getattr(tfx, name), getattr(jfx, name), atol=1e-6,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(tfx.MEANS, jfx.MEANS)
    jrng, trng = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(2):
        (jim, jcl, jny, jtp), (tim, tcl, tny, ttp) = (jfx.make_example(jrng),
                                                      tfx.make_example(trng))
        np.testing.assert_allclose(tim, jim, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ttp, jtp, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tcl, jcl)
        np.testing.assert_array_equal(tny, jny)
        assert tny.dtype == jny.dtype and tcl.dtype == jcl.dtype
    tdata = tfx.make_dataset(2, seed=0)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tdata[0].items()} == {
        "image": ((1, *tfx.HW, 3), torch.float32), "label": ((1, *tfx.HW), torch.int32),
        "teacher_prob8": ((1, *tfx.G8, tfx.C), torch.float32),
        "_clean": ((1, *tfx.HW), torch.int32)}
    assert tfx.routing_diagnostics(tdata) == jfx.routing_diagnostics(
        jfx.make_dataset(2, seed=0))


# --------------------------------------------------------------------------- the arms


def _jax_steps(jrun, jfx, cd_path):
    """run.py's protocol at WARM + TRAIN steps on its own step functions: every step in
    order as (stage, state before, metrics, state after), the student's initial
    variables and T1/T2's initial parameters."""
    C, O, HW = jfx.C, jfx.O, jfx.HW
    train_data = jfx.make_dataset(2, seed=0)

    def make_cfg(stage, steps, lr_t, **simt_kw):
        return jrun.TrainConfig(
            stage=stage,
            model=jrun.ModelConfig(num_classes=C, open_classes=O, openset=stage == "simt",
                                   compute_dtype="float32"),
            optim=jrun.OptimConfig(num_steps=steps, learning_rate=1e-3,
                                   learning_rate_t=lr_t),
            simt=jrun.SimTConfig(**{**dict(class_dist=cd_path,
                                           threshold_high=jfx.THRESH_HIGH,
                                           threshold_low=jfx.THRESH_LOW,
                                           inner_w_steps=10), **simt_kw}))

    def model_of(openset):
        return jrun.ResNetMulti(num_classes=C, open_classes=O if openset else 0,
                                openset=openset, layers=pn.SMOKE_LAYERS, dtype=jnp.float32)

    out = []

    def steps(stage, step, state, n):
        for i in range(n):
            after, m = step(state, train_data[i % len(train_data)])
            out.append((stage, state, {k: float(v) for k, v in m.items()}, after))
            state = after
        return state

    # One flax init: the student's (run.py's key seed + 1); the warm model takes its
    # closed-set part (every warm variable has a student twin of its shape).
    student = model_of(True)
    svars0 = jax.jit(lambda r: student.init(r, jnp.zeros((1, *HW, 3)), False))(
        jax.random.PRNGKey(1))
    wcfg = make_cfg("warmup", WARM + TRAIN, 1e-2)
    wmodel = model_of(False)
    shapes = jax.eval_shape(lambda: wmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, *HW, 3)), False))
    wvars = {c: jrun.transfer_params(svars0[c], shapes[c]) for c in shapes}
    assert all(isinstance(v, jax.Array) for v in jax.tree.leaves(wvars))
    wstep = jrun.make_warmup_step(wmodel, wcfg)
    wstate = steps("warmup", wstep, jrun.create_warmup_state(wmodel, wvars, wcfg), WARM)
    warm_params, warm_stats = wstate.model.params, wstate.model.batch_stats
    steps("warmup", wstep, wstate, TRAIN)  # the CE arm

    t_init = None
    for kw, oracle, lr_t in (({}, False, 1e-2), (pn.PAPER_KW, False, 1e-2),
                             ({}, True, 0.0)):  # verbatim, paper, oracle
        scfg = make_cfg("simt", TRAIN, lr_t, **kw)
        svars = {"params": jrun.transfer_params(warm_params, svars0["params"]),
                 "batch_stats": jrun.transfer_params(warm_stats, svars0["batch_stats"])}
        tvars = {"params": warm_params, "batch_stats": warm_stats}
        sstate = jrun.create_simt_state(svars, tvars, scfg, jax.random.PRNGKey(3))
        t_init = (np.asarray(sstate.t1.param), np.asarray(sstate.t2.param))
        if oracle:
            sstate = sstate.replace(t1=sstate.t1.replace(param=jnp.asarray(jfx.P_STAR)),
                                    t2=sstate.t2.replace(param=jnp.asarray(jfx.P_STAR)))
        steps("simt", jrun.make_simt_step(student, model_of(False), scfg), sstate, TRAIN)
    return out, wvars, svars0, t_init


def _jax_t_metrics(jfx, st):
    """run.py's ``t_metrics`` (a closure of its ``main``)."""
    def t_of(param):
        return np.asarray(jntm.ntm_forward(param, jnp.asarray(jfx.CLASS_DIST), jfx.C,
                                           jfx.O))

    def d(param, target):
        return float(np.abs(t_of(param) - target).sum(1)[: jfx.C].mean())

    return {"t_dist_known": 0.5 * (d(st.t1.param, jfx.T_STAR) + d(st.t2.param, jfx.T_STAR)),
            "t_attr_known": 0.5 * (d(st.t1.param, jfx.T_ATTR) + d(st.t2.param, jfx.T_ATTR)),
            "t1_leak_10": float(t_of(st.t1.param)[1, 0])}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tensors(state) -> dict:
    """The model's parameters by the port's names, and T1/T2 for a SimT state."""
    out = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    if hasattr(state, "t1"):
        out.update(t1=state.t1.param.detach().clone(), t2=state.t2.param.detach().clone())
    return out


def _jax_tensors(state) -> dict:
    out = dict(state_dict_from_flax(_np_tree({"params": state.model.params})))
    if hasattr(state, "t1"):
        out.update(t1=torch.from_numpy(np.array(state.t1.param)),
                   t2=torch.from_numpy(np.array(state.t2.param)))
    return out


def _change_error(got0, got1, want0, want1, keys) -> float:
    """|| port change - JAX change || / || JAX change || over ``keys``."""
    dg = torch.cat([(got1[k] - got0[k]).ravel() for k in keys])
    dw = torch.cat([(want1[k] - want0[k]).ravel() for k in keys])
    return float((dg - dw).norm() / dw.norm())


def test_arms_match_jax(jrun, fixtures, tmp_path, monkeypatch):
    """The tool's run against run.py's protocol step by step: before each step the
    port's state is checked against the tool's wiring (the step count; at an arm's
    first step the student's open heads from the carried init, its other weights the
    port's warm weights, T1/T2 the carried or planted ones) and then set to JAX's state
    before that step (``load_state``), so that every step starts from the same state
    and a random-init trunk's growth of one-ulp differences over the steps (up to 0.3%
    of a loss by step 4, and an anchor flip, in free-running trajectories) does not
    hide a step's own error."""
    jfx, _ = fixtures["smoke"]
    cd_path = str(tmp_path / "cd.npy")
    np.save(cd_path, jfx.CLASS_DIST)
    # XLA's optimisation passes roughly double the CPU compile time of the four step
    # programs and change no result beyond float reassociation.
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jsteps, wvars, svars0, t_init = _jax_steps(jrun, jfx, cd_path)
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)
    inits = pn.Inits(state_dict_from_flax(_np_tree(wvars)),
                     state_dict_from_flax(_np_tree(svars0)),
                     tuple(torch.from_numpy(np.array(t)) for t in t_init))
    P_STAR = torch.from_numpy(jfx.P_STAR)
    done, warm_after, simt_states = [], [], []

    def recording(factory):
        def make(cfg, *a, **kw):
            step = factory(cfg, *a, **kw)

            def call(state, batch):
                i = len(done)
                stage, jbefore, jm, jafter = jsteps[i]
                assert stage == cfg.stage and state.step == int(jbefore.step), i
                if stage == "simt" and (not simt_states or simt_states[-1] is not state):
                    # An arm's first step: the tool's wiring.
                    simt_states.append(state)
                    own = state.model.state_dict()
                    for k, v in own.items():
                        want = warm_after[WARM - 1].get(k, inits.student.get(k))
                        if want is not None:
                            assert torch.equal(v, want), (i, k)
                    oracle = cfg.optim.learning_rate_t == 0.0
                    for p, t in zip((state.t1.param, state.t2.param), inits.ntm):
                        assert torch.equal(p.detach(), P_STAR if oracle else t), i
                carried = (pn_from_jax.simt_state_from_jax if stage == "simt"
                           else pn_from_jax.warmup_state_from_jax)(_np_tree(jbefore))
                pn_from_jax.load_state(state, carried)
                before = _tensors(state)
                m = step(state, batch)
                after = _tensors(state)
                if stage == "warmup":
                    warm_after.append({k: v.detach().clone() for k, v in
                                       state.model.state_dict().items()})
                done.append(i)
                for k, v in jm.items():
                    tol = dict(rel=1e-6) if k == "lr" else TOL_LOSS
                    assert float(m[k]) == pytest.approx(v, **tol), (i, k)
                want0, want1 = _jax_tensors(jbefore), _jax_tensors(jafter)
                trained = [k for k in want1 if k not in ("t1", "t2")
                           and not torch.equal(want0[k], want1[k])]
                assert trained, i
                assert _change_error(before, after, want0, want1, trained) <= TOL_CHANGE, i
                if stage == "simt" and cfg.optim.learning_rate_t == 0.0:
                    assert torch.equal(after["t1"], P_STAR) and torch.equal(after["t2"],
                                                                             P_STAR)
                elif stage == "simt":
                    for k in ("t1", "t2"):
                        assert _change_error(before, after, want0, want1, [k]) <= \
                            TOL_CHANGE, (i, k)
                return m
            return call
        return make

    monkeypatch.setattr(pn, "make_warmup_step", recording(pn.make_warmup_step))
    monkeypatch.setattr(pn, "make_simt_step", recording(pn.make_simt_step))
    args = pn.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--warmup-steps", str(WARM), "--train-steps",
         str(TRAIN), "--log-every", str(TRAIN), "--n-train", "2", "--n-val", "1", "--out",
         str(tmp_path / "out" / "planted.json")])
    lines = []
    res = pn.run(args, inits, print_fn=lines.append)
    assert done == list(range(len(jsteps))) == list(range(WARM + 4 * TRAIN))

    # Each SimT arm's last t_metrics: the tool's record and run.py's t_metrics.
    fx = pn.geometry(True)[0]
    last = [jsteps[WARM + TRAIN * (a + 2) - 1][3] for a in range(3)]
    for name, st, jend in zip(("verbatim", "paper", "oracle"), simt_states, last):
        got = pn.t_metrics(fx, st.t1.param, st.t2.param)
        for k, v in _jax_t_metrics(jfx, jend).items():
            assert got[k] == pytest.approx(v, abs=1e-5), (name, k)
            assert res["arms"][name][k] == round(got[k], 4), (name, k)
    assert res["arms"]["oracle"]["t_dist_known"] <= 1e-4

    # The JAX run's layout.
    assert set(res) == {"geometry", "teacher_routing", "platform", "arms", "warmup_traj",
                        "summary"}
    assert res["platform"] == "cpu" and list(res["arms"]) == ["ce", "verbatim", "paper",
                                                              "oracle"]
    assert set(res["warmup_traj"][0]) == {"step", "loss", "steps_per_sec",
                                          "train_clean_miou", "val_miou"}
    assert set(res["arms"]["oracle"]) == {
        "init", "traj", "step", "loss", "steps_per_sec", "train_clean_miou", "val_miou",
        "anchor_err_known", "t_dist_known", "t_attr_known", "t1_leak_10", *pn.SIMT_LOGGED,
        "anchor_on_class_frac", "anchor_teacher_conf_mean", "anchor_err_known_mean",
        "t1_diag_final"}
    assert set(res["summary"]) == {
        "oracle_val_minus_ce_val", "ce_train_minus_oracle_train", "paper_dTk_init_to_final",
        "verbatim_dTk_init_to_final", "verbatim_dAttrK_init_to_final",
        "paper_val_minus_verbatim_val"}
    assert os.path.exists(args.out) and any(s.startswith("summary:") for s in lines)


def test_refuses_to_write_the_tpu_record():
    args = pn.build_parser().parse_args(["--smoke", "--device", "cpu", "--out",
                                         pn.TPU_RECORD])
    with pytest.raises(SystemExit, match="TPU run's record"):
        pn.run(args, None)
