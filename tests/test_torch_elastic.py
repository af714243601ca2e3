"""Elastic fleets (DESIGN.md §13) in the port, on the CPU, held against the
JAX package.

- The 5 ``elastic_axis`` trials through both packages' ``run_experiment``:
  every metered field, ``scaling_timeline`` included, is exactly equal;
  losses agree within 1e-5.
- A narrow MLP through ``s3/scatter_reduce/int8`` under a resize: after
  the scale-up the codec starts fresh error-feedback state at the new
  width.  Metered fields exact, losses within 1e-4 (the codec tolerance of
  ``test_torch_engine.test_narrow_mlp_codecs_match_jax``).
- The port's counterparts of ``tests/test_elastic.py``, each run through
  both packages from the same arguments where the result is a run.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import algorithms as jalg
from repro.core import elastic as jel
from repro.core import mlmodels as jmod
from repro.core import runtimes as jrt
from repro.core.platform import CommSpec as JCommSpec
from repro.core.platform import FleetSpec as JFleetSpec
from repro.data import synthetic as jdata
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import get_preset as jpreset
from repro.experiments import run_experiment as jrun
from repro_torch.core import algorithms as talg
from repro_torch.core import mlmodels as tmod
from repro_torch.core import runtimes as trt
from repro_torch.core.elastic import (
    CostCapPolicy, SchedulePolicy, ScalingPolicy, SMLTPolicy, StaticPolicy,
    Telemetry, build_controller, make_policy,
)
from repro_torch.core.platform import CommSpec, FleetSpec
from repro_torch.core.sync import SyncProtocol
from repro_torch.core.trace import assert_invariants
from repro_torch.data import synthetic as tdata
from repro_torch.experiments import ExperimentSpec, run_experiment

LOSS_RTOL = 1e-5


def _metered(res) -> dict:
    return {"system": res.system, "workers": res.workers,
            "rounds": res.rounds, "sim_time": res.sim_time, "cost": res.cost,
            "comm_bytes": res.comm_bytes, "comm_cost": res.comm_cost,
            "ckpt_bytes": res.ckpt_bytes, "ckpt_time": res.ckpt_time,
            "ckpt_cost": res.ckpt_cost, "preemptions": res.preemptions,
            "max_staleness": res.max_staleness, "breakdown": res.breakdown,
            "error": res.error, "times": [t for t, _ in res.history],
            "scaling_timeline": [tuple(x) for x in res.scaling_timeline]}


def _losses(res) -> list:
    return [float(l) for _, l in res.history]


def _assert_matches(tres, jres, rtol=LOSS_RTOL):
    assert _metered(tres) == _metered(jres)
    np.testing.assert_allclose(_losses(tres), _losses(jres), rtol=rtol)


@pytest.fixture(scope="module")
def workload():
    """The LR/Higgs workload of tests/test_elastic.py, built by both
    packages from byte-identical data."""
    out = {}
    for name, data, mod, alg in (("jax", jdata, jmod, jalg),
                                 ("torch", tdata, tmod, talg)):
        tr, va = data.train_val_split(data.make_dataset("higgs", rows=4_000,
                                                        seed=0))
        out[name] = (mod.make_study_model("lr", tr),
                     alg.make_algorithm("ga_sgd", lr=0.2, batch_size=512),
                     tr, va)
    return out


_CLASSES = {"faas": (jrt.FaaSRuntime, trt.FaaSRuntime),
            "iaas": (jrt.IaaSRuntime, trt.IaaSRuntime),
            "pod": (jrt.PodPlatform, trt.PodPlatform)}


def _train(workload, platform, kw=None, jkw=None, tkw=None, **train_kw):
    """One run in each package from the same constructor arguments
    (``jkw``/``tkw`` add package-specific ones, e.g. spec objects)."""
    jcls, tcls = _CLASSES[platform]
    jm, ja, jtr, jva = workload["jax"]
    tm, ta, ttr, tva = workload["torch"]
    jres = jcls(**(kw or {}), **(jkw or {})).train(jm, ja, jtr, jva,
                                                    **train_kw)
    tres = tcls(**(kw or {}), **(tkw or {})).train(tm, ta, ttr, tva,
                                                    device="cpu", **train_kw)
    return tres, jres


def _widths(res) -> list:
    return [w for _r, w, _s, _c in res.scaling_timeline]


# ------------------------------------------------ whole runs vs the JAX ----

@pytest.mark.parametrize("spec", jpreset("elastic_axis").build(True),
                         ids=lambda s: s.name)
def test_elastic_axis_matches_jax(spec):
    d = spec.to_dict()
    ref = jrun(JSpec.from_dict(d)).result
    got = run_experiment(ExperimentSpec.from_dict(d), device="cpu").result
    for key in ref:
        if key not in ("history", "final_loss"):
            assert got[key] == ref[key], key
    assert [t for t, _ in got["history"]] == [t for t, _ in ref["history"]]
    np.testing.assert_allclose([l for _, l in got["history"]],
                               [l for _, l in ref["history"]], rtol=LOSS_RTOL)


@pytest.mark.parametrize("comm,sync", [
    ("s3/scatter_reduce/int8", "bsp"),
    ("s3/allreduce/fp32", "local:2:c8"),
])
def test_narrow_mlp_codec_resize_matches_jax(comm, sync):
    """A narrow MLP (12,742 parameters: 49 full quant blocks + a ragged
    tail) through a lossy codec while the fleet grows from 2 to 4 at
    round 3: the rebuilt stack starts fresh codec state at the new width
    (a leftover residual would index past the old fleet or shift the
    losses).  Same init carried over from the JAX package.  The top-k
    codec is not held here: at 4 workers its losses leave 1e-4 even on a
    fixed fleet (1.05e-3 measured), since one ulp of input difference can
    swap which element clears the threshold."""
    jds = jdata.make_dataset("higgs", rows=1_200, seed=0)
    tds = tdata.make_dataset("higgs", rows=1_200, seed=0)
    jtr, jva = jdata.train_val_split(jds)
    ttr, tva = tdata.train_val_split(tds)
    jm = jmod.make_mlp(jtr, target_mb=0.05, name="mlp")
    tm = tmod.make_mlp(ttr, target_mb=0.05, name="mlp")
    leaves = [np.asarray(x)
              for x in jax.tree.leaves(jm.init(jax.random.key(0)))]
    tm = dataclasses.replace(
        tm, init=lambda gen: tmod.params_from_numpy(tm, leaves))
    kw = {"lr": 0.1, "batch_size": 128}
    args = dict(workers=2, comm=comm, sync=sync,
                scaling="schedule:2@0,4@3")
    jres = jrt.FaaSRuntime(**args).train(
        jm, jalg.make_algorithm("ga_sgd", **kw), jtr, jva, max_epochs=3)
    tres = trt.FaaSRuntime(**args).train(
        tm, talg.make_algorithm("ga_sgd", **kw), ttr, tva, max_epochs=3,
        device="cpu")
    assert _widths(tres) == [2, 4]
    _assert_matches(tres, jres, rtol=1e-4)


@pytest.mark.parametrize("platform,sync,scaling", [
    ("faas", "local:2", "schedule:4@0,2@2,6@5"),
    ("iaas", "diloco:2:c8", "schedule:2@0,4@2"),
    ("pod", "bsp", "schedule:3@0,1@2,4@4"),
    ("faas", "ssp:1", "smlt"),
    ("iaas", "asp", "schedule:4@0,2@1"),
    ("faas", "bsp", "cost_cap:0.002"),
], ids=lambda x: str(x))
def test_protocols_and_platforms_resize_like_jax(workload, platform, sync,
                                                 scaling):
    """Every resizing protocol (BSP, SSP/ASP, LocalSGD/DiLoCo with int8
    deltas) on every platform."""
    kw = ({"pods": 3} if platform == "pod" else {"workers": 4})
    tres, jres = _train(workload, platform, dict(kw, sync=sync,
                                                 scaling=scaling),
                        max_epochs=6)
    assert not tres.error
    _assert_matches(tres, jres)


@pytest.mark.parametrize("platform", ["faas", "iaas"])
def test_traced_resizes_conserve_and_match_jax(workload, platform):
    """With the span recorder on, resizes tile the clocks exactly, the
    telemetry reads the recorder's meters and ledger, and every metered
    field (trace section aside) equals both the untraced run's and the
    JAX package's."""
    kw = dict(workers=4, scaling="smlt", sync="ssp:2"
              if platform == "faas" else "bsp")
    tres, jres = _train(workload, platform, kw, max_epochs=5, trace=True)
    assert assert_invariants(tres)["ok"]
    _assert_matches(tres, jres)
    off, _ = _train(workload, platform, kw, max_epochs=5)
    assert _metered(off) == _metered(tres)
    assert _losses(off) == _losses(tres)
    assert [m["kind"] for m in tres.trace.marks].count("resize") == \
        len(tres.scaling_timeline) - 1


# --------------------------------- counterparts of tests/test_elastic.py ---

@pytest.mark.parametrize("platform", ["faas", "iaas", "pod"])
def test_static_parity_pinned_on_all_platforms(workload, platform):
    kw = {"pods": 3} if platform == "pod" else {"workers": 3}
    base, jbase = _train(workload, platform, kw, max_epochs=2)
    static, _ = _train(workload, platform, dict(kw, scaling="static"),
                       max_epochs=2)
    pinned, jpinned = _train(workload, platform,
                             dict(kw, scaling="schedule:3@0"), max_epochs=2)
    assert base.scaling_timeline == [] == static.scaling_timeline
    assert pinned.scaling_timeline == [(0, 3, 0.0, 0.0)]
    for other in (static, pinned):
        assert other.history == base.history
        assert _metered(other) | {"scaling_timeline": []} == \
            _metered(base) | {"scaling_timeline": []}
    _assert_matches(base, jbase)
    _assert_matches(pinned, jpinned)


def test_static_policy_builds_no_controller():
    assert build_controller("static", FleetSpec()) is None
    assert build_controller(StaticPolicy(), FleetSpec()) is None
    assert build_controller("smlt", FleetSpec()) is not None
    assert isinstance(SchedulePolicy.parse("2@0,8@5"), ScalingPolicy)


def test_schedule_resize_under_injected_preemption(workload):
    """A retired worker takes its scripted kill with it: the joiners get
    fresh ids, so the kill never fires -- while on a fixed fleet it does."""
    sched = "schedule:4@0,2@1,4@6"
    dry, jdry = _train(workload, "faas", dict(workers=4, scaling=sched),
                       max_epochs=10)
    assert _widths(dry)[:3] == [4, 2, 4]
    up = dry.scaling_timeline[2]
    assert up[2] > 0.0 and up[3] > 0.0
    _assert_matches(dry, jdry)
    t_kill = dry.sim_time + 1.0
    fixed, jfixed = _train(workload, "faas",
                           dict(workers=4, preempt_at=((3, t_kill),)),
                           max_epochs=10)
    assert fixed.preemptions == 1
    _assert_matches(fixed, jfixed)
    elastic, _ = _train(workload, "faas",
                        dict(workers=4, scaling=sched,
                             preempt_at=((3, t_kill),)), max_epochs=10)
    assert elastic.preemptions == 0 and elastic.workers == 4
    assert elastic.history == dry.history


def test_resize_budget_rescales_epochs(workload):
    static, _ = _train(workload, "faas", {"workers": 4}, max_epochs=6)
    shrunk, jshrunk = _train(workload, "faas",
                             dict(workers=4, scaling="schedule:2@2"),
                             max_epochs=6)
    assert shrunk.rounds > static.rounds
    assert shrunk.scaling_timeline[-1][1] == 2
    _assert_matches(shrunk, jshrunk)


@pytest.mark.parametrize("spot", [False, True])
def test_iaas_retired_worker_billing(workload, spot):
    """A scale-down bills the retired VMs' usage once: the elastic run
    costs less than the same fixed fleet, and exactly what the JAX package
    bills."""
    fixed, _ = _train(workload, "iaas", dict(workers=4, spot=spot),
                      max_epochs=4)
    down, jdown = _train(workload, "iaas",
                         dict(workers=4, spot=spot, scaling="schedule:2@1"),
                         max_epochs=4)
    assert not down.error
    assert down.cost < fixed.cost
    _assert_matches(down, jdown)


def test_ssp_membership_reconciliation(workload):
    res, jres = _train(workload, "faas",
                       dict(workers=4, sync="ssp:2",
                            scaling="schedule:4@0,2@1"), max_epochs=4)
    assert not res.error and res.rounds > 0
    assert 2 in _widths(res)
    assert res.max_staleness <= 2
    _assert_matches(res, jres)


def test_ssp_scale_up_does_not_oscillate(workload):
    res, jres = _train(workload, "faas",
                       dict(workers=2, sync="ssp:2",
                            scaling="schedule:2@0,8@5"), max_epochs=6)
    assert not res.error
    rounds_seq = [r for r, _w, _s, _c in res.scaling_timeline]
    assert rounds_seq == sorted(rounds_seq)
    assert _widths(res) == [2, 8]
    _assert_matches(res, jres)


def test_resize_skipped_when_transport_item_limit_would_break():
    """A scale-down whose scatter-reduce chunk would bust DynamoDB's 400 KB
    item limit is skipped instead of aborting the run.  The k-means
    centroids start from the JAX package's random init in both."""
    out = {}
    leaves = None
    for name, data, mod, alg, rt, comm, fleet in (
            ("jax", jdata, jmod, jalg, jrt, JCommSpec, JFleetSpec),
            ("torch", tdata, tmod, talg, trt, CommSpec, FleetSpec)):
        tr, va = data.train_val_split(data.make_dataset("higgs", rows=8_000,
                                                        seed=0))
        model = mod.make_study_model("kmeans", tr, k=3_500)
        kw = {}
        if name == "jax":
            leaves = [np.asarray(x)
                      for x in jax.tree.leaves(model.init(jax.random.key(0)))]
        else:
            kw = {"device": "cpu"}
            model = dataclasses.replace(
                model, init=lambda gen, m=model: tmod.params_from_numpy(
                    m, leaves))
        out[name] = rt.FaaSRuntime(
            workers=2, scaling="schedule:1@1",
            fleet=fleet(workers=2, min_workers=1),
            comm=comm(channel="dynamodb", pattern="scatter_reduce")).train(
            model, alg.make_algorithm("kmeans_em"), tr, va, max_epochs=3,
            **kw)
    res = out["torch"]
    assert not res.error and res.workers == 2
    assert all(w == 2 for w in _widths(res))
    _assert_matches(res, out["jax"])


def test_smlt_survives_sparse_eval_cadence(workload):
    r1, _ = _train(workload, "faas", dict(workers=4, scaling="smlt"),
                   max_epochs=4, eval_every=1)
    r2, j2 = _train(workload, "faas", dict(workers=4, scaling="smlt"),
                    max_epochs=4, eval_every=2)
    assert max(_widths(r1)) == max(_widths(r2))
    assert all(w >= 2 for w in _widths(r2))
    _assert_matches(r2, j2)


def test_elastic_train_is_repeatable(workload):
    tm, ta, ttr, tva = workload["torch"]
    rt = trt.FaaSRuntime(workers=4, scaling="schedule:2@3")
    r1 = rt.train(tm, ta, ttr, tva, max_epochs=3, device="cpu")
    r2 = rt.train(tm, ta, ttr, tva, max_epochs=3, device="cpu")
    assert rt.workers == 4
    assert r1.history == r2.history
    assert r1.scaling_timeline == r2.scaling_timeline


def test_schedule_widths_validated_at_spec_time():
    kw = dict(model="kmeans", model_args={"k": 3_500},
              algorithm="kmeans_em", rows=8_000,
              comm=CommSpec(channel="dynamodb", pattern="scatter_reduce"),
              fleet=FleetSpec(workers=2, min_workers=1))
    ExperimentSpec(**kw)
    with pytest.raises(ValueError, match="dynamodb"):
        ExperimentSpec(scaling="schedule:1@0", **kw)


def test_elastic_rejects_unsupported_pairings():
    with pytest.raises(ValueError, match="homogeneous"):
        build_controller("smlt", FleetSpec(workers=2, lambda_gb=(3.0, 1.0)))
    with pytest.raises(ValueError, match="<workers>@<round>"):
        make_policy("schedule:oops")
    with pytest.raises(KeyError, match="unknown scaling policy"):
        make_policy("warp9")
    with pytest.raises(ValueError, match="spec level"):
        make_policy("plan")
    with pytest.raises(ValueError):
        FleetSpec(workers=4, max_workers=2)
    with pytest.raises(ValueError, match="faas/iaas"):
        ExperimentSpec(platform="pod", scaling="plan")


def test_cost_cap_stop_is_recorded(workload):
    policy, jpolicy = CostCapPolicy(1e-4), jel.CostCapPolicy(1e-4)
    res, jres = _train(workload, "faas", {"workers": 4},
                       jkw={"scaling": jpolicy}, tkw={"scaling": policy},
                       max_epochs=6)
    assert res.scaling_timeline[-1][1] == 0
    assert res.cost <= 1e-4 + policy.max_round_spend + 1e-12
    assert policy.max_round_spend == jpolicy.max_round_spend
    _assert_matches(res, jres)


@pytest.mark.parametrize("budget,workers", [
    (1e-5, 2), (3e-4, 3), (1e-3, 4), (4e-3, 6), (2e-2, 5)])
def test_cost_cap_never_overshoots_by_more_than_one_round(workload, budget,
                                                          workers):
    """Total $ <= budget + one round's spend, at budgets from below one
    round to above the whole run."""
    policy = CostCapPolicy(budget)
    tm, ta, ttr, tva = workload["torch"]
    res = trt.FaaSRuntime(workers=workers, scaling=policy,
                          fleet=FleetSpec(workers=workers,
                                          min_workers=1)).train(
        tm, ta, ttr, tva, max_epochs=4, device="cpu")
    assert res.cost <= budget + policy.max_round_spend + 1e-12


def test_smlt_widens_then_narrows():
    pol = SMLTPolicy(factor=2)

    def tel(rnd, w, delta, rt=1.0):
        return Telemetry(round=rnd, workers=w, loss=1.0, loss_delta=delta,
                         round_time=rt, comm_share=0.2, cost_so_far=0.0,
                         sim_time=10.0, min_workers=1, max_workers=64)

    assert pol.observe(tel(1, 4, 0.10)) == 8
    assert pol.observe(tel(2, 8, 0.25)) == 16
    assert pol.observe(tel(3, 16, 0.20)) == 8
    assert pol.observe(tel(4, 8, 0.20)) == 8
    assert pol.observe(tel(5, 8, 0.01)) == 4


def test_spec_round_trip_and_hash_with_scaling():
    d = {"name": "el", "rows": 3_000, "max_epochs": 2,
         "scaling": "schedule:2@0,6@3",
         "fleet": {"workers": 4, "min_workers": 2, "max_workers": 8}}
    spec = ExperimentSpec.from_dict(d)
    assert ExperimentSpec.from_json(spec.to_json()) == spec
    assert spec.spec_hash() != spec.with_(scaling="static").spec_hash()
    assert spec.spec_hash() == JSpec.from_dict(d).spec_hash()


def test_resizeless_protocol_refuses_elastic_policies(workload):
    class FrozenProto(SyncProtocol):
        name = "frozen"

        def run(self, ctx):               # pragma: no cover - never reached
            raise AssertionError

    tm, ta, ttr, tva = workload["torch"]
    with pytest.raises(ValueError, match="supports_resize"):
        trt.FaaSRuntime(workers=2, sync=FrozenProto(), scaling="smlt").train(
            tm, ta, ttr, tva, max_epochs=1, device="cpu")


def test_run_experiment_records_scaling_timeline(tmp_path):
    import json
    from pathlib import Path
    d = {"name": "tl", "rows": 3_000, "max_epochs": 4,
         "scaling": "schedule:2@0,4@2",
         "fleet": {"workers": 2, "max_workers": 8}}
    rec = run_experiment(ExperimentSpec.from_dict(d), cache_dir=tmp_path,
                         device="cpu")
    tl = rec.result["scaling_timeline"]
    assert [w for _r, w, _s, _c in tl][:2] == [2, 4]
    assert json.loads(Path(rec.path).read_text())["result"][
        "scaling_timeline"] == tl
    assert tl == jrun(JSpec.from_dict(d)).result["scaling_timeline"]
