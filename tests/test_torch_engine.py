"""The port's simulator training path as a whole, on ``device="cpu"``.

- The three pinned cases of ``tests/fixtures/trace_parity_pr9.json`` run
  through ``repro_torch.experiments.run_experiment``: every metered field
  (rounds, sim time, cost, comm/ckpt bytes, time and cost, breakdown,
  staleness, preemptions, history timestamps) EQUALS the fixture; losses
  agree to ``rtol=1e-5`` (fp32 sums in another order; the JAX package
  itself drifts about 1e-7 between processes).
- The three trace conservation gates hold exactly with ``trace=True``.
- FaaS and IaaS loss histories are bitwise equal within the port.
- Every LR trial of the ported study presets, cut to size, held against
  the JAX package in-process (platforms, channels, sync protocols, spot
  failures, checkpoint cadences, traces).
- A narrow MLP through the int8 and top-k codecs, held against the JAX
  package in-process from the same carried-over init.
"""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import algorithms as jalg
from repro.core import mlmodels as jmod
from repro.core import runtimes as jrt
from repro.data import synthetic as jdata
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import run_experiment as jrun
from repro_torch.core import algorithms as talg
from repro_torch.core import mlmodels as tmod
from repro_torch.core import runtimes as trt
from repro_torch.core.trace import assert_invariants
from repro_torch.data import synthetic as tdata
from repro_torch.experiments import ExperimentSpec, get_preset, run_experiment

FIXTURE = Path(__file__).parent / "fixtures" / "trace_parity_pr9.json"
CASES = json.loads(FIXTURE.read_text())["cases"]


def _metered(res) -> dict:
    return {"system": res.system, "rounds": res.rounds,
            "sim_time": res.sim_time, "cost": res.cost,
            "comm_bytes": res.comm_bytes, "comm_cost": res.comm_cost,
            "ckpt_bytes": res.ckpt_bytes, "ckpt_time": res.ckpt_time,
            "ckpt_cost": res.ckpt_cost, "preemptions": res.preemptions,
            "max_staleness": res.max_staleness, "breakdown": res.breakdown,
            "times": [t for t, _ in res.history],
            "scaling_timeline": [list(x) for x in res.scaling_timeline]}


def _run(spec: ExperimentSpec, trace: bool = False):
    model, algo, tr, va = spec.build_workload()
    return spec.build_runtime().train(model, algo, tr, va,
                                      max_epochs=spec.max_epochs,
                                      trace=trace, device="cpu")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["spec"]["name"])
def test_fixture_metered_fields_equal(case):
    rec = run_experiment(ExperimentSpec.from_dict(case["spec"]),
                         device="cpu")
    exp, got = case["result"], rec.result
    assert rec.device == "cpu"
    for key, rkey in [("system", "system"), ("rounds", "rounds"),
                      ("sim_time", "sim_time_s"), ("cost", "cost_usd"),
                      ("comm_bytes", "comm_bytes"),
                      ("comm_cost", "comm_cost_usd"),
                      ("ckpt_bytes", "ckpt_bytes"),
                      ("ckpt_time", "ckpt_time_s"),
                      ("ckpt_cost", "ckpt_cost_usd"),
                      ("preemptions", "preemptions"),
                      ("max_staleness", "max_staleness"),
                      ("breakdown", "breakdown"),
                      ("scaling_timeline", "scaling_timeline")]:
        assert got[rkey] == exp[key], key
    assert [t for t, _ in got["history"]] == [t for t, _ in exp["history"]]
    np.testing.assert_allclose([l for _, l in got["history"]],
                               [l for _, l in exp["history"]], rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["spec"]["name"])
def test_trace_gates_hold_and_perturb_nothing(case):
    spec = ExperimentSpec.from_dict(case["spec"])
    off, on = _run(spec), _run(spec, trace=True)
    inv = assert_invariants(on)
    assert inv["ok"]
    assert on.trace.meters == on.breakdown
    assert _metered(on) == _metered(off)
    assert [l for _, l in on.history] == [l for _, l in off.history]


@pytest.mark.parametrize("algo,kw", [
    ("ga_sgd", {"lr": 0.3, "batch_size": 256}),
    ("ma_sgd", {"lr": 0.3, "batch_size": 256}),
    ("admm", {"lr": 0.1, "batch_size": 256, "local_epochs": 2}),
])
def test_faas_and_iaas_losses_bitwise_equal(algo, kw):
    """DESIGN.md §1: same algorithm, same numerics, on both platforms (the
    allreduce-over-S3 and the NIC ring merge through one helper)."""
    base = {"rows": 2_000, "max_epochs": 2, "algorithm": algo,
            "algo_args": kw, "fleet": {"workers": 4}}
    faas = run_experiment(ExperimentSpec.from_dict(
        {**base, "platform": "faas"}), device="cpu")
    iaas = run_experiment(ExperimentSpec.from_dict(
        {**base, "platform": "iaas"}), device="cpu")
    assert [l for _, l in faas.history] == [l for _, l in iaas.history]
    assert [t for t, _ in faas.history] != [t for t, _ in iaas.history]


def test_localsgd_h1_is_bsp_bitwise():
    base = {"platform": "iaas", "rows": 2_000, "max_epochs": 2,
            "algo_args": {"lr": 0.3, "batch_size": 256},
            "fleet": {"workers": 3}}
    bsp = _run(ExperimentSpec.from_dict({**base, "sync": "bsp"}))
    loc = _run(ExperimentSpec.from_dict({**base, "sync": "local:1"}))
    assert bsp.history == loc.history


def _study_lr_trials():
    """Every LR trial of the ported study presets (the MobileNet trials run
    on the card in chip_smoke.py and through the codec test below)."""
    names = ("fig10_breakdown", "fig10_trace", "fig11_end2end", "fig8_sync",
             "spot_vs_ondemand", "spot_trace", "hetero_fleet")
    return [s for n in names for s in get_preset(n).build(True)
            if s.model == "lr"]


@pytest.mark.parametrize("spec", _study_lr_trials(), ids=lambda s: s.name)
def test_study_presets_match_jax(spec):
    """Each preset trial, cut to 1,000 rows and 2 epochs, through both
    packages' run_experiment: the whole record (trace section included)
    equals the JAX package's except the losses, held to 1e-5."""
    d = {**spec.to_dict(), "rows": 1_000, "max_epochs": 2}
    ref = jrun(JSpec.from_dict(d)).result
    got = run_experiment(ExperimentSpec.from_dict(d), device="cpu").result
    for key in ref:
        if key not in ("history", "final_loss"):
            assert got[key] == ref[key], key
    assert [t for t, _ in got["history"]] == [t for t, _ in ref["history"]]
    np.testing.assert_allclose([l for _, l in got["history"]],
                               [l for _, l in ref["history"]], rtol=1e-5)


@pytest.mark.parametrize("comm,loss_rtol", [
    ("s3/scatter_reduce/int8", 1e-4),
    ("s3/scatter_reduce/topk:0.01", 1e-4),
    ("s3/hierarchical/int8", 1e-4),
    ("nic/ring/fp32", 1e-5),
])
def test_narrow_mlp_codecs_match_jax(comm, loss_rtol):
    """A narrow MLP (12,742 parameters: 49 full quant blocks + a ragged
    tail) trained through the lossy codecs in both packages from the same
    init.  Metered fields are exact.  Loss tolerance: the gradients agree
    to a few fp32 ulps, and one ulp of input difference can move an int8
    code by one step (about 1% of a block's max) or swap which element
    clears the top-k threshold, so lossy-codec losses are held to 1e-4
    (measured: 2e-6 for int8, 1.4e-7 for top-k), the fp32 ring to 1e-5."""
    platform = "iaas" if comm.startswith("nic") else "faas"
    jds = jdata.make_dataset("higgs", rows=1_200, seed=0)
    tds = tdata.make_dataset("higgs", rows=1_200, seed=0)
    jtr, jva = jdata.train_val_split(jds)
    ttr, tva = tdata.train_val_split(tds)
    jm = jmod.make_mlp(jtr, target_mb=0.05, name="mlp")
    tm = tmod.make_mlp(ttr, target_mb=0.05, name="mlp")
    leaves = [np.asarray(x) for x in jax.tree.leaves(jm.init(jax.random.key(0)))]
    tm = dataclasses.replace(
        tm, init=lambda gen: tmod.params_from_numpy(tm, leaves))
    kw = {"lr": 0.1, "batch_size": 128}
    jcls = jrt.FaaSRuntime if platform == "faas" else jrt.IaaSRuntime
    tcls = trt.FaaSRuntime if platform == "faas" else trt.IaaSRuntime
    jres = jcls(workers=2, comm=comm).train(
        jm, jalg.make_algorithm("ga_sgd", **kw), jtr, jva, max_epochs=2)
    tres = tcls(workers=2, comm=comm).train(
        tm, talg.make_algorithm("ga_sgd", **kw), ttr, tva, max_epochs=2,
        device="cpu")
    assert tres.rounds == jres.rounds == 10
    assert _metered(tres) == _metered(jres)
    np.testing.assert_allclose([l for _, l in tres.history],
                               [l for _, l in jres.history], rtol=loss_rtol)


@pytest.mark.parametrize("case", CASES + [
    {"spec": s.to_dict()} for s in get_preset("comm_axis").build(True)
    + get_preset("elastic_axis").build(True)
    + get_preset("elastic_axis").build(False)] + [
    {"spec": {"name": "smlt", "scaling": "smlt"}},
    {"spec": {"name": "plan", "scaling": "plan:fastest"}}],
    ids=lambda c: c["spec"]["name"])
def test_spec_hash_equals_the_jax_package(case):
    """Same fields, defaults and HASH_SCHEMA: one spec, one cache key."""
    assert ExperimentSpec.from_dict(case["spec"]).spec_hash() == \
        JSpec.from_dict(case["spec"]).spec_hash()


@pytest.mark.parametrize("over,match", [
    ({"model": "smollm_360m", "dataset": "tokens"}, "queue A6"),
])
def test_unported_axes_raise_not_implemented(over, match):
    with pytest.raises(NotImplementedError, match=match):
        ExperimentSpec.from_dict(over)


def test_cli_run_on_cpu(tmp_path, capsys):
    from repro_torch.__main__ import main
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"name": "tiny", "rows": 500,
                                "max_epochs": 1, "fleet": {"workers": 2}}))
    out = tmp_path / "out.json"
    assert main(["run", str(spec), "--device", "cpu", "--cache",
                 str(tmp_path / "cache"), "--out", str(out)]) == 0
    assert "tiny" in capsys.readouterr().out
    rec = json.loads(out.read_text())[0]
    assert rec["device"] == "cpu" and rec["result"]["rounds"] > 0
    # a rerun on the same device is served from the cache
    assert main(["run", str(spec), "--device", "cpu", "--cache",
                 str(tmp_path / "cache")]) == 0
    assert "cached" in capsys.readouterr().out
