"""The port's §5.3 analytic model and fleet planner against the JAX
package's, on the CPU.

The cost arithmetic is plain Python floats in the same order of
operations in both packages, so every time, dollar and ranked plan row is
held to exact ``==``.  ``estimate_epochs`` trains on a 10% sample; both
packages start LR from zeros, so they must count the same epochs.

Reference caveat, reproduced: ``faas_time(channel="elasticache")`` maps the
legacy alias for the transfer constants but not for the lease-rotation
restore, so once a run crosses a Lambda lease both packages raise the same
``KeyError``.
"""
import math

import numpy as np
import pytest

from repro.core import analytical as jan
from repro.core.algorithms import make_algorithm as jalgo
from repro.core.elastic import planner as jplanner
from repro.core.mlmodels import make_study_model as jmodel
from repro.data.synthetic import make_dataset as jdata
from repro.data.synthetic import train_val_split as jsplit
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import get_preset as jpreset
from repro_torch.core import analytical as tan
from repro_torch.core.algorithms import make_algorithm as talgo
from repro_torch.core.elastic import planner as tplanner
from repro_torch.core.mlmodels import make_study_model as tmodel
from repro_torch.data.synthetic import make_dataset as tdata
from repro_torch.data.synthetic import train_val_split as tsplit
from repro_torch.experiments import ExperimentSpec

WIDTHS = (1, 2, 5, 10, 25, 50, 100, 150, 200, 300, 7, 333)
#: (s, m, R, C): the paper workloads, a long FaaS run that crosses Lambda
#: leases, and a 1-byte model
INPUTS = [(w.s_bytes, w.m_bytes, w.R, w.C)
          for w in jplanner.PAPER_WORKLOADS.values()] + [
    (5e9, 40e6, 2000.0, 3000.0), (1.0, 1.0, 1.0, 0.001)]
CHANNELS = ("s3", "memcached", "memcached_large", "redis", "dynamodb",
            "elasticache")
CODECS = ("fp32", "int8", "topk:0.01", "topk:0.5")


def _outcome(fn, *args, **kw):
    """The value, or the exception's type and message."""
    try:
        return fn(*args, **kw)
    except KeyError as e:
        return ("raises", type(e), str(e))


def _pair(s, m, R, C):
    f = (lambda w: 1.0 + 0.01 * w)
    return (jan.CostInputs(s, m, R, C, f=f), tan.CostInputs(s, m, R, C, f=f))


def test_table6_is_the_jax_packages():
    assert tan.TABLE6 == jan.TABLE6


@pytest.mark.parametrize("inputs", INPUTS, ids=lambda i: f"m{i[1]:g}")
def test_times_and_costs_equal_exactly(inputs):
    jw, tw = _pair(*inputs)
    for w in WIDTHS:
        for ch in CHANNELS:
            for codec in CODECS:
                t = _outcome(tan.faas_time, tw, w, channel=ch, codec=codec)
                assert t == _outcome(jan.faas_time, jw, w, channel=ch,
                                     codec=codec)
                if isinstance(t, tuple):
                    continue
                for gb in (1.0, 3.0):
                    assert tan.faas_cost(tw, w, t, gb) == \
                        jan.faas_cost(jw, w, t, gb)
        for inst in ("t2.medium", "c5.large"):
            t = tan.iaas_time(tw, w, instance=inst)
            assert t == jan.iaas_time(jw, w, instance=inst)
            assert tan.iaas_cost(tw, w, t, inst) == jan.iaas_cost(jw, w, t, inst)
        for chips, mfu, codec in [(4, 0.4, "fp32"), (8, 0.25, "int8"),
                                  (4, "measured", "topk:0.01")]:
            t = tan.pod_time(tw, w, chips_per_pod=chips, mfu=mfu, codec=codec)
            assert t == jan.pod_time(jw, w, chips_per_pod=chips, mfu=mfu,
                                     codec=codec)
            assert tan.pod_cost(tw, w, t, chips) == jan.pod_cost(jw, w, t, chips)
        assert tan.hybridps_time(tw, w) == jan.hybridps_time(jw, w)
        assert tan.hybridps_time(tw, w, bandwidth=10e9, update_unit=0.0) == \
            jan.hybridps_time(jw, w, bandwidth=10e9, update_unit=0.0)
        assert tan.q1_fast_hybrid(tw, w) == jan.q1_fast_hybrid(jw, w)
        assert tan.q2_hot_data(tw, w) == jan.q2_hot_data(jw, w)


@pytest.mark.parametrize("codec", CODECS)
def test_wire_bytes_equal_exactly(codec):
    for m in (0.0, 1.0, 4.0, 1023.0, 16e3, 12e6, 89e6, 3_000_007 * 4.0):
        assert tan.wire_bytes(m, codec) == jan.wire_bytes(m, codec)


@pytest.mark.parametrize("platform", ["faas", "iaas", "pod"])
def test_restart_seconds_equal_exactly(platform):
    for m in (0.0, 16e3, 12e6, 89e6):
        for ckpt in (None, "s3", "memcached:sharded", "local:every=2"):
            for workers in (1, 4, 16):
                for ch in ("s3", "redis"):
                    assert tan.restart_seconds(
                        platform, m, ckpt=ckpt, channel=ch, workers=workers) \
                        == jan.restart_seconds(platform, m, ckpt=ckpt,
                                               channel=ch, workers=workers)


@pytest.mark.parametrize("model,dataset", [
    ("lr", "higgs"), ("svm", "rcv1"), ("kmeans", "higgs"),
    ("mobilenet", "cifar10")])
def test_cost_inputs_from_workload_equal(model, dataset):
    """s, m and C derived from the same study workload (R given)."""
    jds, tds = jdata(dataset, rows=600, seed=0), tdata(dataset, rows=600,
                                                       seed=0)
    jtr, _ = jsplit(jds)
    ttr, _ = tsplit(tds)
    j = jan.CostInputs.from_workload(jmodel(model, jtr), jtr, R=7)
    t = tan.CostInputs.from_workload(tmodel(model, ttr), ttr, R=7)
    assert (t.s_bytes, t.m_bytes, t.R, t.C) == (j.s_bytes, j.m_bytes, j.R, j.C)


@pytest.mark.parametrize("target", [0.66, 0.60, 0.55, 0.5, 0.3])
def test_estimate_epochs_equal(target):
    """The sampling estimator [54] on the same 10% LR/Higgs sample counts
    the same epochs (0.3 is never reached: both return max_epochs)."""
    jds, tds = jdata("higgs", rows=8_000, seed=0), tdata("higgs", rows=8_000,
                                                         seed=0)
    jtr, _ = jsplit(jds)
    ttr, _ = tsplit(tds)
    kw = {"lr": 0.2, "batch_size": 128}
    j = jan.estimate_epochs(jmodel("lr", jtr), jalgo("ga_sgd", **kw), jtr,
                            target, max_epochs=12)
    t = tan.estimate_epochs(tmodel("lr", ttr), talgo("ga_sgd", **kw), ttr,
                            target, max_epochs=12, device="cpu")
    assert t == j and float(t).is_integer()


def test_from_workload_estimates_r_on_the_device():
    tds = tdata("higgs", rows=4_000, seed=0)
    ttr, _ = tsplit(tds)
    jtr, _ = jsplit(jdata("higgs", rows=4_000, seed=0))
    kw = {"lr": 0.2, "batch_size": 128}
    t = tan.CostInputs.from_workload(tmodel("lr", ttr), ttr,
                                     algo=talgo("ga_sgd", **kw),
                                     target_loss=0.65, device="cpu")
    j = jan.CostInputs.from_workload(jmodel("lr", jtr), jtr,
                                     algo=jalgo("ga_sgd", **kw),
                                     target_loss=0.65)
    assert t.R == j.R
    with pytest.raises(ValueError, match="R="):
        tan.CostInputs.from_workload(tmodel("lr", ttr), ttr)


def _rows(options):
    return [(o.platform, o.workers, o.time_s, o.cost_usd, o.feasible, o.note)
            for o in options]


@pytest.mark.parametrize("objective", ["cheapest", "fastest"])
@pytest.mark.parametrize("workload", sorted(jplanner.PAPER_WORKLOADS))
def test_plan_rows_equal(workload, objective):
    assert _rows(tplanner.plan(workload, objective)) == \
        _rows(jplanner.plan(workload, objective))


@pytest.mark.parametrize("kw", [
    {"deadline_s": 500.0},
    {"deadline_s": math.inf},
    {"budget_usd": 0.05},
    {"budget_usd": 1e-6, "deadline_s": 2000.0},
    {"platforms": ("faas", "iaas", "pod"), "mfu": "measured"},
    {"platforms": ("pod",), "chips_per_pod": 8, "codec": "int8"},
    {"channel": "memcached", "codec": "topk:0.01", "gb": 1.0},
    {"instance": "c5.xlarge", "workers": (10, 20)},
], ids=lambda kw: ",".join(sorted(kw)))
@pytest.mark.parametrize("objective", ["cheapest", "fastest"])
def test_plan_constraints_equal(kw, objective):
    for workload in ("lr_higgs", "mobilenet_cifar10"):
        assert _rows(tplanner.plan(workload, objective, **kw)) == \
            _rows(jplanner.plan(workload, objective, **kw))


def test_planner_reproduces_paper_crossover():
    for objective in ("cheapest", "fastest"):
        assert tplanner.plan("lr_higgs", objective)[0].platform == "faas"
        assert tplanner.plan("mobilenet_cifar10",
                             objective)[0].platform == "iaas"
    with pytest.raises(KeyError, match="unknown planner workload"):
        tplanner.plan("gpt17_800t", "cheapest")
    with pytest.raises(ValueError, match="objective"):
        tplanner.plan("lr_higgs", "best_vibes")


@pytest.mark.parametrize("spec", jpreset("elastic_axis").build(True)[:2]
                         + jpreset("comm_axis").build(True)[:1],
                         ids=lambda s: s.name)
def test_plan_of_a_spec_equal(spec):
    """A spec target derives (s, m, C) from its workload, R = max_epochs."""
    d = spec.to_dict()
    assert _rows(tplanner.plan(ExperimentSpec.from_dict(d))) == \
        _rows(jplanner.plan(JSpec.from_dict(d)))


@pytest.mark.parametrize("scaling", ["plan", "plan:fastest"])
@pytest.mark.parametrize("platform", ["faas", "iaas"])
def test_plan_scaling_picks_the_same_initial_fleet(platform, scaling):
    d = {"rows": 3_000, "max_epochs": 2, "scaling": scaling,
         "platform": platform, "fleet": {"workers": 4, "max_workers": 25}}
    trt = ExperimentSpec.from_dict(d).build_runtime()
    jrt = JSpec.from_dict(d).build_runtime()
    assert trt.scaling == "static" == jrt.scaling
    assert trt.workers == jrt.workers and 1 <= trt.workers <= 25
    np.testing.assert_array_equal(trt.fleet.gb_array(), jrt.fleet.gb_array())
