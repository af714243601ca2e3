"""The port's serving simulator (``repro_torch.serving.{arrivals,sim}``,
``repro_torch.experiments.serving``, the platforms' ``serving_hooks``)
against the JAX package's, on the CPU.  Both are numpy, with the same
``+=`` accumulation order, so results are EQUAL, not close:

- every arrival process draws the same instants for the same seed;
- every platform's ``ServingHooks`` are the same constants;
- ``serve`` gives the same result dict and trace spans on every platform,
  arrival shape and autoscaler, and ``frontier()`` the same rows;
- ``ServingSpec`` hashes are equal (one cache key in both packages);
- ``python -m repro_torch serve`` and ``list`` print the JAX package's
  text (``list`` apart from the lint checkers, ROADMAP.md queue A9).
"""
import dataclasses

import numpy as np
import pytest

from repro.__main__ import main as jmain
from repro.core import runtimes as jrt
from repro.experiments import serving as jserving
from repro.serving import arrivals as jarrivals
from repro.serving import sim as jsim
from repro_torch.__main__ import main as tmain
from repro_torch.core import runtimes as trt
from repro_torch.experiments import serving as tserving
from repro_torch.serving import arrivals as tarrivals
from repro_torch.serving import sim as tsim

ARRIVALS = ["poisson:0.005", "poisson:5", "flash:0.05,10,60,30",
            "flash:0.1,2,60,240", "diurnal:0.5@0,4@12,1@20,day=300",
            "poisson:2"]


def _platforms(pkg):
    return {"faas": pkg.FaaSRuntime(workers=8, lambda_gb=3.0),
            "iaas": pkg.IaaSRuntime(workers=2),
            "iaas_gpu": pkg.IaaSRuntime(workers=2, instance="g4dn.xlarge"),
            "pod": pkg.PodPlatform(pods=1)}


@pytest.mark.parametrize("arrival", ARRIVALS)
def test_arrival_times_equal_jax(arrival, tmp_path):
    j, t = jarrivals.make_arrivals(arrival), tarrivals.make_arrivals(arrival)
    for seed in (0, 3):
        np.testing.assert_array_equal(t.times(300.0, seed),
                                      j.times(300.0, seed))
    assert (t.name, t.peak_qps) == (j.name, j.peak_qps)
    for x in (0.0, 59.0, 61.0, 250.0):
        assert t.rate(x) == j.rate(x)
    trace = tmp_path / "arrivals.txt"
    trace.write_text("\n".join(str(x) for x in j.times(120.0, 1)))
    spec = f"trace:{trace}"
    np.testing.assert_array_equal(
        tarrivals.make_arrivals(spec).times(100.0, 0),
        jarrivals.make_arrivals(spec).times(100.0, 0))


def test_arrival_registry_equals_jax():
    assert tarrivals.list_arrivals() == jarrivals.list_arrivals()
    for bad in ("nope:1", "poisson:-1", "flash:1"):
        with pytest.raises((KeyError, ValueError)):
            jarrivals.make_arrivals(bad)
        with pytest.raises((KeyError, ValueError)):
            tarrivals.make_arrivals(bad)


@pytest.mark.parametrize("platform", ["faas", "iaas", "iaas_gpu", "pod"])
def test_serving_hooks_equal_jax(platform):
    j = _platforms(jrt)[platform].serving_hooks()
    t = _platforms(trt)[platform].serving_hooks()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.cold_start_total_s(7.2e8) == j.cold_start_total_s(7.2e8)
    assert t.provision_s(5) == j.provision_s(5)


@pytest.mark.parametrize("platform", ["faas", "iaas", "iaas_gpu", "pod"])
@pytest.mark.parametrize("arrival,scaling,prewarm", [
    ("poisson:2", None, 0),
    ("flash:0.1,2,60,240", "smlt", 0),
    ("flash:0.05,10,60,30", "schedule:1@0,4@4", 2),
    ("poisson:5", "cost_cap:0.05", 0),
])
def test_serve_results_equal_jax(platform, arrival, scaling, prewarm):
    kw = dict(duration_s=300.0, scaling=scaling, prewarm=prewarm,
              max_batch=16, seed=1, trace=True)
    j = jsim.serve(_platforms(jrt)[platform], "smollm_360m", arrival, **kw)
    t = tsim.serve(_platforms(trt)[platform], "smollm_360m", arrival, **kw)
    assert t.to_dict() == j.to_dict()
    assert t.latencies == j.latencies and t.cost == j.cost
    assert ([(s.kind, s.t0, s.t1) for s in t.trace.spans]
            == [(s.kind, s.t0, s.t1) for s in j.trace.spans])


@pytest.mark.parametrize("reduced,duration", [(False, 300.0), (True, 120.0)])
def test_frontier_rows_equal_jax(reduced, duration):
    j = jserving.frontier(reduced=reduced, duration_s=duration)
    t = tserving.frontier(reduced=reduced, duration_s=duration)
    assert [r.to_dict() for r in t] == [r.to_dict() for r in j]
    assert len(t) == 9


@pytest.mark.parametrize("over", [
    {}, {"platform": "iaas", "fleet": {"workers": 3}},
    {"arrival": "flash:0.1,2,60,240", "scaling": "smlt", "platform": "pod"},
    {"reduced": True, "duration_s": 60.0, "prewarm": 2},
    {"name": "label only"},
])
def test_serving_spec_hash_equals_jax(over):
    t = tserving.ServingSpec.from_dict(over)
    assert t.spec_hash() == jserving.ServingSpec.from_dict(over).spec_hash()
    assert tserving.ServingSpec.from_json(t.to_json()) == t


def test_serving_spec_rejections_match_jax():
    for bad in ({"model": "lr"}, {"platform": "gpu"},
                {"arrival": "nope:1"}, {"scaling": "plan"},
                {"platform_args": {"mfu": 0.5}}):
        with pytest.raises(ValueError):
            jserving.ServingSpec.from_dict(bad)
        with pytest.raises(ValueError):
            tserving.ServingSpec.from_dict(bad)


def test_run_serving_caches(tmp_path):
    spec = tserving.ServingSpec(name="a", arrival="poisson:0.5",
                                duration_s=60.0)
    first = tserving.run_serving(spec, cache_dir=tmp_path)
    again = tserving.run_serving(spec.with_(name="b"), cache_dir=tmp_path)
    assert not first.cached and again.cached and again.spec.name == "b"
    assert again.result == first.result
    assert (tmp_path / f"serve_{spec.spec_hash()}.json").exists()


def _out(capsys, fn, argv):
    rc = fn(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["serve", "--grid", "--no-cache"],
    ["serve", "--arrival", "flash:0.1,2,60,240", "--duration-s", "600",
     "--set", "platform=iaas", "--set", "fleet.workers=2", "--set",
     "fleet.max_workers=32", "--set", "scaling=smlt", "--no-cache"],
    ["serve", "--reduced", "--arrival", "poisson:0.5", "--duration-s", "60",
     "--no-cache"],
], ids=["grid", "smlt", "reduced"])
def test_serve_prints_the_jax_packages_text(capsys, argv):
    rc, text = _out(capsys, tmain, [*argv, "--device", "cpu"])
    jrc, jtext = _out(capsys, jmain, argv)
    assert (rc, text) == (jrc, jtext)


def _sections(text: str) -> list:
    """The ``list`` text as blank-line separated sections, without the
    lint checkers' (queue A9), with the tool's name and framework made
    neutral."""
    text = text.replace("repro_torch", "repro").replace("PyTorch", "JAX")
    return [s for s in text.split("\n\n") if "lint checkers" not in s]


def test_list_prints_the_jax_packages_text(capsys):
    rc, text = _out(capsys, tmain, ["list", "--device", "cpu"])
    jrc, jtext = _out(capsys, jmain, ["list"])
    assert rc == jrc == 0
    assert _sections(text) == _sections(jtext)
    assert "arrival processes" in text and "faas_vs_pod" in text
