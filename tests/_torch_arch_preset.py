"""The tests of one architecture preset (quick) through the port on the CPU
against the JAX package, trial by trial, from the JAX package's initial
parameters carried across (``flat_from_numpy``): a real smollm-360m
(reduced) trained through the engine from bfloat16 parameters, the
config's own dtype (fp32 from the first merge on, in both packages).

Each ``test_torch_preset_<name>.py`` sets ``PRESET`` and imports this
module's tests and fixtures, so that the test workers (``--dist
loadfile``) give each preset's JAX runs a worker of their own.

Metered fields (rounds, simulated time, cost, comm bytes/time/cost,
breakdown, history timestamps) are EXACT.  Losses agree within
``ARCH_LOSS_RTOL``: the first gradients are bfloat16, rounded at other
places in the two frameworks, and later sums run in other orders
(measured at most 4.3e-6 over the 9 trials of both presets).  A control
run with the learning rate x ``CONTROL_LR``, on the preset's first trial
(BSP) and on its last (LocalSGD or DiLoCo), must miss it (measured 4e-4
to 5.6e-4).  (fp32 parity of the same gradient is held at 1e-5 in
``test_torch_workloads.py``.)  The port runs on one intra-op thread: its
reduced-model ops are tiny, and threads spinning against the other test
workers' made them a hundred times slower.
"""
import jax
import numpy as np
import pytest
import torch

from repro.experiments import get_preset as jget
from repro_torch.core.workloads import flat_from_numpy
from repro_torch.experiments import get_preset

ARCH_LOSS_RTOL = 5e-5
CONTROL_LR = 1.01


def _metered(res) -> dict:
    return {"system": res.system, "rounds": res.rounds,
            "sim_time": res.sim_time, "cost": res.cost,
            "comm_bytes": res.comm_bytes, "comm_time": res.comm_time,
            "comm_cost": res.comm_cost, "ckpt_bytes": res.ckpt_bytes,
            "preemptions": res.preemptions,
            "max_staleness": res.max_staleness, "breakdown": res.breakdown,
            "times": [t for t, _ in res.history], "error": res.error}


def _port(spec, tree, **over):
    spec = spec.with_(**over) if over else spec
    wl, algo, tr, va = spec.build_workload("cpu")
    flat = flat_from_numpy(tree, wl)
    wl.init = lambda gen: flat
    return spec.build_runtime().train(wl, algo, tr, va,
                                      max_epochs=spec.max_epochs,
                                      device="cpu")


def _losses(res) -> np.ndarray:
    return np.array([l for _, l in res.history])


def pytest_generate_tests(metafunc):
    if "spec" in metafunc.fixturenames:
        specs = get_preset(metafunc.module.PRESET).build(True)
        metafunc.parametrize("spec", specs, ids=[s.name for s in specs])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(request):
    out = {}
    for spec in jget(request.module.PRESET).build(True):
        wl, algo, tr, va = spec.build_workload()
        rt = spec.build_runtime()
        tree = jax.tree.map(np.asarray, wl.init(jax.random.key(rt.seed)))
        out[spec.name] = (tree, rt.train(wl, algo, tr, va,
                                         max_epochs=spec.max_epochs))
    return out


def test_quick_records_match_jax(spec, jax_runs):
    tree, jres = jax_runs[spec.name]
    res = _port(spec, tree)
    assert res.rounds > 0 and not res.error
    assert _metered(res) == _metered(jres)
    np.testing.assert_allclose(_losses(res), _losses(jres),
                               rtol=ARCH_LOSS_RTOL)


def test_a_changed_learning_rate_misses_the_tolerance(request, jax_runs):
    specs = get_preset(request.module.PRESET).build(True)
    assert specs[0].sync == "bsp" and specs[-1].sync != "bsp"
    for spec in (specs[0], specs[-1]):
        tree, jres = jax_runs[spec.name]
        lr = spec.algo_args["lr"] * CONTROL_LR
        res = _port(spec, tree, algo_args={**spec.algo_args, "lr": lr})
        rel = np.abs(_losses(res) - _losses(jres)) / np.abs(_losses(jres))
        assert rel.max() > ARCH_LOSS_RTOL, spec.name


def main() -> None:
    """Print each arch trial's largest relative loss gap, port vs JAX, at
    the preset's learning rate and at x CONTROL_LR: the readings behind
    ARCH_LOSS_RTOL (``PYTHONPATH=src python tests/_torch_arch_preset.py``)."""
    torch.set_num_threads(4)
    for preset in ("faas_vs_pod", "pod_local_sgd"):
        for jspec, spec in zip(jget(preset).build(True),
                               get_preset(preset).build(True)):
            wl, algo, tr, va = jspec.build_workload()
            rt = jspec.build_runtime()
            tree = jax.tree.map(np.asarray, wl.init(jax.random.key(rt.seed)))
            jl = _losses(rt.train(wl, algo, tr, va,
                                  max_epochs=jspec.max_epochs))
            gaps = []
            for f in (1.0, CONTROL_LR):
                lr = spec.algo_args["lr"] * f
                pl = _losses(_port(spec, tree,
                                   algo_args={**spec.algo_args, "lr": lr}))
                gaps.append(float((np.abs(pl - jl) / np.abs(jl)).max()))
            print(f"{preset} {spec.name} ({spec.sync}): gap {gaps[0]!r}, "
                  f"lr x{CONTROL_LR} {gaps[1]!r}", flush=True)


if __name__ == "__main__":
    main()
