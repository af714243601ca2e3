"""The tests of one architecture preset (quick) through the port on the CPU
against the JAX package, trial by trial, from the JAX package's initial
parameters carried across (``flat_from_numpy``): a real smollm-360m
(reduced) trained through the engine from bfloat16 parameters, the
config's own dtype (fp32 from the first merge on, in both packages).

Each ``test_torch_preset_<name>.py`` sets ``PRESET`` (and, to train
another zoo model through the same trials, ``MODEL``: the presets' model
override, in both packages; ``DTYPE`` replaces the reduced config's
dtype in both) and imports this module's tests and fixtures, so that the
test workers (``--dist loadfile``) give each preset's JAX runs a worker
of their own.

Metered fields (rounds, simulated time, cost, comm bytes/time/cost,
breakdown, history timestamps) are EXACT.  Losses agree within
``ARCH_LOSS_RTOL``: the first gradients are bfloat16, rounded at other
places in the two frameworks, and later sums run in other orders
(measured at most 4.3e-6 over the 9 trials of both presets).  A control
run with the learning rate x ``CONTROL_LR``, on the preset's first trial
(BSP) and on its last (LocalSGD or DiLoCo), must miss it (measured 4e-4
to 5.6e-4).  With ``MODEL`` mamba2-370m the losses are held at
``MODEL_LOSS_RTOL``.  zamba2-2.7b (reduced) runs in fp32 (``DTYPE``),
held at ``ARCH_LOSS_RTOL`` (measured at most 6.4e-7; its controls 1.09e-3
to 1.89e-3).  In bf16 its losses part by 1.55e-4 to 4.33e-4 between the
two frameworks over the 9 trials, above ``ARCH_LOSS_RTOL``, while lr
x1.01 controls read 8.4e-4 to 2.05e-3 (``main("zamba2_2_7b",
"bfloat16")``, with the port's attention rounding where the JAX
``_sdpa`` rounds; before that repair the gaps reached 5.6e-4 against a
7.4e-4 control), so its presets stay fp32.  The MoE family runs fp32 too
(``test_torch_preset_*_{deepseek,grok}.py``): in bf16 the reduced
deepseek-v2-lite-16b parts from JAX by up to 1.36e-3 (lr x1.01 controls
5.6e-4 to 4.35e-3) and grok-1-314b by up to 1.52e-4 (controls 6.3e-4 to
1.24e-3), a router's near-tie gates going the other way on a bf16
rounding; in fp32 they read at most 7.04e-7 (deepseek; controls 5.5e-4 to
5.96e-3) and 5.96e-7 (grok; controls 5.1e-4 to 1.13e-3), held at
``ARCH_LOSS_RTOL`` (``main(model, dtype)``).  No layer computes another
function (``_torch_bf16_witness.py``): given the same inputs, the two
frameworks' norms, GEMMs, convolutions and attention agree to the last
bit or one ulp, and their blocks part by rounding.  XLA on the CPU
expands a bf16 ``silu`` into five steps and rounds after each one, which
moves 41% of its outputs by an ulp from PyTorch's fp32-computed
``silu``.  One zamba2 gradient's loss gap reads 1.62e-4 (3.1e-4 before
the attention repair), norm-wise 3.21e-2; with the XLA ``silu`` mimicked
in the port, 7.4e-5 and 1.92e-2.  smollm-360m's bf16 trials read at most
6.76e-6 after the attention repair (4.28e-6 before it; controls 4.0e-4
to 5.5e-4), one gradient's loss gap 1.43e-5 (1.00e-4 before).  (fp32
parity of the same gradient is held at 1e-5 in
``test_torch_workloads.py``.)  The port runs
on one intra-op thread: its reduced-model ops are tiny, and threads
spinning against the other test workers' made them a hundred times
slower.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.experiments import get_preset as jget
from repro_torch.core import workloads as tworkloads
from repro_torch.core.workloads import flat_from_numpy
from repro_torch.experiments import get_preset

ARCH_LOSS_RTOL = 5e-5
#: the same with mamba2-370m (reduced, bf16) through the trials: its SSD
#: layers round to bf16 at other places in the two frameworks too
#: (measured at most 5.23e-5 over the 9 trials; the controls 1.25e-3 to
#: 1.36e-3)
MODEL_LOSS_RTOL = {("mamba2_370m", None): 1e-4}
CONTROL_LR = 1.01


def _metered(res) -> dict:
    return {"system": res.system, "rounds": res.rounds,
            "sim_time": res.sim_time, "cost": res.cost,
            "comm_bytes": res.comm_bytes, "comm_time": res.comm_time,
            "comm_cost": res.comm_cost, "ckpt_bytes": res.ckpt_bytes,
            "preemptions": res.preemptions,
            "max_staleness": res.max_staleness, "breakdown": res.breakdown,
            "times": [t for t, _ in res.history], "error": res.error}


def _specs(get, preset, model=None):
    """The preset's quick trials, each training ``model`` if given."""
    specs = get(preset).build(True)
    return [s.with_(model=model) for s in specs] if model else specs


def _rtol(module) -> float:
    return MODEL_LOSS_RTOL.get(
        (getattr(module, "MODEL", None), getattr(module, "DTYPE", None)),
        ARCH_LOSS_RTOL)


def _with_dtype(mp, dtype) -> None:
    """The reduced configs' dtype replaced by ``dtype`` in both packages
    (None: the configs' own)."""
    if dtype is None:
        return
    for module in (jconfigs, tworkloads):
        get = module.get_reduced

        def get_reduced(name, get=get):
            arch = get(name)
            return arch.replace(model=arch.model.replace(dtype=dtype))
        mp.setattr(module, "get_reduced", get_reduced)


def _port(spec, tree, **over):
    spec = spec.with_(**over) if over else spec
    wl, algo, tr, va = spec.build_workload()
    flat = flat_from_numpy(tree, wl)
    wl.init = lambda gen: flat
    return spec.build_runtime().train(wl, algo, tr, va,
                                      max_epochs=spec.max_epochs,
                                      device="cpu")


def _losses(res) -> np.ndarray:
    return np.array([l for _, l in res.history])


def pytest_generate_tests(metafunc):
    if "spec" in metafunc.fixturenames:
        specs = _specs(get_preset, metafunc.module.PRESET,
                       getattr(metafunc.module, "MODEL", None))
        metafunc.parametrize("spec", specs, ids=[s.name for s in specs])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def model_dtype(request):
    """The module's ``DTYPE``, if it sets one, in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        _with_dtype(mp, getattr(request.module, "DTYPE", None))
        yield


@pytest.fixture(scope="module")
def jax_runs(request):
    out = {}
    for spec in _specs(jget, request.module.PRESET,
                       getattr(request.module, "MODEL", None)):
        wl, algo, tr, va = spec.build_workload()
        rt = spec.build_runtime()
        tree = jax.tree.map(np.asarray, wl.init(jax.random.key(rt.seed)))
        out[spec.name] = (tree, rt.train(wl, algo, tr, va,
                                         max_epochs=spec.max_epochs))
    return out


def test_quick_records_match_jax(request, spec, jax_runs):
    tree, jres = jax_runs[spec.name]
    res = _port(spec, tree)
    assert res.rounds > 0 and not res.error
    assert _metered(res) == _metered(jres)
    np.testing.assert_allclose(_losses(res), _losses(jres),
                               rtol=_rtol(request.module))


def test_a_changed_learning_rate_misses_the_tolerance(request, jax_runs):
    specs = _specs(get_preset, request.module.PRESET,
                   getattr(request.module, "MODEL", None))
    assert specs[0].sync == "bsp" and specs[-1].sync != "bsp"
    for spec in (specs[0], specs[-1]):
        tree, jres = jax_runs[spec.name]
        lr = spec.algo_args["lr"] * CONTROL_LR
        res = _port(spec, tree, algo_args={**spec.algo_args, "lr": lr})
        rel = np.abs(_losses(res) - _losses(jres)) / np.abs(_losses(jres))
        assert rel.max() > _rtol(request.module), spec.name


def main(model=None, dtype=None) -> None:
    """Print each arch trial's largest relative loss gap, port vs JAX, at
    the preset's learning rate and at x CONTROL_LR: the readings behind
    ARCH_LOSS_RTOL (``PYTHONPATH=src python tests/_torch_arch_preset.py
    [model [dtype]]``)."""
    torch.set_num_threads(4)
    with pytest.MonkeyPatch.context() as mp:
        _with_dtype(mp, dtype)
        _main(model)


def _main(model) -> None:
    for preset in ("faas_vs_pod", "pod_local_sgd"):
        for jspec, spec in zip(_specs(jget, preset, model),
                               _specs(get_preset, preset, model)):
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
    import sys
    main(*sys.argv[1:])
