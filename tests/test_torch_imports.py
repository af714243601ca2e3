"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py``) import
neither ``jax`` nor anything of the JAX package ``repro``, and its entry
points run on the card unless the caller asks for the CPU."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

#: `import jax`, `from jax`, `import repro.`, `from repro.`, `from repro `
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\.|"
    r"from\s+repro\s|import\s+repro\s*$)", re.M)

_BLOCKED_RUN = """
import importlib, pkgutil, sys
import torch
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.experiments import ExperimentSpec, run_experiment
rec = run_experiment(ExperimentSpec(rows=400, max_epochs=1), device="cpu")
assert rec.result["rounds"] > 0 and not rec.result["error"], rec.result
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
model = build_model(get_reduced("smollm-360m"), device="cpu")
logits, cache = model.decode_step(model.init_cache(2, 4), [3, 5], 0)
assert logits.shape == (2, 256) and bool(logits.isfinite().all())
model = build_model(get_reduced("mamba2-370m"), device="cpu")
logits, _ = model.forward({"tokens": [[3, 5, 7]]})
assert logits.shape == (1, 3, 256) and bool(logits.isfinite().all())
from repro_torch.launch.specs import make_batch
from repro_torch.models.transformer import value_and_grad
from repro_torch.optim import make_optimizer
for name in ("hubert-xlarge", "llama-3.2-vision-90b"):
    arch = get_reduced(name)
    params = build_model(arch, device="cpu").params
    loss, grads = value_and_grad(
        params, make_batch(arch, 2, 5, device="cpu"), arch.model)
    opt = make_optimizer(arch.train)
    new, _, stats = opt.update(grads, opt.init(params), params)
    assert bool(stats["grad_norm"].isfinite()) and bool(loss.isfinite())
from repro_torch.launch.train import main as train_main
out = train_main(["--reduced", "--device", "cpu", "--mesh", "1x1",
                  "--steps", "2", "--seq", "8"])
assert len(out["losses"]) == 2 and all(x == x for x in out["losses"])
out = train_main(["--reduced", "--device", "cpu", "--mesh", "2x1x1",
                  "--algorithm", "diloco", "--compress", "--steps", "2",
                  "--seq", "8", "--sync-period", "1"])
assert len(out["pod_losses"]) == 2
from repro_torch import checkpoint
from repro_torch.distributed import local_sgd, sharding, step
assert checkpoint.PreemptionGuard(lifetime_s=0.0).should_checkpoint()
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print(len(names))
"""


def test_imports_and_runs_with_jax_and_repro_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n_modules = int(out.stdout.split()[-1])
    assert n_modules >= 30


@pytest.mark.parametrize("path", sorted(
    [p for p in PKG.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    assert not FORBIDDEN.findall(path.read_text()), path


def test_every_module_is_listed():
    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for sub in ("core.comm.codecs", "core.ckpt.store", "core.trace.record",
                "kernels.quant8.kernel", "kernels.topk_ef.kernel",
                "data.synthetic", "experiments.runner",
                "configs", "configs.base", "configs.smollm_360m",
                "models", "models.common", "models.attention",
                "models.transformer",
                "kernels.flash_attention.kernel",
                "kernels.flash_attention.ops", "kernels.flash_attention.ref",
                "kernels.decode_attention.kernel",
                "kernels.decode_attention.ops",
                "kernels.decode_attention.ref",
                "kernels.ssd_scan", "kernels.ssd_scan.kernel",
                "kernels.ssd_scan.ops", "kernels.ssd_scan.ref",
                "models.ssm", "configs.mamba2_370m", "configs.zamba2_2_7b",
                "serving", "serving.latency", "launch.serve",
                "core.analytical", "core.elastic", "core.elastic.policies",
                "core.elastic.planner", "core.elastic.telemetry",
                "core.trace.export", "core.ckpt.localfs", "core.faas",
                "core.iaas", "core.workloads", "data.tokens",
                "serving.arrivals", "serving.sim", "experiments.serving",
                "optim", "launch.specs", "checkpoint", "distributed",
                "distributed.sharding", "distributed.step",
                "distributed.local_sgd", "launch.mesh", "launch.train"):
        assert f"repro_torch.{sub}" in names


def _run_experiment():
    from repro_torch.experiments import ExperimentSpec, run_experiment
    run_experiment(ExperimentSpec(rows=400, max_epochs=1))


def _train():
    from repro_torch.core import FaaSRuntime, make_algorithm, make_study_model
    from repro_torch.data import make_dataset, train_val_split
    tr, va = train_val_split(make_dataset("higgs", rows=400))
    FaaSRuntime(workers=2).train(make_study_model("lr", tr),
                                 make_algorithm("ga_sgd"), tr, va)


def _cli():
    from repro_torch.__main__ import main
    main(["run", "fig10_breakdown", "--no-cache", "--set", "rows=400"])


def _cli_command(argv):
    def entry():
        from repro_torch.__main__ import main
        main(argv)
    return entry


def _sweep():
    from repro_torch.experiments import ExperimentSpec, sweep
    sweep(ExperimentSpec(rows=400, max_epochs=1),
          {"fleet.workers": [1, 2]})


def _estimate_epochs():
    from repro_torch.core import make_algorithm, make_study_model
    from repro_torch.core.analytical import estimate_epochs
    from repro_torch.data import make_dataset, train_val_split
    tr, _ = train_val_split(make_dataset("higgs", rows=400))
    estimate_epochs(make_study_model("lr", tr), make_algorithm("ga_sgd"),
                    tr, 0.5)


def _build_model():
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    build_model(get_reduced("smollm-360m"))


def _generator():
    from repro_torch.configs import get_reduced
    from repro_torch.serving import Generator
    Generator(get_reduced("smollm-360m"), max_seq=8)


def _make_batch():
    from repro_torch.configs import get_reduced
    from repro_torch.launch.specs import make_batch
    make_batch(get_reduced("hubert-xlarge"), 2, 4)


def _serve():
    from repro_torch.launch.serve import main
    main(["--reduced", "--requests", "1", "--new-tokens", "2"])


def _train_launcher():
    from repro_torch.launch.train import main
    main(["--reduced", "--mesh", "1x1", "--steps", "1"])


def _mesh():
    from repro_torch.launch.mesh import make_local_mesh
    make_local_mesh()


@pytest.mark.parametrize(
    "entry", [_run_experiment, _train, _cli, _build_model, _generator,
              _serve, _sweep, _estimate_epochs, _make_batch,
              _cli_command(["list"]), _cli_command(["plan", "lr_higgs"]),
              _cli_command(["sweep", "fig8_sync", "--no-cache", "--set",
                            "rows=400", "--grid", "sync=bsp,asp"]),
              _cli_command(["trace", "fig10_trace", "--set", "rows=400"]),
              _train_launcher, _mesh],
    ids=["run_experiment", "train", "cli", "build_model", "generator",
         "serve", "sweep", "estimate_epochs", "make_batch", "cli_list", "cli_plan",
         "cli_sweep", "cli_trace", "train_launcher", "mesh"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry, monkeypatch):
    """No silent CPU fallback: without CUDA and without device='cpu',
    every entry point raises and says how to ask for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
