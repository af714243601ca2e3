"""``python -m repro_torch.launch.train`` on the CPU (``--device cpu``).

- Against a JAX loop: reduced smollm-360m at the launcher's defaults (b 8,
  s 128, mesh 1x1), 6 steps from the JAX init carried across; the JAX
  side composes ``build_train_step`` on a 1x1 Auto-axis mesh, the JAX
  package's ``TokenStream`` and the same init (its own CLI cannot run
  here: ``jax.make_mesh`` gives Explicit axes under jax 0.9).  Losses
  within 1e-5 relative in fp32 (the config's dtype replaced) and
  ``BF16_LOSS_RTOL`` in the config's bf16.
- Resume: a run stopped at step 4 and resumed to 6 equals the
  uninterrupted 6-step run bit for bit, losses and parameters.
- The guard: a lifetime inside the margin fires on every step; it writes
  its checkpoints, and a resume from one of them equals the uninterrupted
  run.
- Checkpoints across the packages: one the JAX package writes (params,
  AdamW state, the stream's position) resumes in the port's launcher
  within the same tolerances of the JAX loop; one the port writes loads
  in the JAX package with equal bits and the JAX optimizer's tree.
- The fence (queue C 3), the local-SGD branch on ``--mesh 2x1x1``, and a
  mesh the world cannot hold.
"""
import shutil

import numpy as np
import pytest
import torch

import _torch_dist as td
from repro_torch.launch import train as launcher

STEPS = 6
B, S = 8, 128
FP32_RTOL = 1e-5
#: the same bf16 tolerance as the local-SGD parity test (see there: the
#: port's bf16 forward alone parts from the JAX model's by up to 1.24e-4)
BF16_LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_params(npp, dtype):
    from repro_torch.models import params_from_numpy
    return params_from_numpy(npp, td.port_arch("smollm-360m", dtype),
                             device="cpu").params


def _run(argv, params=None, dtype=None, monkeypatch=None):
    if dtype is not None:
        arch = td.port_arch("smollm-360m", dtype)
        monkeypatch.setattr(launcher, "get_reduced", lambda name: arch)
    return launcher.main(["--reduced", "--device", "cpu", "--mesh", "1x1",
                          "--log-every", "1", *argv], params=params)


def _jax_loop(dtype, steps, start=None):
    """The JAX loop: losses of ``steps`` steps, and the state after 4 (for
    the checkpoint test)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig
    from repro.data.tokens import TokenStream
    from repro.distributed.step import build_train_step
    from repro.optim import make_optimizer
    arch = td.jax_arch("smollm-360m", dtype)
    params, npp = td.jax_init(arch)
    mesh = td.jax_mesh((1, 1), ("data", "model"))
    step = build_train_step(arch, mesh, ShapeConfig("t", S, B, "train"))
    opt_state = make_optimizer(arch.train).init(params)
    stream = TokenStream(arch.model.vocab_size, seed=0)
    losses, at4 = [], None
    with mesh:
        for it in range(steps):
            if it == 4:         # host copies: the step donates its inputs
                at4 = (jax.device_get(params), jax.device_get(opt_state),
                       stream.state())
            bt = {k: jnp.asarray(v) for k, v in stream.batch(B, S).items()}
            params, opt_state, m = step.fn(params, opt_state, bt)
            losses.append(float(m["loss"]))
    return npp, losses, at4


@pytest.fixture(scope="module")
def jax_loops():
    return {d: _jax_loop(d, STEPS) for d in ("float32", "bfloat16")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launcher_matches_a_jax_loop(jax_loops, dtype, monkeypatch):
    npp, jl, _ = jax_loops[dtype]
    out = _run(["--steps", str(STEPS)], _port_params(npp, dtype), dtype,
               monkeypatch)
    rtol = FP32_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    np.testing.assert_allclose(out["losses"], jl, rtol=rtol, atol=0)


def _bits(a, b):
    for (path, x), (_, y) in zip(td.flat(td.numpy_tree(a)),
                                 td.flat(td.numpy_tree(b))):
        assert np.array_equal(x, y), path


def test_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    whole = _run(["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    first = _run(["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    second = _run(["--steps", "6", "--ckpt-dir", str(tmp_path / "b")])
    assert "resumed from step 4" in capsys.readouterr().out
    assert second["step0"] == 4
    assert first["losses"] + second["losses"] == whole["losses"]
    _bits(second["params"], whole["params"])
    _bits(second["opt"], whole["opt"])


def test_the_guard_checkpoints_and_its_checkpoint_resumes(tmp_path, capsys):
    from repro_torch import checkpoint as ckpt
    whole = _run(["--steps", "6"])
    d = tmp_path / "g"
    _run(["--steps", "6", "--lifetime", "0", "--ckpt-dir", str(d)])
    out = capsys.readouterr().out
    assert out.count("lifetime deadline -- checkpointed") == 6
    assert ckpt.list_steps(d) == [5, 6]
    again = tmp_path / "r"
    again.mkdir()
    for suffix in (".npz", ".json"):
        shutil.copy(d / f"step_0000000005{suffix}", again)
    resumed = _run(["--steps", "6", "--ckpt-dir", str(again)])
    assert resumed["step0"] == 5 and resumed["losses"] == whole["losses"][5:]
    _bits(resumed["params"], whole["params"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_jax_checkpoint_resumes_in_the_port(jax_loops, tmp_path, dtype,
                                              monkeypatch):
    from repro import checkpoint as jckpt
    npp, jl, (params, opt_state, stream) = jax_loops[dtype]
    jckpt.save(tmp_path, 4, {"params": params, "opt": opt_state},
               {"stream": stream})
    out = _run(["--steps", str(STEPS), "--ckpt-dir", str(tmp_path)],
               dtype=dtype, monkeypatch=monkeypatch)
    assert out["step0"] == 4 and len(out["losses"]) == 2
    rtol = FP32_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    np.testing.assert_allclose(out["losses"], jl[4:], rtol=rtol, atol=0)


def test_a_port_checkpoint_loads_in_the_jax_package(tmp_path):
    import jax
    from repro import checkpoint as jckpt
    from repro.optim import make_optimizer as jmake
    out = _run(["--steps", "2", "--ckpt-dir", str(tmp_path)])
    tree, meta = jckpt.load_latest(tmp_path)
    assert meta["step"] == 2 and meta["stream"]["position"] == 2 * B
    for part in ("params", "opt"):
        for (path, a), (_, b) in zip(td.flat(td.jax_numpy(tree[part])),
                                     td.flat(td.numpy_tree(out[part]))):
            assert np.array_equal(a, b), (part, path)
    jarch = td.jax_arch("smollm-360m")
    jparams, _ = td.jax_init(jarch)
    want = jax.tree.structure(jmake(jarch.train).init(jparams))
    assert jax.tree.structure(tree["opt"]) == want
    assert tree["params"]["embed"].dtype == jparams["embed"].dtype


def test_fence_local_sgd_branch_and_meshes(capsys):
    with pytest.raises(NotImplementedError, match="queue C 3"):
        launcher.main(["--arch", "mamba2-370m", "--reduced", "--device",
                       "cpu", "--mesh", "1x1", "--steps", "1"])
    out = launcher.main(["--reduced", "--device", "cpu", "--mesh", "2x1x1",
                         "--algorithm", "diloco", "--compress",
                         "--sync-period", "2", "--steps", "4", "--seq", "32"])
    assert "local_sgd=True" in capsys.readouterr().out
    assert len(out["pod_losses"]) == 4 and len(out["pod_losses"][0]) == 2
    assert out["outer"]["residual"]["embed"].shape[0] == 2
    with pytest.raises(ValueError, match="larger than the world"):
        launcher.main(["--reduced", "--device", "cpu", "--mesh", "1x2",
                       "--steps", "1"])
    with pytest.raises(ValueError, match="larger than the world"):
        launcher.main(["--reduced", "--device", "cpu", "--steps", "1"])
