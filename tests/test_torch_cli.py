"""The port's ``python -m repro_torch`` commands and its on-disk formats
against the JAX package's, on the CPU.

- ``plan`` prints the same text as ``python -m repro plan``;
- ``sweep`` over a 2x2 grid serves every row from the cache on a rerun,
  and gives the same records and cache files whatever its thread count;
- ``trace --export chrome`` prints the same breakdown and gates and writes
  the same trace-event JSON as the JAX package's ``trace``;
- ``list`` names every preset (``elastic_axis`` included) and registry;
- ``core/ckpt/localfs`` files round-trip fp32 and bf16 leaves both ways
  between the packages.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.__main__ import main as jmain
from repro.core.ckpt import localfs as jfs
from repro_torch.__main__ import main
from repro_torch.core.ckpt import localfs as tfs


def _out(capsys, fn, argv) -> tuple[int, str]:
    rc = fn(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["lr_higgs"],
    ["mobilenet_cifar10"],
    ["lr_higgs", "--objective", "fastest"],
    ["mobilenet_cifar10", "--platforms", "faas,iaas,pod", "--mfu", "measured"],
    ["svm_rcv1", "--deadline-s", "300", "--workers", "1,5,50"],
    ["resnet50_cifar10", "--budget-usd", "0.001"],
    ["fig11_end2end"],
], ids=lambda a: "_".join(a))
def test_plan_prints_the_jax_packages_text(capsys, argv):
    rc, text = _out(capsys, main, ["plan", *argv, "--device", "cpu"])
    jrc, jtext = _out(capsys, jmain, ["plan", *argv])
    assert (rc, text) == (jrc, jtext)
    assert text.startswith("# plan for ")


def test_plan_picks_faas_for_lr_and_iaas_for_mobilenet(capsys):
    for target, want in (("lr_higgs", "faas"), ("mobilenet_cifar10", "iaas")):
        rc, text = _out(capsys, main, ["plan", target, "--device", "cpu"])
        pick = text.splitlines()[2]
        assert rc == 0 and want in pick and "<- pick" in pick


_GRID = ["fig8_sync", "--grid", "fleet.workers=2,4", "--grid", "sync=bsp,asp",
         "--set", "rows=3000", "--set", "max_epochs=1", "--device", "cpu"]


def test_sweep_rerun_is_served_from_the_cache(tmp_path, capsys):
    cache = ["--cache", str(tmp_path / "cache")]
    rc, first = _out(capsys, main, ["sweep", *_GRID, *cache])
    rows = [l for l in first.splitlines()[1:] if l.strip()]
    assert rc == 0 and len(rows) == 4
    assert not any("cached" in r for r in rows)
    rc, again = _out(capsys, main, ["sweep", *_GRID, *cache])
    rows2 = [l for l in again.splitlines()[1:] if l.strip()]
    assert rc == 0 and len(rows2) == 4
    assert all(r.rstrip().endswith("cached") for r in rows2)
    assert [r.split()[:6] for r in rows2] == [r.split()[:6] for r in rows]


@pytest.mark.parametrize("threads", [4, 8])
def test_sweep_records_do_not_depend_on_threads(tmp_path, threads):
    """The threads of a sweep share one device: the records and the cache
    files equal a one-thread sweep's (more threads than trials, too)."""
    import sys
    from repro_torch.experiments import get_preset, sweep
    base = get_preset("fig8_sync").base(True).with_(rows=3_000, max_epochs=1)
    grid = {"fleet.workers": [2, 3, 4], "sync": ["bsp", "asp", "ssp:1"]}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        many = sweep(base, grid, cache_dir=tmp_path / "many",
                     max_workers=threads, device="cpu")
    finally:
        sys.setswitchinterval(switch)
    one = sweep(base, grid, cache_dir=tmp_path / "one", device="cpu")
    assert [r.to_dict() for r in many] == [r.to_dict() for r in one]
    for r in one:
        name = f"{r.spec_hash}.json"
        assert (tmp_path / "many" / name).read_bytes() == \
            (tmp_path / "one" / name).read_bytes()


def test_trace_export_equals_the_jax_packages(tmp_path, capsys):
    argv = ["trace", "fig10_trace", "--quick", "--export", "chrome",
            "--set", "rows=6000"]
    rc, text = _out(capsys, main, [*argv, "--out", str(tmp_path / "t.json"),
                                   "--device", "cpu"])
    jrc, jtext = _out(capsys, jmain, [*argv, "--out",
                                      str(tmp_path / "j.json")])
    assert rc == jrc == 0 and text == jtext
    assert text.count("[OK  ]") == 3 * text.count("byte conservation") == 12
    files = sorted(tmp_path.glob("t.*.json"))
    assert len(files) == 4
    for f in files:
        got = json.loads(f.read_text())
        assert got == json.loads((tmp_path / f.name.replace("t.", "j.", 1))
                                 .read_text())
        assert got["traceEvents"] and got["otherData"]["spans"] > 0


def test_list_names_every_preset_and_registry(capsys):
    rc, text = _out(capsys, main, ["list", "--device", "cpu"])
    assert rc == 0
    from repro_torch.experiments import PRESETS
    for name in PRESETS:
        assert name in text
    assert "elastic_axis" in text
    jrc, jtext = _out(capsys, jmain, ["list"])
    heads = [l.split(" (")[0] for l in jtext.splitlines()
             if l and not l.startswith(" ") and "(" in l and "trial" not in l]
    for head in heads:
        if head not in ("arrival processes", "lint checkers"):
            assert head in text, head
    for line in ("static, schedule:<w@round,...>", "chrome, perfetto"):
        assert line in text and line in jtext


def _tree(rng):
    x32 = rng.standard_normal((3, 5)).astype(np.float32)
    b16 = rng.standard_normal((4, 7)).astype(np.float32)
    return x32, b16


def test_localfs_port_files_load_in_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    x32, b16 = _tree(rng)
    tree = {"params": {"w": torch.from_numpy(x32),
                       "h": torch.from_numpy(b16).to(torch.bfloat16)},
            "steps": [torch.tensor(3, dtype=torch.int32),
                      np.arange(4, dtype=np.int64)]}
    tfs.save(tmp_path, 7, tree, {"note": "port"})
    got, meta = jfs.load(tmp_path, 7)
    assert meta == {"note": "port", "step": 7}
    np.testing.assert_array_equal(got["params"]["w"], x32)
    assert got["params"]["h"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        got["params"]["h"].view(np.uint16),
        tree["params"]["h"].view(torch.int16).numpy().view(np.uint16))
    assert int(got["steps"][0]) == 3
    np.testing.assert_array_equal(got["steps"][1], np.arange(4))
    # and back through the port's own loader
    back, _ = tfs.load_latest(tmp_path)
    assert torch.equal(back["params"]["w"], tree["params"]["w"])
    assert back["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["h"], tree["params"]["h"])


def test_localfs_jax_files_load_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    x32, b16 = _tree(rng)
    jtree = {"a": jnp.asarray(x32), "b": [jnp.asarray(b16, jnp.bfloat16),
                                          jnp.asarray(x32[0])]}
    jfs.save(tmp_path / "j", 2, jtree)
    got, meta = tfs.load(tmp_path / "j", 2)
    assert meta == {"step": 2}
    assert torch.equal(got["a"], torch.from_numpy(x32))
    assert got["b"][0].dtype == torch.bfloat16
    want = np.asarray(jtree["b"][0]).view(np.uint16)
    np.testing.assert_array_equal(
        got["b"][0].view(torch.int16).numpy().view(np.uint16), want)
    assert torch.equal(got["b"][1], torch.from_numpy(x32[0]))
    # the port writes the same bytes back: same keys, dtypes and values
    tfs.save(tmp_path / "t", 2, got)
    with np.load(tmp_path / "j" / "step_0000000002.npz") as zj, \
            np.load(tmp_path / "t" / "step_0000000002.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype
            np.testing.assert_array_equal(zj[k], zt[k])


def test_localfs_retain_and_latest(tmp_path):
    for step in range(5):
        tfs.save(tmp_path, step, {"w": torch.full((2,), float(step))})
    tfs.retain(tmp_path, keep=2)
    assert tfs.list_steps(tmp_path) == jfs.list_steps(tmp_path) == [3, 4]
    latest, meta = tfs.load_latest(tmp_path)
    assert meta["step"] == 4 and torch.equal(latest["w"], torch.full((2,), 4.0))
    assert tfs.load_latest(tmp_path / "none") == (None, None)
