"""chip_smoke.py's own checks of the MoE family's routes and of the served
decode steps, on the CPU at the reduced configs.

- ``Routes.hold_bf16``: a bf16 run that takes another run's experts holds
  each forced expert's router logit within ROUTE_BF16_ULPS bf16 ulps (at
  the token's largest |logit|) of the largest logit outside the forced
  set.  A run forced with its own routes reads 0 ulps; the planted wrong
  route of ``_route_control_bf16`` (every token's K-th expert of the first
  MoE layer moved half the experts on) must read far beyond the limit.
- ``bf16_ulp`` is the spacing of bf16 values: the gap to the next bf16
  value up, exactly.
- ``_StepLogits`` keeps the logits of the decode steps that made a
  Generator's tokens; they equal, bit for bit, the same steps replayed on
  a fresh cache (``_card_step_logits``), which is what the serving checks
  held before.
- Phases 3k and 3l: the vlm cut's parameter counts, the exact launch
  counts of every family (``_attention_layers``, ``_want_launches``,
  ``_want_train_launches``), the teacher-forced decode steps against the
  forward (``_teacher_forced``), the port's ``value_and_grad`` against
  ``loss.backward``, ``_ulps``, the counter-built parameters the card and
  the CPU share (``_counter_params``: their law, their sample, chunk- and
  order-free values), the staged comparison of a card tree with a host
  tree (``_staged_gaps``), and the optimizer arithmetic swapped for a
  timing and put back (``_optim_arith``).
- Phase 3m: the launcher's config cut in depth within
  ``_launcher_layers`` and put back after it, ``_trees_bit_equal`` (paths
  and bits), and the launches a launcher run makes per step.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.workloads import ArchWorkload
from repro_torch.models import build_model
from repro_torch.serving import Generator

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _bf16_deepseek():
    wl = chip_smoke._with_dtype(
        ArchWorkload("deepseek_v2_lite_16b", reduced=True), "bfloat16")
    params32 = ArchWorkload("deepseek_v2_lite_16b", reduced=True).init(
        torch.Generator().manual_seed(0))
    return wl, params32


def test_bf16_routes_forced_from_their_own_run_hold():
    wl, params32 = _bf16_deepseek()
    batch = chip_smoke._full_batch(wl)
    with chip_smoke.Routes() as run:
        wl.grad(params32.to(wl.dtype), batch)
    routes = [r.clone() for r in run.records]
    with chip_smoke.Routes(force=routes) as forced:
        wl.grad(params32.to(wl.dtype), batch)
    forced.hold_bf16("self-forced")
    reading = forced.reading()
    assert reading["moved_tokens"] == 0, reading
    assert reading["least_bf16_ulps"] == 0.0, reading


def test_bf16_route_control_misses_the_bound():
    wl, params32 = _bf16_deepseek()
    with chip_smoke.Routes() as run:
        wl.grad(params32.to(wl.dtype), chip_smoke._full_batch(wl))
    out = chip_smoke._route_control_bf16(wl, params32, run.records)
    assert out["least_bf16_ulps"] < -10 * chip_smoke.ROUTE_BF16_ULPS, out


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
def test_bf16_ulp_is_the_gap_to_the_next_bf16_value(scale):
    x = (torch.from_numpy(np.random.default_rng(3).standard_normal(4096))
         .float() * scale).bfloat16()
    up = torch.nextafter(x.abs(), torch.tensor(float("inf"),
                                               dtype=torch.bfloat16))
    gap = (up.float() - x.abs().float())
    assert torch.equal(chip_smoke.bf16_ulp(x.float()), gap)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_step_logits_equal_the_replayed_steps(monkeypatch, temperature):
    kept = torch.empty
    # pinned host memory needs a card; its values do not depend on it
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **k: kept(*a, **k))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    arch = get_reduced("smollm-360m")
    model = build_model(arch, device="cpu", seed=0)
    gen = Generator(arch, model, max_seq=40, device="cpu")
    prompts = np.random.default_rng(5).integers(
        0, arch.model.vocab_size, (2, 8)).astype(np.int32)
    rec = chip_smoke._StepLogits(gen, 2, 8 + 6)
    out = gen.generate(prompts, max_new_tokens=6, temperature=temperature,
                       seed=1)
    rec.stop()
    assert "_decode" not in vars(gen)
    got = rec.logits(8 + 6 - 1)
    ref = chip_smoke._card_step_logits(model, torch.from_numpy(out).long(),
                                       40)
    assert torch.equal(got, ref)


# ------------------------------------------------------ phases 3k and 3l ----

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402


@pytest.mark.parametrize("groups,want", [(1, 6_379_626_496),
                                         (chip_smoke.VLM_GROUPS,
                                          10_657_898_496)])
def test_vlm_cut_parameter_counts(groups, want):
    """3k's cut: the first group (25.5 GB in fp32) and the first
    VLM_GROUPS groups (42.6 GB) at full width."""
    cfg = get_arch(chip_smoke.VLM).model
    cut = cfg.replace(num_layers=groups * cfg.cross_attn_every)
    assert param_count(tfm.model_spec(cut)) == want
    assert 4 * want / 1e9 < 80                 # fits the card in fp32


def test_hubert_fits_the_card_at_full_depth():
    cfg = get_arch(chip_smoke.HUBERT).model
    assert param_count(tfm.model_spec(cfg)) == 944_487_680
    assert cfg.num_layers == 48


@pytest.mark.parametrize("name,attn", [
    ("smollm-360m", 32), ("deepseek-v2-lite-16b", 27), ("mamba2-370m", 0),
    ("zamba2-2.7b", 9), ("llama-3.2-vision-90b", 100),
    ("hubert-xlarge", 48)])
def test_attention_layers_of_every_family(name, attn):
    assert chip_smoke._attention_layers(get_arch(name).model) == attn


def test_vlm_and_encoder_launch_formulas():
    """3k: one flash launch per layer (4 self + 1 cross per group) per
    forward, one decode launch per layer per step (the cross attention
    through the decode kernel at length T), one backward per layer per
    gradient; 3l: the encoder's 48 layers, no decode."""
    cfg = get_arch(chip_smoke.VLM).model
    cut = cfg.replace(num_layers=chip_smoke.VLM_GROUPS * 5)
    assert chip_smoke._want_launches(cut, 32, 1) == {
        "flash_attention": 10, "decode_attention": 320, "ssd_scan": 0}
    group = cfg.replace(num_layers=5)
    assert chip_smoke._want_train_launches(group, grads=1, evals=0) == {
        "flash_attention": 5, "flash_attention_bwd": 5, "ssd_scan": 0,
        "ssd_scan_bwd": 0, "quantize8_ef": 0}
    enc = get_arch(chip_smoke.HUBERT).model
    assert chip_smoke._want_train_launches(enc, grads=2, evals=1) == {
        "flash_attention": 144, "flash_attention_bwd": 96, "ssd_scan": 0,
        "ssd_scan_bwd": 0, "quantize8_ef": 0}


def _reduced_vlm():
    arch = get_reduced(chip_smoke.VLM)
    arch = arch.replace(model=arch.model.replace(dtype="float32"))
    return arch, build_model(arch, device="cpu", seed=0)


def test_teacher_forced_steps_equal_the_forward():
    from repro_torch.launch.specs import make_batch
    arch, model = _reduced_vlm()
    batch = make_batch(arch, 2, 6, seed=2, device="cpu")
    steps = chip_smoke._teacher_forced(model, batch["tokens"],
                                       batch["image_embeds"], 6)
    fwd = model.forward(batch)[0]
    assert steps.shape == fwd.shape
    assert float((steps - fwd).abs().max()) < 1e-5
    zero = chip_smoke._teacher_forced(model, batch["tokens"], None, 6)
    fwd0 = model.forward(dict(batch, image_embeds=torch.zeros_like(
        batch["image_embeds"])))[0]
    assert float((zero - fwd0).abs().max()) < 1e-5
    assert float((zero - fwd).abs().max()) > 1e-3


def test_tree_grad_is_autograd_of_the_loss():
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.common import tree_leaves
    arch = get_reduced(chip_smoke.HUBERT)
    arch = arch.replace(model=arch.model.replace(dtype="float32"))
    model = build_model(arch, device="cpu", seed=1)
    batch = make_batch(arch, 2, 8, seed=3, device="cpu")
    loss, grads = tfm.value_and_grad(model.params, batch, arch.model)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(model.params)]
    it = iter(leaves)
    params = chip_smoke._paths(model.params)
    tree = {}
    for path, _t in params:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = next(it)
    ref, _ = tfm.loss_fn(tree, batch, arch.model)
    ref.backward()
    assert torch.equal(loss, ref.detach())
    for (_p, g), leaf in zip(chip_smoke._paths(grads), leaves):
        assert torch.equal(g, leaf.grad)


def test_ulps_reads_the_spacing_of_the_largest_value():
    ref = torch.tensor([3.0, -1.0, 0.5])
    step = torch.finfo(torch.float32).eps * 2.0          # spacing at 3.0
    assert chip_smoke._ulps(ref, ref) == 0.0
    assert chip_smoke._ulps(ref + torch.tensor([0.0, step, 0.0]), ref) == 1.0
    assert chip_smoke._ulps(torch.zeros(2), torch.zeros(2)) == 0.0


def test_flash_in_situ_keeps_only_its_own_threads_calls():
    """3k (f) holds its gradient's attention calls in situ: only the
    entering thread's calls are kept (another thread may run the same
    model meanwhile), each with its output's gradient."""
    import threading
    from repro_torch.launch.specs import make_batch
    arch, model = _reduced_vlm()
    batch = make_batch(arch, 2, 6, seed=4, device="cpu")
    with chip_smoke._flash_in_situ() as situ:
        other = threading.Thread(target=lambda: model.forward(batch))
        other.start()
        other.join()
        tfm.value_and_grad(model.params, batch, arch.model)
    assert len(situ.calls) == arch.model.num_layers
    assert all("do" in call for call in situ.calls)
    assert [call["causal"] for call in situ.calls] == [True, False] * (
        arch.model.num_layers // 2)


def test_staged_gaps_equal_the_direct_comparison(monkeypatch):
    """3k (f)'s comparison of the card's gradient with the host's, run
    here on host tensors with a 7-element stage: the same per-leaf gaps as
    :func:`_tree_gaps`, leaf names and zero leaves included."""
    kept = torch.empty
    # pinned host memory needs a card; the staged values do not
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **k: kept(*a, **k))
    monkeypatch.setattr(chip_smoke, "STAGE_CHUNK", 7)
    gen = torch.Generator().manual_seed(0)
    ref = {"a": torch.randn(5, 9, generator=gen),
           "b": {"c": torch.randn(3, generator=gen), "d": torch.zeros(4)}}
    got = {"a": ref["a"] + 1e-3 * torch.randn(5, 9, generator=gen),
           "b": {"c": ref["b"]["c"].clone(), "d": torch.zeros(4)}}
    staged = chip_smoke._staged_gaps(got, ref)
    assert staged == pytest.approx(chip_smoke._tree_gaps(got, ref), rel=0,
                                   abs=0)
    assert list(staged) == ["a", "b/c", "b/d"]
    assert staged["a"] > 0 and staged["b/c"] == 0.0 == staged["b/d"]


@pytest.mark.parametrize("name", ["hubert-xlarge", "llama-3.2-vision-90b"])
def test_counter_params_follow_the_zoo_init_law(name, monkeypatch):
    """The parameters 3k and 3l build alike on the card and the host: the
    spec's shapes, ones for norm scales, every other leaf uniform within
    COUNTER_HALF_WIDTH x its scale with the zoo's truncated normal's
    variance, and the same values on every call."""
    from repro_torch.models.common import is_spec, tree_leaves
    monkeypatch.setattr(chip_smoke, "COUNTER_POOL", 2 ** 20)
    arch = get_reduced(name)
    cfg = arch.model.replace(dtype="float32")
    params = chip_smoke._counter_params(cfg, "cpu")
    again = chip_smoke._counter_params(cfg, "cpu")
    specs = tree_leaves(tfm.model_spec(cfg), is_spec)
    leaves = tree_leaves(params)
    assert len(specs) == len(leaves)
    for (shape, _axes, scale), leaf, same in zip(specs, leaves,
                                                 tree_leaves(again)):
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.float32
        assert torch.equal(leaf, same)
        if scale == 1.0 and len(shape) == 1:
            assert bool((leaf == 1).all())
            continue
        bound = chip_smoke.COUNTER_HALF_WIDTH * scale
        assert float(leaf.abs().max()) <= bound * (1 + 2 ** -20)
        # no pool value is 0: every element, a leaf's tail too, is filled
        assert bool((leaf != 0).all()), shape
        if leaf.numel() >= 4096:
            var = float(leaf.double().var()) / scale ** 2
            assert abs(var - 0.773741) < 0.05, (shape, var)
    assert chip_smoke._counter_sample(params) == chip_smoke._counter_sample(
        again)


def test_counter_params_are_a_function_of_the_seed_and_the_leaf():
    """Another seed moves every leaf, and two leaves of one shape and
    scale differ."""
    cfg = get_reduced("llama-3.2-vision-90b").model.replace(dtype="float32")
    a = chip_smoke._counter_params(cfg, "cpu", seed=0)
    b = chip_smoke._counter_params(cfg, "cpu", seed=1)
    attn = a["blocks"]["self"]["attn"]
    assert not torch.equal(attn["wq"], b["blocks"]["self"]["attn"]["wq"])
    assert attn["wk"].shape == attn["wv"].shape
    assert not torch.equal(attn["wk"], attn["wv"])
    assert chip_smoke._counter_sample(a) != chip_smoke._counter_sample(b)


def test_counter_hash_stays_in_32_bits_below_overflow():
    """The hash's products stay below 2^63 at the largest counter a leaf
    of the vlm's first group reaches (its 1.88e9-element stacked MLP
    leaves), so int64 arithmetic gives the same bits on every device."""
    top = 2 * 4 * 8192 * 28672
    x = chip_smoke._counter_hash(top - 4, 4, 0xFFFFFFFF, "cpu")
    assert bool((x >= 0).all()) and bool((x < 2 ** 32).all())
    assert (top * 0x6F4F2A35 + 0xFFFFFFFF) < 2 ** 63
    assert (2 ** 32 - 1) * max(0x7FEB352D, 0x4B3B8E35) < 2 ** 63


def test_optim_arith_swaps_and_restores_the_update_arithmetic():
    """The timing of 3l swaps the optimizers' fused multiply-add and
    square root for plain fp32 ones and puts the port's back; on the CPU
    the plain sum a * b + c is rounded twice, the port's once."""
    from repro_torch import optim
    kept = optim._fma, optim._sqrt
    a = 1.0 - 2.0 ** -23
    b = torch.tensor([1.0 + 2.0 ** -22])
    c = torch.tensor([-1.0])
    with chip_smoke._optim_arith(*chip_smoke.PLAIN_FP32):
        assert optim._fma is chip_smoke._plain_fma
        plain = optim._fma(a, b, c)
    with chip_smoke._optim_arith(*chip_smoke._float64_route()):
        assert optim._fma is optim._fma64
        route = optim._fma(a, b, c)
    assert (optim._fma, optim._sqrt) == kept
    port = optim._fma(a, b, c)
    exact = (a * (1.0 + 2.0 ** -22)) - 1.0
    assert float(port) == pytest.approx(exact, rel=2 ** -24)
    assert torch.equal(port, route)
    assert float(plain) != float(port)


def test_launcher_layers_cuts_depth_and_puts_the_lookup_back():
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launcher
    before = launcher.get_arch
    with chip_smoke._launcher_layers(2):
        cut = launcher.get_arch("smollm-360m")
        assert cut.model.num_layers == 2
        assert cut.model.replace(num_layers=32) == \
            get_arch("smollm-360m").model
    assert launcher.get_arch is before


def test_trees_bit_equal_reads_paths_and_bits():
    a = {"x": torch.tensor([1.0, -0.0]), "y": {"z": torch.ones(2)}}
    b = {"x": torch.tensor([1.0, 0.0]), "y": {"z": torch.ones(2)}}
    assert chip_smoke._trees_bit_equal(a, a)
    assert not chip_smoke._trees_bit_equal(a, b)       # -0.0 vs 0.0
    assert not chip_smoke._trees_bit_equal(a, {"x": a["x"], "w": a["y"]})


def test_a_launcher_step_launches_flash_once_per_layer(capsys):
    """A launcher step takes flash attention once per attention layer
    (on the CPU its plain version, counted here), which 3m (e)'s expected
    launches assume for the kernel and its backward."""
    from repro_torch.kernels.flash_attention import ops
    calls = {"fwd": 0}
    fwd = ops.flash_attention_plain

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)
    ops.flash_attention_plain = count_fwd
    try:
        out = chip_smoke._launch(["--reduced", "--mesh", "1x1", "--steps",
                                  "2", "--seq", "8"], device="cpu",
                                 quiet=True)
    finally:
        ops.flash_attention_plain = fwd
    cfg = get_reduced("smollm-360m").model
    want = chip_smoke._want_train_launches(cfg, 2, 0)
    assert len(out["losses"]) == 2 and "done: step 2" in out["log"]
    assert want["flash_attention"] == want["flash_attention_bwd"] == \
        2 * cfg.num_layers
    assert calls["fwd"] == want["flash_attention"]
