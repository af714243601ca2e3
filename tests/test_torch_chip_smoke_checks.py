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
