"""The port's serving path (``Generator``, ``perplexity``, ``LatencyModel``,
the launcher) against the JAX package's, on the CPU, with the JAX
parameters of reduced smollm-360m, mamba2-370m and zamba2-2.7b (fp32, as
the launcher forces; 4-position SSD chunks) carried across.

Tolerances: per-step logits ``rtol=1e-5, atol=1e-5`` (fp32 sums in other
orders; see tests/test_torch_zoo.py), perplexity ``rtol=1e-5``.  Greedy
tokens are compared exactly: at this size no step's top-two logits lie
within the logits' tolerance (the test checks the margin).  Temperature
sampling uses a ``torch.Generator`` and cannot reproduce
``jax.random.categorical``'s draws; its seed behaviour is what is held.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import build_model as jbuild
from repro.serving import Generator as JGenerator
from repro.serving import LatencyModel as JLatencyModel
from repro.serving import perplexity as jperplexity
from repro_torch.configs import get_reduced, spec_name
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import params_from_numpy
from repro_torch.serving import Generator, LatencyModel, perplexity

TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = ["smollm-360m", "stablelm-3b", "phi3-medium-14b", "llama3-405b"]
SSM = ["mamba2-370m", "zamba2-2.7b"]           # the ssm and hybrid families


def _fp32(arch):
    return arch.replace(model=arch.model.replace(dtype="float32"))


_SMALL = {}


def _small(name):
    """(port arch, JAX arch, JAX model, JAX params, port Model) for a
    reduced config in fp32 with 4-position SSD chunks -- the same values in
    both packages; built once per test process."""
    if name not in _SMALL:
        def cut(arch):
            return arch.replace(model=arch.model.replace(dtype="float32",
                                                         ssm_chunk=4))
        jarch = cut(jget_reduced(name))
        jm = jbuild(jarch)
        params = jm.init(jax.random.key(0))
        arch = cut(get_reduced(name))
        model = params_from_numpy(jax.tree.map(np.asarray, params), arch,
                                  device="cpu")
        _SMALL[name] = (arch, jarch, jm, params, model)
    return _SMALL[name]


@pytest.fixture(scope="module")
def small():
    """(port arch, JAX arch, JAX model, JAX params, port Model) of reduced
    smollm-360m -- the same values."""
    return _small("smollm-360m")


def _prompts(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _greedy_matches_jax(arch, jarch, jm, params, model):
    prompts = _prompts(arch.model.vocab_size, (2, 7), 0)
    want = JGenerator(jarch, params, max_seq=32).generate(
        prompts, max_new_tokens=5)
    got = Generator(arch, model, max_seq=32, device="cpu").generate(
        prompts, max_new_tokens=5)
    assert got.dtype == np.int32 and got.shape == (2, 12)
    jc, tc = jm.init_cache(2, 32), model.init_cache(2, 32)
    for pos in range(want.shape[1] - 1):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(want[:, pos]),
                                jnp.int32(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(want[:, pos]), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        if pos >= prompts.shape[1] - 1:
            top2 = np.sort(np.asarray(jl), axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0] > 2 * (TOL["atol"] + TOL["rtol"]
                                                   * np.abs(top2[:, 1]))).all()
    np.testing.assert_array_equal(got, want)
    # teacher forcing <-> decode: the forward's logits are the steps'
    logits, _ = model.forward({"tokens": got[:, :-1]})
    np.testing.assert_array_equal(got[:, 7:], logits[:, 6:].argmax(-1))


def test_greedy_generation_matches_jax(small):
    """Greedy tokens equal JAX's; with JAX's tokens fed in, every step's
    logits are within TOL of JAX's, and the top-two margin of every step
    exceeds twice that tolerance (so argmax cannot flip)."""
    _greedy_matches_jax(*small)


@pytest.mark.parametrize("name", SSM)
def test_greedy_generation_matches_jax_ssm_families(name):
    """As for smollm: mamba2's conv/state cache and zamba2's, with its
    shared attention block's K/V, through the same Generator."""
    _greedy_matches_jax(*_small(name))


def test_first_token_is_forward_argmax(small):
    arch, _jarch, _jm, _params, model = small
    prompts = _prompts(arch.model.vocab_size, (2, 7), 0)
    out = Generator(arch, model, max_seq=32, device="cpu").generate(
        prompts, max_new_tokens=3)
    logits, _ = model.forward({"tokens": prompts})
    np.testing.assert_array_equal(out[:, 7], logits[:, -1].argmax(-1).numpy())


def test_generation_deterministic_with_a_fresh_cache(small):
    """Two calls give the same tokens: each call makes its own cache, so the
    in-place updates of one never leak into the next."""
    arch, _jarch, _jm, _params, model = small
    prompts = _prompts(arch.model.vocab_size, (1, 5), 1)
    gen = Generator(arch, model, max_seq=16, device="cpu")
    a = gen.generate(prompts, max_new_tokens=4)
    b = gen.generate(prompts, max_new_tokens=4)
    np.testing.assert_array_equal(a, b)


def test_sampling_temperature_seeds(small):
    arch, _jarch, _jm, _params, model = small
    prompts = _prompts(arch.model.vocab_size, (1, 4), 2)
    gen = Generator(arch, model, max_seq=16, device="cpu")
    a = gen.generate(prompts, max_new_tokens=6, temperature=2.0, seed=1)
    b = gen.generate(prompts, max_new_tokens=6, temperature=2.0, seed=2)
    a2 = gen.generate(prompts, max_new_tokens=6, temperature=2.0, seed=1)
    assert a.shape == b.shape == (1, 10)
    assert not np.array_equal(a, b)        # other seed, other draws
    np.testing.assert_array_equal(a, a2)   # same seed, same draws
    np.testing.assert_array_equal(a[:, :4], prompts)


def test_decode_steps_and_simulated_latency_match_jax(small):
    arch, jarch, _jm, params, model = small
    prompts = _prompts(arch.model.vocab_size, (1, 7), 0)
    gen = Generator(arch, model, max_seq=32, device="cpu")
    jgen = JGenerator(jarch, params, max_seq=32)
    gen.generate(prompts, max_new_tokens=5)
    jgen.generate(prompts, max_new_tokens=5)
    assert gen.decode_steps == jgen.decode_steps == 12   # 7 prefill + 5
    kw = dict(flops=1e12, mem_bandwidth=1e11, reduced=True)
    lat = LatencyModel.from_arch("smollm_360m", **kw)
    assert (gen.simulated_latency_s(lat)
            == jgen.simulated_latency_s(JLatencyModel.from_arch(
                "smollm_360m", **kw)))


def test_perplexity_matches_jax(small):
    arch, _jarch, jm, params, model = small
    toks = _prompts(arch.model.vocab_size, (2, 16), 3)
    p = perplexity(model, toks)
    assert np.isfinite(p) and p > 1.0
    np.testing.assert_allclose(p, jperplexity(jm, params, toks), rtol=1e-5)


@pytest.mark.parametrize("name", SSM)
def test_perplexity_matches_jax_ssm_families(name):
    arch, _jarch, jm, params, model = _small(name)
    toks = _prompts(arch.model.vocab_size, (2, 18), 3)   # 17 % 4 != 0
    p = perplexity(model, toks)
    assert np.isfinite(p) and p > 1.0
    np.testing.assert_allclose(p, jperplexity(jm, params, toks), rtol=1e-5)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", DENSE + SSM)
def test_latency_model_fields_equal_jax(name, reduced):
    for key in (name, spec_name(name)):
        kw = dict(flops=2.5e14, mem_bandwidth=1.6e12, reduced=reduced)
        got = dataclasses.asdict(LatencyModel.from_arch(key, **kw))
        assert got == dataclasses.asdict(JLatencyModel.from_arch(key, **kw))


def test_latency_model_refuses_what_the_port_does_not_build():
    with pytest.raises(ValueError, match="encoder"):
        LatencyModel.from_arch("hubert-xlarge", flops=1.0, mem_bandwidth=1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LatencyModel.from_arch("grok_1_314b", flops=1.0, mem_bandwidth=1.0)


def test_serve_launcher_runs_on_the_cpu(capsys):
    serve_launcher.main(["--reduced", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "5", "--new-tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[0].startswith("request 0: 2x4 = 8 tokens")
    assert "tok/s" in out[0] and "ppl=" in out[0]
    assert out[-1].startswith("served 16 tokens") and out[-1].endswith("cpu")


def test_serve_launcher_serves_mamba2_on_the_cpu(capsys):
    serve_launcher.main(["--arch", "mamba2-370m", "--reduced", "--device",
                         "cpu", "--batch", "2", "--prompt-len", "5",
                         "--new-tokens", "4", "--requests", "1"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith("request 0: 2x4 = 8 tokens")
    ppl = float(out[0].split("ppl=")[1])
    assert np.isfinite(ppl) and ppl > 1.0
    assert out[-1].startswith("served 8 tokens") and out[-1].endswith("cpu")


def test_generator_moves_a_model_to_its_device(small):
    arch, _jarch, _jm, _params, model = small
    gen = Generator(arch, model, max_seq=8, device="cpu")
    assert gen.model is model and gen.model.device.type == "cpu"
    built = Generator(get_reduced("smollm-360m"), max_seq=8, device="cpu")
    assert built.model.device.type == "cpu"
    assert next(built.model.parameters()).dtype == torch.bfloat16
