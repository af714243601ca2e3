"""The port's MoE family (``models/moe.py``, the moe branch of
``models/transformer.py``) against the JAX package on the CPU: the reduced
grok-1-314b (4 experts, top 2) and deepseek-v2-lite-16b (8 routed experts,
top 2, one shared, MLA, a dense first layer), with the JAX parameters
carried across.

Tolerances: fp32 ``rtol=atol=1e-5`` (the zoo's: sums in other orders);
bf16 the zoo's ``BF16_TOL`` for ``moe_block`` on one input.  A whole bf16
model is not held: a token whose K-th and (K+1)-th gates lie within a bf16
rounding of each other is routed by that rounding, and the two frameworks
round the layers before the router at other places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.serving import Generator as JGenerator
from repro.serving import LatencyModel as JLatencyModel
from repro.serving import perplexity as jperplexity
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import moe, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.models.common import is_spec, tree_leaves
from repro_torch.serving import Generator, LatencyModel, perplexity

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
MOE = ["grok-1-314b", "deepseek-v2-lite-16b"]


def _np(t):
    return t.detach().float().numpy()


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32), **tol)


def _cfgs(name, dtype="float32", **over):
    """(JAX cfg, port cfg) of the reduced arch in ``dtype``."""
    return tuple(get(name).model.replace(dtype=dtype, **over)
                 for get in (jconfigs.get_reduced, tconfigs.get_reduced))


def _block_params(jcfg, seed=0, dtype=jnp.float32):
    """One MoE block's JAX parameters (its spec's shapes, seeded normals at
    the spec's scales) and the same values as port tensors."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s[0]).astype(np.float32)
                              * np.float32(s[2]), dtype),
        jmoe.moe_spec(jcfg), is_leaf=is_spec)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(getattr(torch, jnp.dtype(dtype).name)), jp)
    return jp, tp


def _x(cfg, b, s, seed=1, dtype=jnp.float32):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, jnp.dtype(dtype).name))


def _dropped(jcfg, jx, jp):
    """Assignments the JAX block drops: each expert's token-major queue
    past its capacity."""
    T = jx.shape[0] * jx.shape[1]
    gates = jax.nn.softmax(jnp.einsum(
        "td,de->te", jx.reshape(T, -1), jp["router"]).astype(jnp.float32))
    _, idx = jax.lax.top_k(gates, jcfg.experts_per_token)
    counts = np.bincount(np.asarray(idx).reshape(-1),
                         minlength=jcfg.num_experts)
    return int(np.maximum(counts - jmoe._capacity(T, jcfg), 0).sum())


# ------------------------------------------------------------------ specs ---

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", MOE)
def test_moe_spec_equals_jax(name, reduced):
    get = "get_reduced" if reduced else "get_arch"
    jcfg = getattr(jconfigs, get)(name).model
    tcfg = getattr(tconfigs, get)(name).model
    assert moe.moe_spec(tcfg) == jmoe.moe_spec(jcfg)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("tokens", [1, 2, 7, 8, 48, 188, 1024, 4096])
def test_capacity_equals_jax(name, tokens):
    jcfg = jconfigs.get_arch(name).model
    tcfg = tconfigs.get_arch(name).model
    assert moe._capacity(tokens, tcfg) == jmoe._capacity(tokens, jcfg)


def test_capacity_at_deepseek_decode_is_k():
    """int(8 * 6 * 1.0 / 64) = 0, so a decode step at batch 8 takes K."""
    cfg = tconfigs.get_arch("deepseek-v2-lite-16b").model
    assert moe._capacity(8, cfg) == cfg.experts_per_token == 6
    assert moe._capacity(1024, cfg) == 96


# ---------------------------------------------------------------- routing ---

def test_route_keeps_the_lower_expert_on_ties():
    gates = torch.tensor([[0.1, 0.3, 0.3, 0.3],
                          [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]])
    g, idx = moe.route(gates, 2)
    assert idx.tolist() == [[1, 2], [0, 1], [0, 2]]
    assert torch.equal(g, gates.gather(-1, idx))
    jg, jidx = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("name", MOE)
def test_moe_block_with_dropped_assignments_matches_jax(name):
    """y and the aux loss at 1e-5 where capacity drops assignments (a
    capacity factor of 0.5: every expert takes 8 of the 33 tokens' 66
    assignments; the dropped ones contribute nothing, aux counts them)."""
    jcfg, tcfg = _cfgs(name, capacity_factor=0.5)
    jp, tp = _block_params(jcfg)
    jx, tx = _x(jcfg, 3, 11)
    assert _dropped(jcfg, jx, jp) > 0
    jy, jaux = jmoe.moe_block(jx, jp, jcfg)
    ty, taux = moe.moe_block(tx, tp, tcfg)
    assert ty.shape == jy.shape and taux.dtype == torch.float32
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("name", MOE)
def test_moe_block_at_decode_size_matches_jax(name):
    """A decode step's group: b tokens, capacity K."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _block_params(jcfg, seed=2)
    jx, tx = _x(jcfg, 4, 1, seed=3)
    jy, jaux = jmoe.moe_block(jx, jp, jcfg)
    ty, taux = moe.moe_block(tx, tp, tcfg)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("name", MOE)
def test_moe_block_with_tied_gates_picks_jax_experts(name):
    """A router whose two columns are equal gives every token two equal
    gates: the port routes to JAX's (the lower) expert among them, so the
    outputs match; routing to the other would move them by O(1)."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _block_params(jcfg, seed=4)
    router = np.asarray(jp["router"]).copy()
    router[:, 1] = router[:, 0]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    jx, tx = _x(jcfg, 2, 5, seed=5)
    gates = torch.softmax(tx.reshape(10, -1) @ tp["router"], -1)
    assert torch.equal(gates[:, 0], gates[:, 1])
    _, idx = moe.route(gates, tcfg.experts_per_token)
    _, jidx = jax.lax.top_k(jnp.asarray(gates.numpy()),
                            jcfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # expert 1 is picked only beside expert 0, its tie
    assert bool((idx == 0).any())
    assert not bool(((idx == 1).any(-1) & ~(idx == 0).any(-1)).any())
    jy, jaux = jmoe.moe_block(jx, jp, jcfg)
    ty, taux = moe.moe_block(tx, tp, tcfg)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("name", MOE)
def test_moe_block_bf16_matches_jax(name):
    jcfg, tcfg = _cfgs(name, "bfloat16")
    jp, tp = _block_params(jcfg, seed=6, dtype=jnp.bfloat16)
    jx, tx = _x(jcfg, 2, 9, seed=7, dtype=jnp.bfloat16)
    jy, jaux = jmoe.moe_block(jx, jp, jcfg)
    ty, taux = moe.moe_block(tx, tp, tcfg)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    _close(ty, jy, BF16_TOL)
    _close(taux, jaux, BF16_TOL)


# ---------------------------------------------------------- whole models ---

_MODELS = {}


def _pair(name):
    """(port arch, JAX arch, JAX model, JAX params, port Model): reduced,
    fp32, the same values; built once per test process."""
    if name not in _MODELS:
        jarch = jconfigs.get_reduced(name)
        jarch = jarch.replace(model=jarch.model.replace(dtype="float32"))
        arch = tconfigs.get_reduced(name)
        arch = arch.replace(model=arch.model.replace(dtype="float32"))
        jm = jbuild(jarch)
        params = jm.init(jax.random.key(3))
        model = params_from_numpy(jax.tree.map(np.asarray, params), arch,
                                  device="cpu")
        _MODELS[name] = (arch, jarch, jm, params, model)
    return _MODELS[name]


@pytest.mark.parametrize("name", MOE)
def test_model_spec_has_the_moe_tree(name):
    arch, _jarch, jm, params, model = _pair(name)
    cfg = arch.model
    spec = tfm.model_spec(cfg)
    assert ("first" in spec) == bool(cfg.first_k_dense)
    assert spec["blocks"]["moe"]["w_gate"][0] == (
        cfg.num_layers - cfg.first_k_dense, cfg.num_experts, cfg.d_model,
        cfg.moe_d_ff)
    assert ("shared" in spec["blocks"]["moe"]) == bool(
        cfg.num_shared_experts)
    assert len(tree_leaves(model.params)) == len(jax.tree.leaves(params))


@pytest.mark.parametrize("name", MOE)
def test_forward_aux_sums_the_moe_layers(name):
    """aux is the MoE layers' load-balance losses summed in fp32, as the
    JAX scan carries it; the loss adds AUX_COEF of it."""
    arch, _jarch, jm, params, model = _pair(name)
    toks = np.random.default_rng(4).integers(
        0, arch.model.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _, aux = model.forward(batch)
    _, jaux = jm.forward(params, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    assert aux.dtype == torch.float32 and float(aux) > 0.0
    _close(aux, jaux)
    total, parts = model.loss(batch)
    _close(total, parts["loss"] + tfm.AUX_COEF * parts["aux"])


@pytest.mark.parametrize("name", MOE)
def test_greedy_generation_matches_jax(name):
    """Greedy tokens equal JAX's Generator's; with JAX's tokens fed in,
    every step's logits within TOL of JAX's."""
    arch, jarch, jm, params, model = _pair(name)
    prompts = np.random.default_rng(5).integers(
        0, arch.model.vocab_size, (2, 6)).astype(np.int32)
    want = JGenerator(jarch, params, max_seq=16).generate(
        prompts, max_new_tokens=5)
    gen = Generator(arch, model, max_seq=16, device="cpu")
    got = gen.generate(prompts, max_new_tokens=5)
    assert gen.decode_steps == 11
    jc, tc = jm.init_cache(2, 16), model.init_cache(2, 16)
    for pos in range(want.shape[1] - 1):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(want[:, pos]),
                                jnp.int32(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(want[:, pos]), pos)
        _close(tl, jl)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MOE)
def test_perplexity_matches_jax(name):
    arch, _jarch, jm, params, model = _pair(name)
    toks = np.random.default_rng(6).integers(
        0, arch.model.vocab_size, (2, 17)).astype(np.int32)
    p = perplexity(model, toks)
    assert np.isfinite(p) and p > 1.0
    np.testing.assert_allclose(p, jperplexity(jm, params, toks), rtol=1e-5)


def test_grok_prefill_then_decode_continues_the_prompt():
    """Model.prefill's cache, then decode steps, give the logits of the
    token-by-token decode loop (the Generator's) where no assignment is
    dropped: a capacity factor of E / K makes the prefill's capacity its
    token count (a decode step of b tokens never drops: C >= K >= b's
    share of any expert here)."""
    from repro_torch.models import Model
    arch, _jarch, _jm, _params, model = _pair("grok-1-314b")
    cfg = arch.model
    model = Model(cfg.replace(capacity_factor=cfg.num_experts
                              / cfg.experts_per_token), model.params)
    toks = np.random.default_rng(7).integers(
        0, arch.model.vocab_size, (2, 8)).astype(np.int32)
    pl, pc = model.prefill({"tokens": toks[:, :6]}, max_seq=8)
    cache = model.init_cache(2, 8)
    for pos in range(6):
        dl, cache = model.decode_step(cache, torch.from_numpy(toks[:, pos]),
                                      pos)
    _close(pl, dl)
    for key in ("k", "v"):
        _close(pc[key], cache[key])
    for pos in (6, 7):
        a, pc = model.decode_step(pc, torch.from_numpy(toks[:, pos]), pos)
        b, cache = model.decode_step(cache, torch.from_numpy(toks[:, pos]),
                                     pos)
        _close(a, b)


# ---------------------------------------------------------- serving sizes ---

@pytest.mark.parametrize("name,n_params", [("deepseek-v2-lite-16b",
                                            15_706_470_400),
                                           ("grok-1-314b", 316_489_340_928)])
def test_latency_model_sizes_the_moe_family(name, n_params):
    kw = dict(flops=9.89e14, mem_bandwidth=3.35e12)
    got = LatencyModel.from_arch(name, **kw)
    assert got.n_params == n_params
    assert (dataclasses.asdict(got)
            == dataclasses.asdict(JLatencyModel.from_arch(name, **kw)))
    cfg = tconfigs.get_arch(name).model
    per_layer = (cfg.kv_lora_rank + cfg.qk_rope_head_dim if cfg.use_mla
                 else 2 * cfg.kv_heads * cfg.hdim)
    assert got.kv_bytes_token == cfg.num_layers * per_layer * 2


@pytest.mark.parametrize("name", MOE)
def test_serve_launcher_serves_the_moe_family_on_the_cpu(name, capsys):
    serve_launcher.main(["--arch", name, "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "5",
                         "--new-tokens", "4", "--requests", "1"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith("request 0: 2x4 = 8 tokens")
    ppl = float(out[0].split("ppl=")[1])
    assert np.isfinite(ppl) and ppl > 1.0
    assert out[-1].startswith("served 8 tokens") and out[-1].endswith("cpu")


@pytest.mark.parametrize("name", MOE)
def test_moe_training_is_refused_naming_its_roadmap_item(name):
    """No longer refused: the MoE family trains.  Its spec builds (the
    same hash as the JAX package's) and its workload has the JAX
    package's size."""
    from repro.core.workloads import ArchWorkload as JArchWorkload
    from repro.experiments import ExperimentSpec as JExperimentSpec
    from repro_torch.core.workloads import ArchWorkload
    from repro_torch.experiments import ExperimentSpec
    model = tconfigs.spec_name(name)
    spec = ExperimentSpec(model=model, dataset="tokens")
    assert spec.spec_hash() == JExperimentSpec(
        model=model, dataset="tokens").spec_hash()
    assert ArchWorkload(model).n_params == JArchWorkload(model).n_params
