"""The vlm family (llama-3.2-vision-90b, reduced: 2 groups of one
self-attention and one cross-attention block, 16 image tokens) against
the JAX package, on the CPU, with the JAX parameters carried across
(``params_from_numpy``) and batches from ``make_batch`` (numpy seeds).

Tolerances: fp32 ``rtol=1e-5, atol=1e-5`` (see tests/test_torch_zoo.py);
bf16 ``BF16_TOL`` (the two frameworks' matrix products sum in other
orders before rounding to bf16; the logits' own bf16 ulp at |x| ~ 2 is
1.6e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.specs import make_batch as jmake_batch
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import transformer as jtfm
from repro.serving import Generator as JGenerator
from repro.serving import perplexity as jperplexity
from repro_torch import configs as tconfigs
from repro_torch.launch.specs import make_batch
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.serving import Generator, perplexity

NAME = "llama-3.2-vision-90b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _np(t):
    return t.detach().float().numpy()


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(_np(port), np.asarray(
        jnp.asarray(ref).astype(jnp.float32)), **tol)


def _dt(arch, dtype):
    return arch.replace(model=arch.model.replace(dtype=dtype))


_PAIRS = {}


def _pair(dtype="float32"):
    """(port arch, JAX arch, JAX model, JAX params, port Model) of the
    reduced vlm in ``dtype``, the same values in both; built once."""
    if dtype not in _PAIRS:
        jarch = _dt(jconfigs.get_reduced(NAME), dtype)
        arch = _dt(tconfigs.get_reduced(NAME), dtype)
        jm = jbuild(jarch)
        params = jm.init(jax.random.key(0))
        model = params_from_numpy(jax.tree.map(np.asarray, params), arch,
                                  device="cpu")
        _PAIRS[dtype] = (arch, jarch, jm, params, model)
    return _PAIRS[dtype]


def _batches(arch, jarch, b=2, s=9, seed=3):
    return (make_batch(arch, b, s, seed=seed, device="cpu"),
            jmake_batch(jarch, b, s, seed=seed))


def test_reduced_config_is_two_groups_of_self_and_cross():
    arch, _jarch, _jm, params, model = _pair()
    m = arch.model
    assert (m.num_layers, m.cross_attn_every, m.num_image_tokens) == (4, 2,
                                                                      16)
    p = model.params
    assert p["blocks"]["self"]["attn"]["wq"].shape == (2, 1, 64, 4, 16)
    assert p["blocks"]["cross"]["attn"]["wk"].shape == (2, 64, 2, 16)
    assert model.param_count() == jbuild(_pair()[1]).param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_jax(dtype):
    arch, jarch, jm, params, model = _pair(dtype)
    batch, jbatch = _batches(arch, jarch)
    assert batch["image_embeds"].dtype == torch.bfloat16
    tol = TOL if dtype == "float32" else BF16_TOL
    logits, aux = model.forward(batch)
    jlogits, _ = jm.forward(params, jbatch)
    assert logits.dtype == getattr(torch, dtype) and float(aux) == 0.0
    _close(logits, jlogits, tol)
    (total, parts), (jtotal, _) = model.loss(batch), jm.loss(params, jbatch)
    _close(total, jtotal, tol)
    last, _ = model.forward(batch, last_only=True)
    assert last.dtype == torch.float32
    _close(last, jm.forward(params, jbatch, last_only=True)[0], tol)


def test_cross_attention_matches_jax():
    """q from x, K/V from the image, no rope, non-causal, sq != sk."""
    arch, _jarch, _jm, params, model = _pair()
    cfg = arch.model
    jp = jax.tree.map(lambda a: a[1], params["blocks"])["cross"]["attn"]
    tp = tfm.layer(model.params, 1)["cross"]["attn"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    img = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    _close(tattn.gqa_attention(torch.from_numpy(x), tp, cfg, causal=False,
                               positions=None, kv_src=torch.from_numpy(img),
                               use_rope=False),
           jattn.gqa_attention(jnp.asarray(x), jp, cfg, causal=False,
                               positions=None, kv_src=jnp.asarray(img),
                               use_rope=False))
    k, v = tattn.gqa_prefill_kv(torch.from_numpy(img), tp, cfg,
                                positions=None, use_rope=False)
    jk, jv = jattn.gqa_prefill_kv(jnp.asarray(img), jp, cfg, positions=None,
                                  use_rope=False)
    _close(k, jk)
    _close(v, jv)


def test_vlm_uses_image():
    """Zeroed image embeddings move the logits (JAX's
    ``test_vlm_uses_image``), by as much as they move JAX's."""
    arch, jarch, jm, params, model = _pair()
    batch, jbatch = _batches(arch, jarch, b=1, s=8, seed=0)
    out1, _ = model.forward(batch)
    out2, _ = model.forward(dict(batch,
                                 image_embeds=batch["image_embeds"] * 0.0))
    assert float((out1 - out2).abs().max()) > 1e-6
    jout2, _ = jm.forward(params, dict(
        jbatch, image_embeds=jbatch["image_embeds"] * 0.0))
    _close(out2, jout2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prime_cross_cache_and_teacher_forced_decode_match_jax(dtype):
    """Every step's logits and, at the end, every cache leaf equal JAX's;
    in fp32 each step's logits are the forward's at its position (JAX's
    ``test_decode_matches_forward``)."""
    arch, jarch, jm, params, model = _pair(dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    b, s = 2, 12
    batch, jbatch = _batches(arch, jarch, b, s, seed=3)
    tc = model.init_cache(b, s)
    jc = jm.init_cache(b, s)
    assert tc.keys() == jc.keys() == {"k", "v", "xk", "xv"}
    out = model.prime_cross_cache(tc, batch["image_embeds"])
    assert out is tc                                       # in place
    jc = jm.prime_cross_cache(params, jc, jbatch["image_embeds"])
    for key in ("xk", "xv"):
        assert tuple(tc[key].shape) == jc[key].shape
        _close(tc[key], jc[key], tol)
    full, _ = model.forward(batch)
    for t in range(s):
        tl, tc = model.decode_step(tc, batch["tokens"][:, t], t)
        jl, jc = jm.decode_step(params, jc, jbatch["tokens"][:, t],
                                jnp.int32(t))
        assert tl.dtype == torch.float32
        _close(tl, jl, tol)
        if dtype == "float32":
            _close(tl, full[:, t])
    for key in jc:
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype))
        _close(tc[key], jc[key], tol)


def test_cross_decode_is_the_jax_inline_attention():
    """``cross_decode`` (decode attention at length T) against the JAX
    model's inline einsums, over one group's primed image K/V."""
    arch, jarch, _jm, params, model = _pair()
    cfg = arch.model
    rng = np.random.default_rng(7)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    xk = rng.standard_normal((2, 16, cfg.kv_heads, cfg.hdim)).astype(
        np.float32)
    xv = rng.standard_normal((2, 16, cfg.kv_heads, cfg.hdim)).astype(
        np.float32)
    cp = jax.tree.map(lambda a: a[0], params["blocks"])["cross"]["attn"]
    q = jnp.einsum("bsd,dhk->bshk", x1, cp["wq"])
    g = cfg.num_heads // cfg.kv_heads
    qg = q.reshape(2, cfg.kv_heads, g, cfg.hdim)
    sc = jnp.einsum("bmgk,btmk->bmgt", qg, xk) / (cfg.hdim ** 0.5)
    pr = jax.nn.softmax(sc.astype(jnp.float32), axis=-1)
    o = jnp.einsum("bmgt,btmv->bmgv", pr, xv).reshape(2, 1, cfg.num_heads,
                                                      cfg.hdim)
    want = jnp.einsum("bshk,hkd->bsd", o, cp["wo"])
    tp = tfm.layer(model.params, 0)["cross"]["attn"]
    _close(tattn.cross_decode(torch.from_numpy(x1), tp, cfg,
                              torch.from_numpy(xk), torch.from_numpy(xv)),
           want)


def test_cache_struct_matches_jax():
    cfg = jconfigs.get_reduced(NAME).model
    want = jtfm.cache_struct(cfg, 3, 7)
    got = tfm.cache_struct(tconfigs.get_reduced(NAME).model, 3, 7)
    assert got.keys() == want.keys()
    for key, (shape, axes, dtype) in want.items():
        assert got[key][:2] == (shape, axes)
        assert got[key][2] == getattr(torch, str(jnp.dtype(dtype)))
    full = tfm.cache_struct(tconfigs.get_arch(NAME).model, 2, 64)
    assert full["k"][0] == (20, 4, 2, 64, 8, 128)
    assert full["xk"][0] == (20, 2, 1024, 8, 128)


def test_generator_decodes_against_a_zero_image_cache_as_jax():
    """Neither package's ``Generator`` primes the image K/V: greedy tokens
    equal JAX's, and so does every step's logits, fed JAX's tokens."""
    arch, jarch, jm, params, model = _pair()
    prompts = np.random.default_rng(0).integers(
        0, arch.model.vocab_size, (2, 7)).astype(np.int32)
    want = JGenerator(jarch, params, max_seq=32).generate(
        prompts, max_new_tokens=5)
    got = Generator(arch, model, max_seq=32, device="cpu").generate(
        prompts, max_new_tokens=5)
    jc, tc = jm.init_cache(2, 32), model.init_cache(2, 32)
    for pos in range(want.shape[1] - 1):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(want[:, pos]),
                                jnp.int32(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(want[:, pos]), pos)
        _close(tl, jl)
        if pos >= prompts.shape[1] - 1:
            top2 = np.sort(np.asarray(jl), axis=-1)[:, -2:]
            assert (top2[:, 1] - top2[:, 0] > 2 * (TOL["atol"] + TOL["rtol"]
                                                   * np.abs(top2[:, 1]))).all()
    np.testing.assert_array_equal(got, want)
    assert not bool(tc["xk"].any())


def test_perplexity_and_prefill_fail_as_jax():
    """``perplexity`` builds no image embeddings, so on the vlm both
    packages' forwards miss them; ``prefill`` captures no vlm cache."""
    arch, jarch, jm, params, model = _pair()
    toks = np.random.default_rng(1).integers(
        0, arch.model.vocab_size, (2, 6)).astype(np.int32)
    with pytest.raises(KeyError, match="image_embeds"):
        jperplexity(jm, params, toks)
    with pytest.raises(KeyError, match="image_embeds"):
        perplexity(model, toks)
    with pytest.raises(NotImplementedError, match="'vlm'"):
        model.prefill({"tokens": toks})


def test_build_model_draws_a_seeded_vlm():
    arch = tconfigs.get_reduced(NAME)
    a = build_model(arch, device="cpu", seed=4)
    b = build_model(arch, device="cpu", seed=4)
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert a.device == torch.device("cpu")
    with pytest.raises(ValueError, match="cross cache"):
        build_model(tconfigs.get_reduced("smollm-360m"), device="cpu") \
            .prime_cross_cache({}, torch.zeros(1, 16, 64))


def test_value_and_grad_matches_jax():
    """The vlm's gradient (3k (f) takes it through ``value_and_grad``:
    stacked self and cross leaves split per layer) against
    ``jax.value_and_grad`` of the JAX model's loss, each leaf within 1e-5
    of its largest |g|."""
    arch, jarch, jm, params, model = _pair()
    batch, jbatch = _batches(arch, jarch, b=2, s=12, seed=5)
    loss, grads = tfm.value_and_grad(model.params, batch, arch.model)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True)(params)
    _close(loss, jloss)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(jax.tree.leaves(model.params))
    for path, g in flat:
        node = grads
        for key in path:
            node = node[key.key]
        a = np.asarray(jnp.asarray(g).astype(jnp.float32))
        scale = float(np.abs(a).max())
        assert scale > 0, path
        assert float(np.abs(a - _np(node)).max()) <= 1e-5 * scale, path
