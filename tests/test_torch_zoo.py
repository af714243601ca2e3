"""The port's model zoo (every family: dense, moe, encoder, vlm, ssm and
hybrid) against the JAX package, on the CPU, with the JAX parameters
carried across (``params_from_numpy``).  The encoder and vlm families
have files of their own too (tests/test_torch_encoder.py,
tests/test_torch_vlm.py).  The reduced configs of both packages run with
``ssm_chunk=4``, so that the whole-model tests cross chunk borders and
carry the SSM state.

Tolerances: float32 results agree to ``rtol=1e-5, atol=1e-5`` -- the two
frameworks sum the same fp32 products in other orders (matrix products,
the softmax) and may round ``rope``'s powers and ``cos``/``sin`` an ulp
apart, so logits of magnitude ~3 differ by a few 1e-6, never bitwise.
bfloat16 runs round at other places in the two frameworks (the JAX model
rounds attention probabilities to bf16 before PV; the port's kernels keep
them in fp32), so they are held to ``BF16_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import workloads as jworkloads
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro_torch import configs as tconfigs
from repro_torch.core import workloads as tworkloads
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, common, params_from_numpy
from repro_torch.models import transformer as tfm

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
DENSE = ["smollm-360m", "stablelm-3b", "phi3-medium-14b", "llama3-405b"]
MOE = ["grok-1-314b", "deepseek-v2-lite-16b"]  # deepseek: MLA, shared experts
SSM = ["mamba2-370m", "zamba2-2.7b"]           # the ssm and hybrid families
VLM, ENCODER = "llama-3.2-vision-90b", "hubert-xlarge"
BUILT = DENSE + MOE + SSM + [VLM, ENCODER]
DECODE = [a for a in BUILT if a != ENCODER]
#: the archs that are no training workload, as in the JAX package
OTHER = [VLM, ENCODER]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(_np(port), np.asarray(ref, np.float32), **tol)


def _fp32(arch):
    return arch.replace(model=arch.model.replace(dtype="float32"))


def _small(arch):
    """fp32, and 4-position SSD chunks (a config value both packages read)."""
    return arch.replace(model=arch.model.replace(dtype="float32",
                                                 ssm_chunk=4))


# --------------------------------------------------------------- configs ----

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_configs_equal_jax(name, reduced):
    get = "get_reduced" if reduced else "get_arch"
    assert (dataclasses.asdict(getattr(tconfigs, get)(name))
            == dataclasses.asdict(getattr(jconfigs, get)(name)))


def test_arch_names_come_from_the_registry():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert len(tworkloads.ARCH_NAMES) == len(jconfigs.ARCH_IDS)
    for n in tworkloads.ARCH_NAMES + ("lr", "mobilenet", "smollm-360m"):
        assert (tworkloads.is_arch_workload(n)
                == jworkloads.is_arch_workload(n))
        assert tconfigs.arch_key(n) in (jworkloads._arch_key(n), n)
    for a in jconfigs.ARCH_IDS:
        assert tconfigs.arch_key(tconfigs.spec_name(a)) == a
        assert tconfigs.arch_key(a) == a
    assert tconfigs.arch_key("lr") is None


# ------------------------------------------------------------ parameters ----

def _at(tree, path):
    """The leaf of a nested dict at a JAX key path."""
    for key in path:
        tree = tree[key.key]
    return tree


@pytest.mark.parametrize("name", BUILT)
def test_param_count_equals_jax_at_full_size(name):
    cfg = tconfigs.get_arch(name).model
    assert (common.param_count(tfm.model_spec(cfg))
            == jbuild(jconfigs.get_arch(name)).param_count())


def test_init_params_shapes_scales_and_seed():
    arch = tconfigs.get_reduced("smollm-360m")
    jparams = jbuild(jconfigs.get_reduced("smollm-360m")).init(
        jax.random.key(0))
    a = build_model(arch, device="cpu", seed=0).params
    b = build_model(arch, device="cpu", seed=0).params
    c = build_model(arch, device="cpu", seed=1).params
    spec = tfm.model_spec(arch.model)
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(paths) == len(common.tree_leaves(spec, common.is_spec))
    for path, pj in paths:
        (shape, _axes, scale), pa, pb, pc = (
            _at(t, path) for t in (spec, a, b, c))
        assert tuple(pa.shape) == shape == tuple(pj.shape)
        assert pa.dtype == torch.bfloat16                # the config's dtype
        assert torch.equal(pa, pb)                       # seeded
        ones = bool(np.all(np.asarray(pj, np.float32) == 1.0))
        assert bool((pa == 1).all()) == ones             # norm scales
        if not ones:
            assert not torch.equal(pa, pc)
            assert float(pa.float().abs().max()) <= 2.0 * scale * 1.01


@pytest.mark.parametrize("name", BUILT)
def test_params_from_numpy_carries_every_leaf(name):
    arch = jconfigs.get_reduced(name)
    tree = jax.tree.map(np.asarray, jbuild(arch).init(jax.random.key(1)))
    model = params_from_numpy(tree, tconfigs.get_reduced(name), device="cpu")
    got = model.params
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(paths) == len(common.tree_leaves(got))
    for path, leaf in paths:
        np.testing.assert_array_equal(_np(_at(got, path)),
                                      np.asarray(leaf, np.float32))
    bad = dict(tree, extra=np.zeros(1))
    with pytest.raises(ValueError, match="left over"):
        params_from_numpy(bad, tconfigs.get_reduced(name), device="cpu")
    bad = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(bad, tconfigs.get_reduced(name), device="cpu")
    bad = dict(tree, unembed=tree["unembed"][:, :-1])
    with pytest.raises(ValueError, match="unembed"):
        params_from_numpy(bad, tconfigs.get_reduced(name), device="cpu")


@pytest.mark.parametrize("name", OTHER)
def test_other_families_raise_naming_their_roadmap_item(name):
    """The encoder and vlm archs build (no ROADMAP.md item is named any
    more), and are still no training workload, as in the JAX package:
    their batches are not the LM corpus's."""
    model = build_model(tconfigs.get_reduced(name), device="cpu")
    assert model.param_count() == jbuild(jconfigs.get_reduced(name)) \
        .param_count()
    spec_model = tconfigs.spec_name(name)
    assert spec_model not in tworkloads.list_workloads()
    assert spec_model not in jworkloads.list_workloads()
    with pytest.raises(ValueError, match="encoder/VLM") as got:
        tworkloads.ArchWorkload(spec_model)
    with pytest.raises(ValueError, match="encoder/VLM") as want:
        jworkloads.ArchWorkload(spec_model)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------- numerics ----

def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * np.float32(scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    x, s = _rand((2, 5, 3, 20)), _rand((20,), 1)
    jx, js = jnp.asarray(x, dtype), jnp.asarray(s, dtype)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    ts = torch.from_numpy(np.array(js, np.float32)).to(getattr(torch, dtype))
    tol = TOL if dtype == "float32" else BF16_TOL
    _close(common.rms_norm(tx, ts, 1e-5), jcommon.rms_norm(jx, js, 1e-5), tol)
    pos = np.arange(5) + 40
    _close(common.rope(tx, torch.from_numpy(pos), 10_000.0),
           jcommon.rope(jx, jnp.asarray(pos), 10_000.0), tol)
    assert common.rope(tx, torch.from_numpy(pos), 1e4).dtype == tx.dtype


def _rope_per_call(x, positions, theta):
    """rope building its tables on every call (the port's rope before its
    tables were shared): the bits a tabled rope must keep."""
    d = x.shape[-1]
    exps = torch.arange(0, d, 2, dtype=torch.float32) / d
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_tables_keep_rope_bit_for_bit(dtype):
    """One Rotary per forward or decode step serves every layer and head
    width (MLA's rope part too) with the bits of a rope that builds its
    tables per call."""
    dt = getattr(torch, dtype)
    rot = common.Rotary(torch.arange(40, 47), 10_000.0)
    for seed, shape in enumerate(((2, 7, 3, 20), (2, 7, 5, 20),
                                  (2, 7, 1, 8), (1, 7, 4, 64))):
        x = torch.from_numpy(_rand(shape, seed)).to(dt)
        want = _rope_per_call(x, torch.arange(40, 47), 10_000.0)
        for got in (rot(x), common.rope(x, torch.arange(40, 47), 10_000.0),
                    common.rotary(rot, 1.0)(x)):
            assert got.dtype == dt
            assert torch.equal(got.view(torch.int16 if dtype == "bfloat16"
                                        else torch.int32),
                               want.view(torch.int16 if dtype == "bfloat16"
                                         else torch.int32))
    assert sorted(rot._tables) == [8, 20, 64]    # one table per width
    one = common.Rotary(torch.full((1,), 9), 500_000.0)
    x = torch.from_numpy(_rand((3, 1, 2, 16), 7)).to(dt)
    assert torch.equal(one(x), _rope_per_call(x, torch.full((1,), 9),
                                              500_000.0))


#: sha256 of a seeded init's leaves (seed 3, the reduced configs) as the
#: port drew them with out-of-place scaling: scaling in place keeps them
INIT_SHA256 = {
    ("smollm-360m", "bfloat16"):
        "177c377fec3f0edd253601fd0217f0a57dc42346575ffc77207d9c2540f0767f",
    ("smollm-360m", "float32"):
        "63863192f46dbc211b1d35f39f48742a1f1b01f42774045ba0c0f479c5bde754",
    ("mamba2-370m", "bfloat16"):
        "ed8067529899ff27d3e947e5c267bab6e47610de72a1c5f14f8c1d092eca9d69",
    ("mamba2-370m", "float32"):
        "56739c19fe89965b1cd2d8ca825cee3f5ed5181991186e4ef3855c671e2ac994"}


@pytest.mark.parametrize("name,dtype", sorted(INIT_SHA256))
def test_init_params_bits_are_kept(name, dtype):
    import hashlib
    arch = tconfigs.get_reduced(name)
    arch = arch.replace(model=arch.model.replace(dtype=dtype))
    h = hashlib.sha256()
    for t in common.tree_leaves(build_model(arch, device="cpu",
                                            seed=3).params):
        h.update(t.view(torch.int16 if t.dtype == torch.bfloat16
                        else torch.int32).numpy().tobytes())
    assert h.hexdigest() == INIT_SHA256[(name, dtype)]


def test_softmax_and_cross_entropy_match_jax():
    x = _rand((3, 4, 11), scale=4.0)
    where = np.random.default_rng(2).random((3, 4, 11)) > 0.3
    where[..., 0] = True
    _close(common.softmax_fp32(torch.from_numpy(x),
                               where=torch.from_numpy(where)),
           jcommon.softmax_fp32(jnp.asarray(x), where=jnp.asarray(where)))
    labels = np.random.default_rng(3).integers(0, 11, (3, 4))
    mask = np.random.default_rng(4).random((3, 4)) > 0.5
    for m in (None, mask):
        port = common.cross_entropy(
            torch.from_numpy(x), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        ref = jcommon.cross_entropy(jnp.asarray(x), jnp.asarray(labels),
                                    None if m is None else jnp.asarray(m))
        _close(port, ref)


# ------------------------------------------------------------- attention ----

_MODELS = {}


def _pair(name):
    """(cfg, JAX model, JAX params, port Model) for a reduced config in
    fp32 with 4-position SSD chunks, built once per test process."""
    if name not in _MODELS:
        arch = _small(jconfigs.get_reduced(name))
        jm = jbuild(arch)
        params = jm.init(jax.random.key(0))
        model = params_from_numpy(jax.tree.map(np.asarray, params),
                                  _small(tconfigs.get_reduced(name)),
                                  device="cpu")
        _MODELS[name] = (arch.model, jm, params, model)
    return _MODELS[name]


@pytest.fixture(scope="module")
def smollm():
    """Reduced smollm-360m in fp32: the config, the JAX model, its params,
    and the port's Model holding the same values."""
    return _pair("smollm-360m")


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_matches_jax_sdpa(causal):
    q, k, v = _rand((2, 13, 6, 20)), _rand((2, 13, 2, 20), 1), \
        _rand((2, 13, 2, 20), 2)
    _close(tattn.sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal),
           jattn._sdpa(*map(jnp.asarray, (q, k, v)), causal=causal))


def test_gqa_attention_and_decode_match_jax(smollm):
    cfg, _jm, params, model = smollm
    jp = jax.tree.map(lambda a: a[0], params["blocks"])["attn"]
    tp = tfm.layer(model.params, 0)["attn"]
    x = _rand((2, 9, cfg.d_model), 5)
    pos = np.arange(9)
    _close(tattn.gqa_attention(torch.from_numpy(x), tp, cfg, causal=True,
                               positions=torch.from_numpy(pos)),
           jattn.gqa_attention(jnp.asarray(x), jp, cfg, causal=True,
                               positions=jnp.asarray(pos)))
    ck, cv = _rand((2, 12, cfg.kv_heads, cfg.hdim), 6), \
        _rand((2, 12, cfg.kv_heads, cfg.hdim), 7)
    x1 = _rand((2, 1, cfg.d_model), 8)
    jo, jck, jcv = jattn.gqa_decode(jnp.asarray(x1), jp, cfg, jnp.asarray(ck),
                                    jnp.asarray(cv), 7)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    to, ock, ocv = tattn.gqa_decode(torch.from_numpy(x1), tp, cfg, tck, tcv, 7)
    assert ock is tck and ocv is tcv                     # updated in place
    _close(to, jo)
    _close(tck, jck)
    _close(tcv, jcv)


# ------------------------------------------------------------ whole model ----

def _tokens(cfg, b=2, s=9, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _lm_batch(cfg, name, s=10):
    """A batch of s - 1 positions as numpy arrays: tokens and next-token
    labels; an encoder's frames, labels and mask; the vlm's image
    embeddings beside its tokens."""
    toks = _tokens(cfg, s=s)
    rng = np.random.default_rng(11)
    if name == ENCODER:
        return {"frames": _rand((2, s - 1, cfg.d_model), 12),
                "labels": toks[:, 1:], "mask": rng.random((2, s - 1)) < 0.5}
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if name == VLM:
        batch["image_embeds"] = _rand((2, cfg.num_image_tokens,
                                       cfg.d_model), 13)
    return batch


@pytest.mark.parametrize("name", BUILT)
def test_forward_and_loss_match_jax(name):
    cfg, jm, params, model = _pair(name)
    batch = _lm_batch(cfg, name)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, aux = model.forward(batch)
    jlogits, jaux = jm.forward(params, jbatch)
    assert logits.shape == jlogits.shape and aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (name not in MOE)   # the MoE layers' aux
    _close(logits, jlogits)
    _close(aux, jaux)
    last, _ = model.forward(batch, last_only=True)
    jlast, _ = jm.forward(params, jbatch, last_only=True)
    assert last.dtype == torch.float32
    _close(last, jlast)
    (total, parts), (jtotal, jparts) = model.loss(batch), jm.loss(params,
                                                                jbatch)
    _close(total, jtotal)
    _close(parts["loss"], jparts["loss"])
    _close(parts["aux"], jparts["aux"])


@pytest.mark.parametrize("name", DECODE)
def test_decode_steps_over_a_prompt_match_jax(name):
    """Every step's logits and, at the end, every cache leaf (K/V; conv
    inputs and SSM state; the shared block's K/V; the vlm's image K/V,
    never primed here: zeros, as a forward on zero image embeddings
    sees them) equal JAX's."""
    cfg, jm, params, model = _pair(name)
    toks = _tokens(cfg, s=9, seed=1)
    jc, tc = jm.init_cache(2, 12), model.init_cache(2, 12)
    assert tc.keys() == jc.keys()
    for pos in range(toks.shape[1]):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, pos]),
                                jnp.int32(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(toks[:, pos]), pos)
        assert tl.dtype == torch.float32
        _close(tl, jl)
    for key in jc:
        assert tc[key].shape == jc[key].shape
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype))
        _close(tc[key], jc[key])
    # teacher forcing <-> decode: the last step's logits are the forward's.
    # Not for MoE: its forward routes all b*s tokens as one group under a
    # capacity that drops assignments, a decode step only its b tokens
    # (the JAX model's function too)
    if name not in MOE:
        batch = {"tokens": toks}
        if name == VLM:
            batch["image_embeds"] = torch.zeros(2, cfg.num_image_tokens,
                                                cfg.d_model)
        full, _ = model.forward(batch)
        _close(tl, full[:, -1])


@pytest.mark.parametrize("name", DENSE + ["grok-1-314b"])
def test_prefill_matches_jax(name):
    cfg, jm, params, model = _pair(name)
    toks = _tokens(cfg, s=9, seed=2)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_seq=12)
    tl, tc = model.prefill({"tokens": toks}, max_seq=12)
    _close(tl, jl)
    assert tc["k"].shape == jc["k"].shape
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("name", SSM + ["deepseek-v2-lite-16b"])
def test_prefill_raises_for_the_ssm_families_as_jax_does(name):
    """The ssm families and MLA have no cache capture in the JAX package:
    the ``Generator`` prefills them token by token."""
    cfg, jm, params, model = _pair(name)
    toks = _tokens(cfg, s=5, seed=2)
    with pytest.raises(NotImplementedError) as want:
        jm.prefill(params, {"tokens": jnp.asarray(toks)}, max_seq=8)
    with pytest.raises(NotImplementedError) as got:
        model.prefill({"tokens": toks}, max_seq=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", MOE + SSM + [VLM])
def test_cache_struct_matches_jax(name):
    """Leaf names, shapes, logical axes and dtypes of the decode cache."""
    from repro.models import transformer as jtfm
    cfg = _small(jconfigs.get_reduced(name)).model
    want = jtfm.cache_struct(cfg, 3, 7)
    got = tfm.cache_struct(_small(tconfigs.get_reduced(name)).model, 3, 7)
    assert got.keys() == want.keys()
    for key, (shape, axes, dtype) in want.items():
        assert got[key][:2] == (shape, axes)
        assert got[key][2] == getattr(torch, str(jnp.dtype(dtype)))


def test_bf16_forward_and_decode_match_jax():
    """The config's own dtype (bfloat16) end to end: logits within
    BF16_TOL of the JAX model's."""
    arch = jconfigs.get_reduced("smollm-360m")
    jm = jbuild(arch)
    params = jm.init(jax.random.key(2))
    model = params_from_numpy(jax.tree.map(np.asarray, params),
                              tconfigs.get_reduced("smollm-360m"),
                              device="cpu")
    toks = _tokens(arch.model, s=8, seed=3)
    logits, _ = model.forward({"tokens": toks})
    assert logits.dtype == torch.bfloat16
    _close(logits, jm.forward(params, {"tokens": jnp.asarray(toks)})[0],
           BF16_TOL)
    jc, tc = jm.init_cache(2, 8), model.init_cache(2, 8)
    for pos in range(8):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(toks[:, pos]),
                                jnp.int32(pos))
        tl, tc = model.decode_step(tc, torch.from_numpy(toks[:, pos]), pos)
    _close(tl, jl, BF16_TOL)
