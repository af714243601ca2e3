"""MLA (DeepSeek's latent attention) and flash attention at dk != dv, the
port against the JAX package on the CPU: ``mla_attention`` (the prefill,
per-head K/V materialised from the latent, attended at dk = nope + rope
and dv) and ``mla_decode`` (absorbed projections against the cached
latent), the widened plain flash version against ``_sdpa``, and the
card's width check, which takes a gradient at every width the forward
takes and refuses wider ones, checked on ``device="meta"`` (no card
needed: the check comes before any kernel).

Tolerances: fp32 ``rtol=atol=1e-5`` (the zoo's); bf16: MLA and the plain
flash version round where the JAX model rounds (the scores' divisor is
bf16(sqrt dk), 13.875 for dk 192), held to the zoo's ``BF16_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models.common import rope as jrope
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import (
    FLASH_MAX_HEAD_DIM, check_attention_shapes,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.kernels.flash_attention.ref import bf16_divisor
from repro_torch.models import attention as tattn
from repro_torch.models.common import Rotary, is_spec

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
DTYPES = ["float32", "bfloat16"]
NAME = "deepseek-v2-lite-16b"


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _tol(dtype):
    return TOL if dtype == "float32" else BF16_TOL


def _both(x, dtype):
    """numpy fp32 -> (jax array, torch tensor) of the same dtype values."""
    jx = jnp.asarray(x, dtype)
    return jx, torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, dtype))


def _mla(dtype, seed=0, full=False):
    """(cfg, JAX params, port params) of one MLA layer (reduced: d_model
    64, 4 heads, latent 32, dk 16 + 8, dv 16; ``full``: the published
    widths with the model narrowed to 2 heads), seeded at the spec's
    scales."""
    get = "get_arch" if full else "get_reduced"
    cfg = getattr(jconfigs, get)(NAME).model.replace(dtype=dtype)
    if full:
        cfg = cfg.replace(num_heads=2, num_kv_heads=2)
    tcfg = getattr(tconfigs, get)(NAME).model.replace(dtype=dtype)
    if full:
        tcfg = tcfg.replace(num_heads=2, num_kv_heads=2)
    assert tattn.mla_spec(tcfg) == jattn.mla_spec(cfg)
    rng = np.random.default_rng(seed)
    leaves = jax.tree.map(
        lambda s: rng.standard_normal(s[0]).astype(np.float32)
        * np.float32(s[2]), jattn.mla_spec(cfg), is_leaf=is_spec)
    pairs = {k: _both(v, dtype) for k, v in leaves.items()}
    return (tcfg, {k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()})


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------- MLA ---

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_mla_spec_equals_jax(reduced):
    get = "get_reduced" if reduced else "get_arch"
    spec = tattn.mla_spec(getattr(tconfigs, get)(NAME).model)
    assert spec == jattn.mla_spec(getattr(jconfigs, get)(NAME).model)
    if not reduced:                       # dk 192 = 128 + 64, dv 128
        assert spec["wq"][0] == (2048, 16, 192)
        assert spec["w_v_up"][0] == (512, 16, 128)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attention_matches_jax(dtype, causal):
    cfg, jp, tp = _mla(dtype)
    jx, tx = _both(_rand((2, 9, cfg.d_model), 1), dtype)
    pos = np.arange(9)
    want = jattn.mla_attention(jx, jp, cfg, causal=causal,
                               positions=jnp.asarray(pos))
    got = tattn.mla_attention(tx, tp, cfg, causal=causal,
                              positions=torch.from_numpy(pos))
    assert got.dtype == tx.dtype and got.shape == want.shape
    _close(got, want, _tol(dtype))
    # a shared Rotary gives the same bits as one made from the positions
    again = tattn.mla_attention(tx, tp, cfg, causal=causal,
                                positions=Rotary(torch.from_numpy(pos),
                                                 cfg.rope_theta))
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attention_at_full_width_heads_matches_jax(dtype):
    """The published head widths (dk 192, dv 128, latent 512) on two
    heads: the plain flash version at dk 192 / dv 128."""
    cfg, jp, tp = _mla(dtype, seed=2, full=True)
    jx, tx = _both(_rand((1, 7, cfg.d_model), 3), dtype)
    pos = np.arange(7)
    _close(tattn.mla_attention(tx, tp, cfg, causal=True,
                               positions=torch.from_numpy(pos)),
           jattn.mla_attention(jx, jp, cfg, causal=True,
                               positions=jnp.asarray(pos)), _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_matches_jax(dtype):
    """One token against a cached latent: the output and both cache leaves
    (this token's latent and rope key written in place at pos)."""
    cfg, jp, tp = _mla(dtype, seed=4)
    S, pos = 12, 7
    jck, tck = _both(_rand((2, S, cfg.kv_lora_rank), 5), dtype)
    jkr, tkr = _both(_rand((2, S, cfg.qk_rope_head_dim), 6), dtype)
    jx, tx = _both(_rand((2, 1, cfg.d_model), 7), dtype)
    jo, jck, jkr = jattn.mla_decode(jx, jp, cfg, jck, jkr, pos)
    to, ock, okr = tattn.mla_decode(tx, tp, cfg, tck, tkr, pos)
    assert ock is tck and okr is tkr                     # updated in place
    _close(to, jo, _tol(dtype))
    _close(tck, jck, _tol(dtype))
    _close(tkr, jkr, _tol(dtype))


def test_mla_decode_continues_the_prefill():
    """The absorbed decode (scores in the latent space) computes the
    materialised prefill's attention: the last position's output of
    mla_attention over a prompt equals mla_decode's at that position with
    the prompt's latents cached (fp32, within TOL)."""
    cfg, _jp, tp = _mla("float32", seed=8)
    x = torch.from_numpy(_rand((2, 6, cfg.d_model), 9))
    full = tattn.mla_attention(x, tp, cfg, causal=True,
                               positions=torch.arange(6))
    ck = torch.zeros(2, 8, cfg.kv_lora_rank)
    kr = torch.zeros(2, 8, cfg.qk_rope_head_dim)
    for pos in range(6):
        out, ck, kr = tattn.mla_decode(x[:, pos:pos + 1], tp, cfg, ck, kr,
                                       pos)
    _close(out[:, 0], full[:, -1].numpy())


def test_mla_bf16_divides_by_bf16_sqrt_dk():
    """JAX divides bf16 scores by the Python float sqrt(dk), which it
    rounds to bf16: 13.875 for MLA's 192."""
    assert bf16_divisor(192 ** -0.5) == 13.875
    assert float(jnp.asarray(192 ** 0.5, jnp.bfloat16)) == 13.875


def test_mla_rope_is_jax_rope():
    cfg, _jp, _tp = _mla("float32")
    x = _rand((2, 5, 3, cfg.qk_rope_head_dim), 10)
    pos = np.arange(5) + 3
    _close(Rotary(torch.from_numpy(pos), cfg.rope_theta)(torch.from_numpy(x)),
           jrope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta))


# ------------------------------------------------- flash at dk != dv -----

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,m,dk,dv", [(4, 2, 24, 16), (3, 3, 16, 24),
                                       (2, 2, 192, 128), (2, 1, 192, 192)])
def test_plain_flash_at_dk_ne_dv_matches_jax_sdpa(h, m, dk, dv, dtype,
                                                  causal):
    jq, q = _both(_rand((2, 11, h, dk), 11), dtype)
    jk, k = _both(_rand((2, 11, m, dk), 12), dtype)
    jv, v = _both(_rand((2, 11, m, dv), 13), dtype)
    want = jattn._sdpa(jq, jk, jv, causal=causal)
    for got in (flash_attention_plain(q, k, v, causal=causal),
                flash_attention(q, k, v, causal=causal),
                tattn.sdpa(q, k, v, causal=causal)):
        assert got.shape == (2, 11, h, dv) and got.dtype == q.dtype
        _close(got, want, _tol(dtype))


def test_flash_gradient_at_dk_ne_dv_on_the_cpu_is_autograd_of_plain():
    """On the CPU nothing is refused: autograd of the plain version."""
    q, k, v = (torch.from_numpy(_rand(s, i)).requires_grad_(True)
               for i, s in enumerate(((1, 5, 2, 24), (1, 5, 2, 24),
                                      (1, 5, 2, 16))))
    flash_attention(q, k, v, causal=True).square().sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (q, k, v))


@pytest.mark.parametrize("dk,dv", [(200, 128), (256, 256), (192, 200)])
def test_card_gradient_beyond_the_backward_kernel_is_refused(dk, dv):
    """A gradient on the card wider than the kernels take (dk or dv above
    192) raises ``ValueError`` naming the head dim (checked on meta
    tensors: the refusal precedes any kernel), never handed to the plain
    version."""
    q = torch.empty(1, 4, 2, dk, device="meta", requires_grad=True)
    k = torch.empty(1, 4, 2, dk, device="meta")
    v = torch.empty(1, 4, 2, dv, device="meta")
    with pytest.raises(ValueError, match=f"head_dim {max(dk, dv)} not in "
                                         f"\\[1, {FLASH_MAX_HEAD_DIM}\\]"):
        flash_attention(q, k, v, causal=True)


def test_card_gradient_within_the_backward_kernel_is_not_refused():
    """dk == dv <= 128 and MLA's dk 192 / dv 128 pass the width check and
    reach the kernel's own checks (which want CUDA tensors)."""
    for dk, dv in ((128, 128), (192, 128)):
        q = torch.empty(1, 4, 2, dk, device="meta", requires_grad=True)
        k = torch.empty(1, 4, 2, dk, device="meta")
        v = torch.empty(1, 4, 2, dv, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_attention(q, k, v, causal=True)


@pytest.mark.parametrize("widths,ok", [
    ((192, 192, 128), True), ((24, 24, 16), True), ((192, 192, 192), True),
    ((200, 200, 128), False), ((192, 192, 200), False),
    ((192, 128, 128), False)])
def test_card_forward_widths_are_checked(widths, ok):
    """The flash kernels (forward and backward) take dk (q, k) and dv up to
    192, k and v alike but for their head dim; the decode kernel keeps k
    and v alike at up to 128."""
    dq, dk, dv = widths
    q, k, v = (torch.empty(1, 4, 2, w) for w in widths)
    wide = dict(max_head_dim=FLASH_MAX_HEAD_DIM, v_width=True)
    if ok:
        check_attention_shapes("flash_attention", q, k, v, **wide)
    else:
        with pytest.raises(ValueError, match="flash_attention"):
            check_attention_shapes("flash_attention", q, k, v, **wide)
    if dq != dv or dq > 128:
        with pytest.raises(ValueError, match="decode_attention"):
            check_attention_shapes("decode_attention", q, k, v)

