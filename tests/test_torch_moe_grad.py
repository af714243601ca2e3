"""Training the MoE family through the port on the CPU against the JAX
package: the gradients of ``moe_block`` and ``mla_attention`` against
``jax.vjp`` of the JAX functions, the plain flash backward at dk != dv
against float64, and ``ArchWorkload.grad`` of the reduced grok-1-314b and
deepseek-v2-lite-16b against the JAX ``ArchWorkload.grad`` from the JAX
init carried across (``flat_from_numpy``).

Tolerances: fp32 gradients within 1e-5 of each leaf's largest |g| (sums
in other orders; the zoo's ``TOL``), the losses within 1e-5 relative; bf16
MLA at the zoo's ``BF16_TOL``.  The routing is discrete: the gradient
flows through the renormalised gates and the aux loss's mean gates, never
through the chosen experts or their counts, and a dropped assignment
(past an expert's capacity) gets none, as in JAX.  A whole-model match
could hang on a near-tie gate routed either way by the two frameworks'
rounding, so the workload tests also hold every token's K-th and
(K+1)-th gates further apart than the two frameworks' gates differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core.workloads import ArchWorkload as JArchWorkload
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.core.workloads import ArchWorkload, flat_from_numpy
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd_plain
from repro_torch.models import attention as tattn
from repro_torch.models import moe
from test_torch_mla import _both, _mla, _rand
from test_torch_moe import MOE, _block_params, _cfgs, _dropped, _x

GRAD_TOL = 1e-5
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _hold(port, ref, tol=GRAD_TOL, what=""):
    """port within ``tol`` of ref's largest |value| (and relative)."""
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    big = float(np.abs(ref).max())
    np.testing.assert_allclose(port, ref, rtol=tol, atol=tol * big,
                               err_msg=what)


def _moe_case(name, case):
    """(JAX cfg, port cfg, JAX params, port params, JAX x, port x) of one
    MoE block: ``drops`` at a capacity factor of 0.5 (assignments past
    capacity), ``ties`` with two equal router columns (equal gates)."""
    if case == "drops":
        jcfg, tcfg = _cfgs(name, capacity_factor=0.5)
        jp, tp = _block_params(jcfg, seed=11)
        jx, tx = _x(jcfg, 3, 11, seed=12)
        assert _dropped(jcfg, jx, jp) > 0
    else:
        jcfg, tcfg = _cfgs(name)
        jp, tp = _block_params(jcfg, seed=13)
        router = np.asarray(jp["router"]).copy()
        router[:, 1] = router[:, 0]
        jp = dict(jp, router=jnp.asarray(router))
        tp = dict(tp, router=torch.from_numpy(router))
        jx, tx = _x(jcfg, 2, 5, seed=14)
    return jcfg, tcfg, jp, tp, jx, tx


@pytest.mark.parametrize("case", ["drops", "ties"])
@pytest.mark.parametrize("name", MOE)
def test_moe_block_gradient_is_jax_vjp(name, case):
    """Autograd of the port's moe_block against jax.vjp of the JAX one for
    the same cotangents (dy from a seed, d aux 0.7): dx and every
    parameter's gradient, fp32, within GRAD_TOL of its largest |g|."""
    jcfg, tcfg, jp, tp, jx, tx = _moe_case(name, case)
    dy = np.random.default_rng(15).standard_normal(jx.shape).astype(
        np.float32)
    (jy, jaux), vjp = jax.vjp(lambda x, p: jmoe.moe_block(x, p, jcfg),
                              jx, jp)
    jdx, jdp = vjp((jnp.asarray(dy), jnp.float32(0.7)))
    leaves = [tx.requires_grad_(True)] + [
        t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    ty, taux = moe.moe_block(tx, tp, tcfg)
    grads = torch.autograd.grad(
        (ty * torch.from_numpy(dy)).sum() + 0.7 * taux, leaves)
    _hold(grads[0], jdx, what="dx")
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jdp)[0]]
    for path, got, want in zip(paths, grads[1:], jax.tree.leaves(jdp)):
        assert float(np.abs(np.asarray(want)).max()) > 0.0, path
        _hold(got, want, what=path)


def test_dropped_assignments_get_no_gradient():
    """An assignment past its expert's capacity contributes nothing: a
    token all of whose assignments are dropped has no routed gradient
    (only the shared experts' and the aux loss's), as in jax.vjp."""
    jcfg, tcfg = _cfgs("grok-1-314b", capacity_factor=0.25)
    jp, tp = _block_params(jcfg, seed=16)
    jx, tx = _x(jcfg, 2, 16, seed=17)
    T, K = 32, jcfg.experts_per_token
    gates = torch.softmax(tx.reshape(T, -1) @ tp["router"], -1)
    _, idx = moe.route(gates, K)
    C = moe._capacity(T, tcfg)
    seen = torch.zeros(jcfg.num_experts, dtype=torch.long)
    kept = torch.zeros(T, dtype=torch.bool)
    for t in range(T):
        for e in idx[t].tolist():
            kept[t] |= bool(seen[e] < C)
            seen[e] += 1
    assert not bool(kept.all()), "no token lost every assignment"
    tx.requires_grad_(True)
    y, _ = moe.moe_block(tx, tp, tcfg)
    (dx,) = torch.autograd.grad(y.sum(), tx)
    lost = ~kept.reshape(2, 16)
    assert bool((dx[lost] == 0).all()) and bool((dx[~lost] != 0).any())
    _, vjp = jax.vjp(lambda x: jmoe.moe_block(x, jp, jcfg)[0], jx)
    (jdx,) = vjp(jnp.ones_like(jx))
    np.testing.assert_array_equal(np.asarray(jdx)[lost.numpy()], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_attention_gradient_is_jax_vjp(dtype):
    """Autograd of the port's mla_attention (the plain flash version on
    the CPU, at the reduced MLA's dk 24 / dv 16) against jax.vjp of the
    JAX one: dx and every parameter's gradient, fp32 within GRAD_TOL of
    its largest |g|, bf16 within BF16_TOL."""
    cfg, jp, tp = _mla(dtype, seed=18)
    assert (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
            cfg.v_head_dim) == (24, 16)
    jx, tx = _both(_rand((2, 9, cfg.d_model), 19), dtype)
    jdo, tdo = _both(_rand((2, 9, cfg.d_model), 20), dtype)
    pos = np.arange(9)
    _, vjp = jax.vjp(lambda x, p: jattn.mla_attention(
        x, p, cfg, causal=True, positions=jnp.asarray(pos)), jx, jp)
    jdx, jdp = vjp(jdo)
    names = sorted(tp)
    leaves = [tx.requires_grad_(True)] + [tp[k].requires_grad_(True)
                                          for k in names]
    out = tattn.mla_attention(tx, tp, cfg, causal=True,
                              positions=torch.from_numpy(pos))
    grads = torch.autograd.grad(out, leaves, tdo)
    assert all(g.dtype == getattr(torch, dtype) for g in grads)
    for what, got, want in zip(["dx"] + names, grads,
                               [jdx] + [jdp[k] for k in names]):
        if dtype == "float32":
            _hold(got, want, what=what)
        else:
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       err_msg=what, **BF16_TOL)


def _attention_float64(q, k, v, causal):
    """Attention in float64 on the model's layout, GQA by repeating kv
    heads: q (b, s, h, dk), k (b, s, m, dk), v (b, s, m, dv)."""
    g = q.shape[2] // k.shape[2]
    kk, vv = (t.repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,m,dk,dv", [(4, 2, 24, 16), (2, 2, 192, 128),
                                       (3, 1, 16, 24)])
def test_flash_bwd_plain_at_dk_ne_dv_matches_float64(h, m, dk, dv, causal):
    """flash_attention_bwd_plain (fp32) at dk != dv: dq and dk at dk, dv
    at dv, each within 1e-5 of its largest |g| of autograd of attention in
    float64."""
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((2, 13, h, dk), (2, 13, m, dk),
                               (2, 13, m, dv), (2, 13, h, dv)))
    got = flash_attention_bwd_plain(q, k, v, do, causal=causal)
    assert [tuple(g.shape) for g in got] == [
        (2, 13, h, dk), (2, 13, m, dk), (2, 13, m, dv)]
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    exact = torch.autograd.grad(_attention_float64(*leaves, causal),
                                leaves, do.double())
    for name, a, x in zip(("dq", "dk", "dv"), got, exact):
        _hold(a, x.numpy(), what=name)


# ------------------------------------------------------ ArchWorkload.grad ---

def _fp32(mp):
    """The reduced configs in fp32 in both packages (the parity of the
    function, not of bf16 rounding)."""
    import repro.configs as jconfigs
    from repro_torch.core import workloads as tworkloads
    for module in (jconfigs, tworkloads):
        get = module.get_reduced

        def get_reduced(name, get=get):
            arch = get(name)
            return arch.replace(model=arch.model.replace(dtype="float32"))
        mp.setattr(module, "get_reduced", get_reduced)


def _gate_records(mp, module, attr, gates_of):
    """Wrap ``module.attr`` (a router's top-k) to keep each call's gates."""
    kept, inner = [], getattr(module, attr)

    def wrapped(gates, k):
        kept.append(np.asarray(gates_of(gates), np.float64))
        return inner(gates, k)
    mp.setattr(module, attr, wrapped)
    return kept


def _margin(gates, k) -> float:
    """The least gap between a token's K-th and (K+1)-th largest gate."""
    top = -np.sort(-gates.reshape(-1, gates.shape[-1]), axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.mark.parametrize("name", ["deepseek_v2_lite_16b", "grok_1_314b"])
def test_arch_workload_grad_matches_jax(name):
    """The port's ArchWorkload.grad against the JAX one on one batch (b 8,
    s 64: deepseek's capacity drops assignments), fp32, from the JAX init:
    the loss within 1e-5, each leaf within GRAD_TOL of its largest |g|
    (every leaf's gradient non-zero), and every MoE layer's routing clear
    of ties: each token's K-th gate exceeds its (K+1)-th by more than the
    two frameworks' gates differ."""
    with pytest.MonkeyPatch.context() as mp:
        _fp32(mp)
        jw, tw = JArchWorkload(name), ArchWorkload(name)
        assert tw.n_params == jw.n_params and tw.cfg.dtype == "float32"
        params = jw.init(jax.random.key(0))
        tree = jax.tree.map(np.asarray, params)
        ds = tw.make_data(8)
        jb = {"x": jnp.asarray(ds.x), "y": jnp.asarray(ds.y)}
        tb = {"x": torch.from_numpy(ds.x), "y": torch.from_numpy(ds.y)}
        jloss, jgrad = jw.grad(params, jb)
        flat = flat_from_numpy(tree, tw)
        loss, g = tw.grad(flat, tb)
        # the routers' gates of one forward in each framework
        jgates = _gate_records(mp, jax.lax, "top_k", lambda a: a)
        tgates = _gate_records(mp, moe, "route", lambda a: a.numpy())
        jw._model.loss(params, {"tokens": jb["x"], "labels": jb["y"]},
                       remat="none", scan_layers=False)
        with torch.no_grad():
            tw._loss(tw.params(flat), tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = np.asarray(ravel_pytree(jgrad)[0], np.float32)
    off = 0
    for path, shape in tw.layout:
        n = int(np.prod(shape))
        ref = want[off:off + n]
        assert float(np.abs(ref).max()) > 0.0, path
        _hold(g[off:off + n], ref, what="/".join(path))
        off += n
    k = tw.cfg.experts_per_token
    assert len(jgates) == len(tgates) == tw.cfg.num_layers \
        - tw.cfg.first_k_dense
    for jg, tg in zip(jgates, tgates):
        apart = float(np.abs(jg.reshape(tg.shape) - tg).max())
        assert min(_margin(jg, k), _margin(tg, k)) > apart


@pytest.mark.parametrize("name", ["deepseek_v2_lite_16b", "grok_1_314b"])
def test_grad_accumulates_into_one_flat_gradient(name):
    """ArchWorkload.grad fills the flat gradient in place (autograd adds
    into views of it, no third copy): the same values as autograd.grad of
    the loss over the per-layer leaves, bit for bit."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import is_spec
    wl = ArchWorkload(name)
    flat = wl.init(torch.Generator().manual_seed(1))
    b = wl.make_data(4, seed=2)
    batch = {"x": torch.from_numpy(b.x), "y": torch.from_numpy(b.y)}
    loss, g = wl.grad(flat, batch)

    def per_layer(spec, tree, leaf):
        """``tree`` with each stacked leaf as nested lists of its per-layer
        slices, ``leaf`` applied to each slice."""
        if not is_spec(spec):
            return {k: per_layer(spec[k], tree[k], leaf) for k in spec}

        def split(t, axes):
            if axes and axes[0] in ("layers", "inner"):
                return [split(t[i], axes[1:]) for i in range(t.shape[0])]
            return leaf(t)
        return split(tree, spec[1])

    spec = tfm.model_spec(wl.cfg)
    leaves, got = [], []

    def live(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]
    tree = per_layer(spec, wl.params(flat.detach()), live)
    with torch.enable_grad():
        want = torch.autograd.grad(wl._loss(tree, batch), leaves)
    per_layer(spec, wl.params(g), got.append)
    assert len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    assert g.dtype == flat.dtype == wl.dtype
