"""Where the port's bf16 numbers part from the JAX package's on the CPU
(reduced zamba2-2.7b and mamba2-370m): the readings behind the zamba2
note in ``_torch_arch_preset.py``.

    PYTHONPATH=src python tests/_torch_bf16_witness.py

1. Block by block, each package's function on the same bf16 input and
   parameters (the JAX ones jitted, as its training step is): the share
   of output elements that differ, and the largest and the norm-wise gap.
2. One bf16 gradient of each model against ``jax.value_and_grad``: the
   loss gap and the norm-wise gradient gap, with the port as it is (its
   attention rounds where the JAX ``_sdpa`` rounds), and with XLA's CPU
   expansion of a bf16 ``silu`` (five steps, each rounded to bf16)
   mimicked in the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from repro.core import workloads as jworkloads
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.core.workloads import ArchWorkload, flat_from_numpy
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf


def _gap(t, j) -> str:
    t = t.float().numpy().astype(np.float64)
    j = np.asarray(j, np.float32).astype(np.float64)
    d = np.abs(t - j)
    return (f"{np.mean(d > 0):.3%} of elements differ, max {d.max() / np.abs(j).max():.2e}"
            f", norm-wise {np.linalg.norm(t - j) / np.linalg.norm(j):.2e}")


def _pair(name):
    jw, tw = jworkloads.ArchWorkload(name), ArchWorkload(name)
    tree = jax.tree.map(np.asarray, jw.init(jax.random.key(0)))
    return jw, tw, tree


def blocks(name: str) -> None:
    jw, tw, tree = _pair(name)
    cj, ct = jw.arch.model, tw.cfg
    tp, jp = tw.params(flat_from_numpy(tree, tw)), jax.tree.map(jnp.asarray,
                                                              tree)
    x = (np.random.default_rng(0).standard_normal((8, 64, ct.d_model))
         * 0.5).astype(np.float32)
    xt, xj = torch.from_numpy(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)
    if ct.family == "hybrid":
        jb = jax.tree.map(lambda a: a[0, 0], jp["blocks"]["ssm"])
        tb = ttf._slice(ttf.layer(tp, 0)["ssm"], 0)
    else:
        jb, tb = jax.tree.map(lambda a: a[0], jp["blocks"]), ttf.layer(tp, 0)
    m_t, m_j = tb["mixer"], jb["mixer"]
    h = tcommon.rms_norm(xt, tb["ln"], ct.norm_eps)
    hj = jnp.asarray(h.float().numpy(), jnp.bfloat16)
    print(f"{name} (reduced, bf16), on the same inputs:")
    print("  rms_norm:", _gap(h, jax.jit(
        lambda a, s: jcommon.rms_norm(a, s, cj.norm_eps))(xj, jb["ln"])))
    print("  in_x GEMM:", _gap(h @ m_t["in_x"],
                               jax.jit(lambda a, w: a @ w)(hj, m_j["in_x"])))
    xs = h @ m_t["in_x"]
    xsj = jnp.asarray(xs.float().numpy(), jnp.bfloat16)
    conv_t = tssm._conv1d_causal(xs, m_t["conv_x"], m_t["conv_x_b"])[0]
    print("  causal conv:", _gap(conv_t, jax.jit(
        lambda a, w, b: jssm._conv1d_causal(a, w, b)[0])(
            xsj, m_j["conv_x"], m_j["conv_x_b"])))
    cj_in = jnp.asarray(conv_t.float().numpy(), jnp.bfloat16)
    print("  silu:", _gap(F.silu(conv_t), jax.jit(jax.nn.silu)(cj_in)))
    print("  Mamba2 block:", _gap(ttf._ssm_block(xt, tb, ct), jax.jit(
        lambda a, p: jtf._ssm_block(a, p, cj))(xj, jb)))
    if ct.family == "hybrid":
        sj = jp["shared_attn"]
        print("  attention block:", _gap(
            ttf._attn_block(xt, tp["shared_attn"], ct, causal=True,
                            positions=torch.arange(64)),
            jax.jit(lambda a, p: jtf._attn_block(
                a, p, cj, causal=True, positions=jnp.arange(64),
                ff_fn=lambda q: jtf.mlp_apply(q, p["mlp"], cj)))(xj, sj)))


def _xla_cpu_silu(x, _silu=F.silu):
    """XLA's CPU expansion of a bf16 silu: x / (1 + exp(-x)) in five
    steps, each rounded to bf16."""
    if x.dtype != torch.bfloat16:
        return _silu(x)
    r = lambda t: t.bfloat16().float()  # noqa: E731
    xf = x.float()
    sig = r(1.0 / r(r(torch.exp(r(-xf))) + 1.0))
    return (xf * sig).bfloat16()


def gradient(name: str, silu_like_xla=False):
    jw, tw, tree = _pair(name)
    ds = tw.make_data(8, seed=2)
    jl, jg = jw.grad(jax.tree.map(jnp.asarray, tree),
                     {"x": jnp.asarray(ds.x), "y": jnp.asarray(ds.y)})
    jg = np.asarray(ravel_pytree(jg)[0], np.float32).astype(np.float64)
    kept = F.silu
    if silu_like_xla:
        F.silu = _xla_cpu_silu
    try:
        tl, tg = tw.grad(flat_from_numpy(tree, tw),
                         {"x": torch.from_numpy(ds.x),
                          "y": torch.from_numpy(ds.y)})
    finally:
        F.silu = kept
    tg = tg.float().numpy().astype(np.float64)
    print(f"  {name} gradient (silu as XLA's CPU: {silu_like_xla}): "
          f"loss gap {abs(float(tl) - float(jl)) / abs(float(jl)):.2e}, "
          f"norm-wise {np.linalg.norm(tg - jg) / np.linalg.norm(jg):.3e}")


def main() -> None:
    torch.set_num_threads(4)
    for name in ("zamba2_2_7b", "mamba2_370m"):
        blocks(name)
    for name in ("zamba2_2_7b", "mamba2_370m", "smollm_360m"):
        for silu in (False, True):
            gradient(name, silu)


if __name__ == "__main__":
    main()
