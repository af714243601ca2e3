"""The port's ``distributed/sharding.py`` against the JAX package's rules.

For every architecture, every parameter's and optimizer-state leaf's
``param_pspec`` equals JAX's ``ShardingCtx.param_pspec`` on meshes (1,1),
(2,4), (2,2,2), (16,16) and (2,16,16) (JAX's side on an ``AbstractMesh``:
the rules read only sizes and names); ``_effective_ctx`` agrees for train
and decode with and without a batch that divides; the DTensor placements
of a spec on a 2-rank gloo ``DeviceMesh`` give every rank what
``local_shard`` cuts.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import _torch_dist as td
from repro.configs import get_arch as jget_arch
from repro.distributed.step import _effective_ctx as j_effective_ctx
from repro.distributed.step import resolve_shardings as jresolve
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.configs import get_arch, list_archs
from repro_torch.distributed.sharding import ShardingCtx, hint, use_sharding
from repro_torch.distributed.step import (
    _effective_ctx, abstract_params, param_axes, resolve_shardings,
)
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.optim import make_optimizer

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _spec(ps) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in ps)


def _flat_specs(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_specs(tree[k],
                                                            path + (k,))]
    return [("/".join(path), tree)]


def _jax_specs(arch, mesh, kind="train", batch=256):
    ctx = j_effective_ctx(arch, mesh, kind, batch)
    model = jbuild_model(arch)
    params = model.abstract()
    opt = jmake_optimizer(arch.train)
    trees = {"params": jresolve(ctx, model.axes(), params),
             "opt": jresolve(ctx, opt.state_axes(model.axes()),
                             jax.eval_shape(opt.init, params))}
    return ctx, {k: [(p, _spec(s.spec)) for p, s in jax.tree_util.
                     tree_flatten_with_path(v)[0]] for k, v in trees.items()}


def _port_specs(arch, mesh, kind="train", batch=256):
    ctx = _effective_ctx(arch, mesh, kind, batch)
    params = abstract_params(arch.model)
    opt = make_optimizer(arch.train)
    axes = param_axes(arch.model)
    return ctx, {"params": _flat_specs(resolve_shardings(ctx, axes, params)),
                 "opt": _flat_specs(resolve_shardings(
                     ctx, opt.state_axes(axes), opt.init(params)))}


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("name", list_archs())
def test_param_pspec_equals_jax(name, shape, names):
    jctx, jspecs = _jax_specs(jget_arch(name), AbstractMesh(shape, names))
    tctx, tspecs = _port_specs(get_arch(name), abstract_mesh(shape, names))
    assert {k: v for k, v in jctx.map.items()} == tctx.map
    for tree in ("params", "opt"):
        j, t = jspecs[tree], tspecs[tree]
        assert len(j) == len(t), tree
        for (jp, js), (tp, ts) in zip(j, t):
            assert js == ts, (tree, tp, jax.tree_util.keystr(jp), js, ts)


@pytest.mark.parametrize("batch", [256, 96, 1])
@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("shape,names", MESHES[1:3])
def test_effective_ctx_equals_jax(shape, names, kind, batch):
    for name in list_archs():
        j = j_effective_ctx(jget_arch(name), AbstractMesh(shape, names),
                            kind, batch)
        t = _effective_ctx(get_arch(name), abstract_mesh(shape, names),
                           kind, batch)
        assert j.map == t.map, name
        assert (j.rules.dp_over_model, j.rules.fsdp_axis) == \
            (t.rules.dp_over_model, t.rules.fsdp_axis), name
        for dim, axes in [((batch, 64), ("batch", "seq")),
                          ((batch, 64, 960), ("batch", "seq", "embed"))]:
            assert _spec(j.pspec(axes)) == t.pspec(axes), name
            assert [j.fit_axes(d, m) for d, m in zip(dim, j.pspec(axes))] \
                == [t.fit_axes(d, m) for d, m in zip(dim, t.pspec(axes))]


def test_hint_is_the_identity_and_checks_rank():
    import torch
    x = torch.ones(2, 3)
    assert hint(x, "batch", "seq") is x
    ctx = ShardingCtx(abstract_mesh((2, 2), ("data", "model")),
                      get_arch("smollm-360m").sharding)
    with use_sharding(ctx):
        assert hint(x, "batch", "seq") is x
        with pytest.raises(ValueError, match="rank mismatch"):
            hint(x, "batch")
    assert hint(x, "batch") is x


def test_placements_on_a_two_rank_device_mesh():
    specs = [("data", None), (None, "data"), (None, None),
             (("data", "model"), None), (None, ("data", "model")),
             ("model", "data")]
    out = td.run_ranks("placements_check", 2, specs=specs, shape=(4, 6))
    for rank in out:
        for spec, (placements, equal, shape) in zip(specs, rank):
            assert equal, (spec, placements)
    assert out[0][0] == ("(Shard(dim=0), Replicate())", True, (2, 6))
    assert out[1][1] == ("(Shard(dim=1), Replicate())", True, (4, 3))
    assert out[0][2][2] == (4, 6)
    assert out[0][5][0] == "(Shard(dim=1), Shard(dim=0))"


def test_placements_refuse_an_unknown_axis_or_order():
    from repro_torch.distributed.sharding import placements
    with pytest.raises(ValueError, match="lacks"):
        placements(("pod", None), ("data", "model"))
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("model", "data"), None), ("data", "model"))
    assert np.all([p.is_replicate() for p in placements(
        (None, None), ("data", "model"))])
