"""The port's study models and algorithms against the JAX package, on the
CPU, from the same carried-over parameters and the same batch.

Tolerance: ``rtol=1e-5, atol=1e-6`` -- the two frameworks sum the same fp32
products in different orders (matrix products, reductions), so results
agree to a few ulps, not bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import algorithms as jalg
from repro.core import mlmodels as jmod
from repro.data import synthetic as jdata
from repro_torch.core import algorithms as talg
from repro_torch.core import mlmodels as tmod
from repro_torch.data import synthetic as tdata

TOL = dict(rtol=1e-5, atol=1e-6)


def _models(name, dataset="higgs", rows=600):
    jds = jdata.make_dataset(dataset, rows=rows, seed=0)
    tds = tdata.make_dataset(dataset, rows=rows, seed=0)
    for a, b in ((jds.x, tds.x), (jds.y, tds.y), (jds.idx, tds.idx)):
        assert (a is None and b is None) or a.tobytes() == b.tobytes()
    if name == "mlp":
        jm = jmod.make_mlp(jds, target_mb=0.05, name="mlp")
        tm = tmod.make_mlp(tds, target_mb=0.05, name="mlp")
    else:
        jm = jmod.make_study_model(name, jds)
        tm = tmod.make_study_model(name, tds)
    return jds, tds, jm, tm


def _params(name, jm, tm, seed=0):
    """Reference params (random, so gradients are not trivially zero) and
    the port's copy of them via params_from_numpy."""
    p = jm.init(jax.random.key(seed))
    if name in ("lr", "svm"):
        p = jnp.asarray(np.random.default_rng(seed).standard_normal(p.shape)
                        .astype(np.float32) * 0.3)
    leaves = [np.asarray(leaf) for leaf in jax.tree.leaves(p)]
    return p, tmod.params_from_numpy(tm, leaves)


def _jbatch(ds, lo, hi):
    b = {"x": jnp.asarray(ds.x[lo:hi]), "y": jnp.asarray(ds.y[lo:hi])}
    if ds.sparse:
        b["idx"] = jnp.asarray(ds.idx[lo:hi])
    return b


def _flat(p) -> np.ndarray:
    return np.asarray(ravel_pytree(p)[0])


@pytest.mark.parametrize("name,dataset", [
    ("lr", "higgs"), ("lr", "rcv1"), ("svm", "higgs"), ("mlp", "higgs"),
    ("mlp", "cifar10"),
])
def test_loss_and_grad_match(name, dataset):
    jds, tds, jm, tm = _models(name, dataset, rows=300)
    p, tp = _params(name, jm, tm)
    assert _flat(p).tobytes() == tp.numpy().tobytes()
    loss, g = jm.grad(p, _jbatch(jds, 0, 256))
    tloss, tg = tm.grad(tp, tmod.device_data(tds, "cpu", 0, 256))
    np.testing.assert_allclose(float(tloss), float(loss), **TOL)
    np.testing.assert_allclose(tg.reshape(-1).numpy(), _flat(g), **TOL)
    np.testing.assert_allclose(
        tm.eval_loss(tp, tmod.device_data(tds, "cpu")),
        jm.eval_loss(p, jds), **TOL)


def test_kmeans_stats_match():
    jds, tds, jm, tm = _models("kmeans", rows=500)
    p, tp = _params("kmeans", jm, tm)
    s = jm.local_stats(p, _jbatch(jds, 0, jds.n))
    ts = tm.local_stats(tp, tmod.device_data(tds, "cpu"))
    for k in ("sums", "counts", "sse"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(s[k]), **TOL)
    np.testing.assert_allclose(tm.apply_stats(tp, ts).numpy(),
                               np.asarray(jm.apply_stats(p, s)), **TOL)


def test_mlp_layout_is_the_jax_ravel_order():
    """w0 (in, out) row-major, b0, w1, b1, ... -- so the codecs' 256-element
    blocks cover the same elements in both packages."""
    jds, tds, jm, tm = _models("mlp")
    p, tp = _params("mlp", jm, tm)
    net = tmod.MLP(tmod._mlp_sizes(tds.d, tds.n_classes, 0.05))
    for (w, b), (tw, tb) in zip(p, net.layers(tp)):
        assert tw.shape == w.shape and tb.shape == b.shape
        assert tw.numpy().tobytes() == np.asarray(w).tobytes()
        assert tb.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("name,algo,kw", [
    ("lr", "ga_sgd", dict(lr=0.3, batch_size=64)),
    ("lr", "ma_sgd", dict(lr=0.3, batch_size=64)),
    ("lr", "admm", dict(lr=0.1, batch_size=64, local_epochs=2)),
    ("svm", "ga_sgd", dict(lr=0.3, batch_size=64)),
    ("svm", "admm", dict(lr=0.1, batch_size=64, local_epochs=2)),
    ("mlp", "ga_sgd", dict(lr=0.05, batch_size=64)),
    ("mlp", "ma_sgd", dict(lr=0.05, batch_size=64)),
    ("kmeans", "kmeans_em", {}),
])
def test_local_update_and_apply_merged_match(name, algo, kw):
    jds, tds, jm, tm = _models(name, rows=300)
    p, tp = _params(name, jm, tm)
    ja, ta = jalg.make_algorithm(algo, **kw), talg.make_algorithm(algo, **kw)
    js, ts = ja.init_worker(jm, p, jds), ta.init_worker(tm, tp, tds)
    ju = ja.local_update(jm, js, 1)
    tu = ta.local_update(tm, ts, 1)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    # merge: the worker's own update scaled, as a w-worker average would be
    merged = np.asarray(ju, np.float32) * np.float32(0.5)
    ja.apply_merged(jm, js, merged, 2)
    ta.apply_merged(tm, ts, torch.from_numpy(merged), 2)
    np.testing.assert_allclose(ts.params.reshape(-1).numpy(),
                               _flat(ja.eval_params(js)), **TOL)
