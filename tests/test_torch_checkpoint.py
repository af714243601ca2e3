"""The port's ``repro_torch.checkpoint``: the cases of the JAX package's
``tests/test_checkpoint.py`` (round trip, structure, retention, no partial
files, the preemption guard, bf16 bit for bit, elastic resume of one
stream), on torch tensors, and files that each package reads from the
other bit for bit."""
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.data.tokens import TokenStream


def _tree():
    return {"a": {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "c": [torch.ones(4, dtype=torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)],
            "step": torch.tensor(3, dtype=torch.int32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return 0


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 3, t, {"note": "x"})
    loaded, meta = ckpt.load_latest(tmp_path)
    assert meta["step"] == 3 and meta["note"] == "x"
    for a, b in zip(_leaves(t), _leaves(loaded)):
        assert torch.equal(a.float(), b.float())


def test_structure_preserved(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    loaded, _ = ckpt.load_latest(tmp_path)
    assert _structure(t) == _structure(loaded)


def test_retention_and_latest(tmp_path):
    for s in (1, 5, 9, 12):
        ckpt.save(tmp_path, s, {"x": torch.tensor(float(s))})
    assert ckpt.list_steps(tmp_path) == [1, 5, 9, 12]
    ckpt.retain(tmp_path, keep=2)
    assert ckpt.list_steps(tmp_path) == [9, 12]
    loaded, meta = ckpt.load_latest(tmp_path)
    assert float(loaded["x"]) == 12.0 and meta["step"] == 12


def test_no_partial_files_on_disk(tmp_path):
    ckpt.save(tmp_path, 2, _tree())
    assert not list(tmp_path.glob(".tmp*"))


def test_preemption_guard():
    g = ckpt.PreemptionGuard(lifetime_s=0.5, margin_s=0.2)
    g.record_step(0.05)
    assert not g.should_checkpoint()
    time.sleep(0.35)
    assert g.should_checkpoint()
    g.renew()
    assert not g.should_checkpoint()


def test_preemption_guard_rule_and_ema():
    """budget = lifetime - margin - elapsed fires below twice the EMA of
    the step times (0.9 old + 0.1 new; at least 1 ms)."""
    g = ckpt.PreemptionGuard(lifetime_s=100.0, margin_s=10.0)
    assert g._ema == 0.0
    g.record_step(2.0)
    assert g._ema == 2.0
    g.record_step(4.0)
    assert abs(g._ema - (0.9 * 2.0 + 0.1 * 4.0)) < 1e-12
    g._t0 -= 100.0 - 10.0 - 2 * g._ema - 0.5     # 0.5 s before the line
    assert not g.should_checkpoint()
    g._t0 -= 1.0
    assert g.should_checkpoint()
    assert ckpt.PreemptionGuard(lifetime_s=0.0).should_checkpoint()


def test_roundtrip_is_bit_exact_and_dtype_preserving(tmp_path):
    rng = np.random.default_rng(0)
    t = {"w": torch.from_numpy(rng.standard_normal((3, 5)).astype(
            np.float32)).to(torch.bfloat16),
         "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)),
         "n": torch.tensor(-42, dtype=torch.int32)}
    ckpt.save(tmp_path, 4, t)
    loaded, _ = ckpt.load(tmp_path, 4)
    for k in t:
        a, b = t[k], loaded[k]
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), k


def test_load_specific_step_and_empty_dir(tmp_path):
    ckpt.save(tmp_path, 1, {"x": torch.tensor(1.0)})
    ckpt.save(tmp_path, 2, {"x": torch.tensor(2.0)})
    loaded, meta = ckpt.load(tmp_path, 1)
    assert float(loaded["x"]) == 1.0 and meta["step"] == 1
    empty = tmp_path / "nothing"
    empty.mkdir()
    assert ckpt.load_latest(empty) == (None, None)


def test_elastic_resume_same_stream(tmp_path):
    """Train 2 workers, checkpoint, resume with 3 workers: the global sample
    order continues without gaps or repeats."""
    streams = [TokenStream(64, seed=5, worker=w, num_workers=2)
               for w in range(2)]
    for _ in range(2):
        for s in streams:
            s.batch(4, 8)
    pos = streams[0].position
    ckpt.save(tmp_path, 0, {"pos": torch.tensor(pos, dtype=torch.int32)},
              streams[0].state())
    _loaded, meta = ckpt.load_latest(tmp_path)
    new = [TokenStream(64) for _ in range(3)]
    for w, s in enumerate(new):
        s.restore(meta, w, 3)
    assert all(s.position == pos for s in new)
    idx = sorted(pos + i * 3 + w for w in range(3) for i in range(4))
    assert idx == list(range(pos, pos + 12))


def test_files_cross_between_the_packages_bit_for_bit(tmp_path):
    """A tree the JAX package saves loads in the port with the same bits,
    dtypes and structure, and the other way round."""
    import jax.numpy as jnp
    from repro import checkpoint as jckpt
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    jt = {"params": {"w": jnp.asarray(w, jnp.bfloat16),
                     "b": jnp.asarray(w[0])},
          "opt": {"step": jnp.int32(5), "m": {"w": jnp.asarray(w)}}}
    jckpt.save(tmp_path / "j", 5, jt, {"stream": {"position": 8, "seed": 0}})
    got, meta = ckpt.load_latest(tmp_path / "j")
    assert meta == {"stream": {"position": 8, "seed": 0}, "step": 5}
    assert got["params"]["w"].dtype == torch.bfloat16
    assert np.array_equal(got["params"]["w"].view(torch.int16).numpy(),
                          np.asarray(jt["params"]["w"]).view(np.int16))
    assert np.array_equal(got["opt"]["m"]["w"].numpy(), w)
    assert got["opt"]["step"].dtype == torch.int32 and \
        int(got["opt"]["step"]) == 5
    ckpt.save(tmp_path / "t", 7, got, meta)
    back, meta2 = jckpt.load_latest(tmp_path / "t")
    assert meta2["step"] == 7
    assert back["params"]["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back["params"]["w"]).view(np.int16),
                          np.asarray(jt["params"]["w"]).view(np.int16))
    assert np.array_equal(np.asarray(back["opt"]["m"]["w"]), w)
    ckpt.save(tmp_path / "t2", 5, got, {"stream": meta["stream"]})
    with np.load(tmp_path / "j" / "step_0000000005.npz") as za, \
            np.load(tmp_path / "t2" / "step_0000000005.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
