"""``repro_torch.launch.specs`` against the JAX package's
``repro.launch.specs``: ``make_batch`` value for value (bit for bit) for
every arch, and ``input_specs`` leaf for leaf (shape and dtype; the port's
stand-ins are tensors on the ``meta`` device, JAX's ``ShapeDtypeStruct``)
for every arch and shape cell."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES
from repro.launch import specs as jspecs
from repro_torch import configs as tconfigs
from repro_torch.launch import specs


def _as_np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        return x.numpy(), str(x.dtype).removeprefix("torch.")
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        return np.asarray(x.view(jnp.int16)), "bfloat16"
    return np.asarray(x), str(x.dtype)


@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_make_batch_equals_jax_bit_for_bit(name):
    got = specs.make_batch(tconfigs.get_reduced(name), 3, 11, seed=5,
                           device="cpu")
    want = jspecs.make_batch(jconfigs.get_reduced(name), 3, 11, seed=5)
    assert list(got) == list(want)          # the draw order, key by key
    for key in want:
        (a, da), (b, db) = _as_np(got[key]), _as_np(want[key])
        assert da == db, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_bf16_draws_round_through_fp32_as_jax():
    """A float64 just above a bf16 midpoint rounds to the midpoint in fp32
    and then to even in bf16 (two roundings), as ``jnp.asarray(x,
    bfloat16)`` does; one rounding would go up."""
    x = np.array([1 + 2.0 ** -8 + 2.0 ** -30, -(1 + 2.0 ** -8 + 2.0 ** -30),
                  0.5])
    want = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = specs._bf16(x).float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1.0, -1.0, 0.5])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                        path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", jconfigs.ARCH_IDS)
def test_input_specs_equal_jax(name, shape):
    arch, jarch = tconfigs.get_arch(name), jconfigs.get_arch(name)
    if SHAPES[shape].kind == "decode" and not jarch.model.supports_decode:
        with pytest.raises(ValueError):
            jspecs.input_specs(jarch, shape)
        with pytest.raises(ValueError):
            specs.input_specs(arch, shape)
        return
    want = jspecs.input_specs(jarch, shape)
    got = specs.input_specs(arch, shape)
    w, g = _leaves(want), _leaves(got)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(w, g):
        assert b.device.type == "meta", path
        assert tuple(b.shape) == tuple(a.shape), path
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
    jax.clear_caches()
