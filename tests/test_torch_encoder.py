"""The encoder family (hubert-xlarge, reduced: 2 bidirectional layers,
frames in, 32 cluster targets) against the JAX package, on the CPU, with
the JAX parameters carried across and batches from ``make_batch``.

Tolerances: fp32 ``rtol=1e-5, atol=1e-5`` (tests/test_torch_zoo.py);
bf16 ``BF16_TOL``; gradients ``GRAD_TOL`` of each leaf's largest |g|
(chip_smoke.py's full-width limit, 2e-5); one AdamW step of the arch's
own ``TrainConfig`` (lr 3e-4, clip 1.0): each parameter's step, / lr,
within ``STEP_U_TOL`` of JAX's.  A first AdamW step is u = m^ / (sqrt(v^)
+ 1e-8) ~ sign(g), which moves by about dg x 1e-8 / (|g| + 1e-8)^2: the
gradients' own last-bit differences move the u of a gradient near 1e-8 by
up to dg / 4e-8 (measured 7.7e-4 at this size).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.specs import make_batch as jmake_batch
from repro.models import build_model as jbuild
from repro.models import transformer as jtfm
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import configs as tconfigs
from repro_torch.launch.specs import make_batch
from repro_torch.models import params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.optim import make_optimizer
from repro_torch.serving import Generator, LatencyModel

NAME = "hubert-xlarge"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
GRAD_TOL = 2e-5
STEP_U_TOL = 5e-3


def _np(t):
    return t.detach().float().numpy()


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(_np(port), np.asarray(
        jnp.asarray(ref).astype(jnp.float32)), **tol)


def _dt(arch, dtype):
    return arch.replace(model=arch.model.replace(dtype=dtype))


_PAIRS = {}


def _pair(dtype="float32"):
    if dtype not in _PAIRS:
        jarch = _dt(jconfigs.get_reduced(NAME), dtype)
        arch = _dt(tconfigs.get_reduced(NAME), dtype)
        jm = jbuild(jarch)
        params = jm.init(jax.random.key(0))
        model = params_from_numpy(jax.tree.map(np.asarray, params), arch,
                                  device="cpu")
        _PAIRS[dtype] = (arch, jarch, jm, params, model)
    return _PAIRS[dtype]


def _batches(arch, jarch, b=2, s=8, seed=0):
    return (make_batch(arch, b, s, seed=seed, device="cpu"),
            jmake_batch(jarch, b, s, seed=seed))


def test_encoder_has_no_embed_and_reads_frames():
    arch, _jarch, _jm, params, model = _pair()
    assert "embed" not in model.params and "embed" not in params
    assert model.device == torch.device("cpu")
    batch = make_batch(arch, 2, 8, device="cpu")
    assert set(batch) == {"frames", "labels", "mask"}
    assert batch["frames"].dtype == torch.bfloat16
    assert batch["mask"].dtype == torch.bool


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_masked_loss_match_jax(dtype):
    arch, jarch, jm, params, model = _pair(dtype)
    batch, jbatch = _batches(arch, jarch)
    tol = TOL if dtype == "float32" else BF16_TOL
    logits, aux = model.forward(batch)
    jlogits, _ = jm.forward(params, jbatch)
    assert logits.shape == (2, 8, 32) and float(aux) == 0.0
    assert logits.dtype == getattr(torch, dtype)
    _close(logits, jlogits, tol)
    (total, parts), (jtotal, jparts) = model.loss(batch), jm.loss(params,
                                                                jbatch)
    _close(total, jtotal, tol)
    _close(parts["loss"], jparts["loss"], tol)


def test_encoder_is_bidirectional():
    """Perturbing the LAST frame moves position 0's output (JAX's
    ``test_encoder_is_bidirectional``), to JAX's perturbed value."""
    arch, jarch, jm, params, model = _pair()
    batch, jbatch = _batches(arch, jarch, b=1, s=8)
    out1, _ = model.forward(batch)
    frames = batch["frames"].clone()
    frames[:, -1] += 1.0
    out2, _ = model.forward(dict(batch, frames=frames))
    assert float((out1[:, 0] - out2[:, 0]).abs().max()) > 1e-6
    jout2, _ = jm.forward(params, dict(
        jbatch, frames=jbatch["frames"].at[:, -1].add(1.0)))
    _close(out2, jout2)


def test_masked_loss_ignores_unmasked_labels():
    arch, jarch, _jm, _params, model = _pair()
    batch, _ = _batches(arch, jarch, b=2, s=8)
    loss1, _ = model.loss(batch)
    vocab = arch.model.vocab_size
    labels = torch.where(batch["mask"], batch["labels"],
                         (batch["labels"] + 7) % vocab)
    loss2, _ = model.loss(dict(batch, labels=labels))
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-6)
    labels = torch.where(batch["mask"], (batch["labels"] + 7) % vocab,
                         batch["labels"])
    loss3, _ = model.loss(dict(batch, labels=labels))
    assert abs(float(loss3) - float(loss1)) > 1e-4


def test_encoder_does_not_decode_as_in_jax():
    arch, _jarch, _jm, _params, model = _pair()
    with pytest.raises(ValueError) as want:
        jtfm.cache_struct(jconfigs.get_reduced(NAME).model, 2, 8)
    with pytest.raises(ValueError) as got:
        tfm.cache_struct(arch.model, 2, 8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="decode"):
        model.decode_step({}, torch.zeros(2, dtype=torch.long), 0)
    with pytest.raises(ValueError, match="encoder-only"):
        Generator(arch, model, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        LatencyModel.from_arch(NAME, flops=1.0, mem_bandwidth=1.0)
    with pytest.raises(NotImplementedError, match="'encoder'"):
        model.prefill({"frames": torch.zeros(1, 4, 64)})


def _grad(model, batch):
    """(loss, grads) of the port's loss at the model's parameters, by the
    port's ``value_and_grad``."""
    return tfm.value_and_grad(model.params, batch, model.cfg)


def _leaf_pairs(jtree, ttree, path=()):
    if isinstance(jtree, dict):
        return [x for k in jtree for x in _leaf_pairs(jtree[k], ttree[k],
                                                     path + (k,))]
    return [(path, np.asarray(jnp.asarray(jtree).astype(jnp.float32)),
             _np(ttree))]


def test_gradient_matches_jax_value_and_grad():
    arch, jarch, jm, params, model = _pair()
    batch, jbatch = _batches(arch, jarch, b=2, s=16, seed=1)
    loss, grads = _grad(model, batch)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True)(params)
    _close(loss, jloss)
    for path, a, b in _leaf_pairs(jgrads, grads):
        scale = float(np.abs(a).max())
        assert scale > 0, path
        assert float(np.abs(a - b).max()) <= GRAD_TOL * scale, path


def test_one_adamw_step_of_the_arch_train_config_matches_jax():
    """hubert-xlarge's own ``TrainConfig``: AdamW, lr 3e-4, clip 1.0."""
    arch, jarch, jm, params, model = _pair()
    assert (arch.train.optimizer, arch.train.learning_rate,
            arch.train.grad_clip) == ("adamw", 3e-4, 1.0)
    batch, jbatch = _batches(arch, jarch, b=2, s=16, seed=2)
    opt, jopt = make_optimizer(arch.train), jmake_optimizer(jarch.train)
    _loss, grads = _grad(model, batch)
    new, state, stats = opt.update(grads, opt.init(model.params),
                                   model.params)

    @jax.jit
    def jstep(p, s, b):
        g = jax.grad(lambda pp: jm.loss(pp, b)[0])(p)
        return jopt.update(g, s, p)

    jnew, jstate, jstats = jstep(params, jopt.init(params), jbatch)
    np.testing.assert_allclose(float(stats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-5)
    assert float(stats["grad_norm"]) > 1.0          # the clip bites
    worst = 0.0
    for path, a, b in _leaf_pairs(jnew, new):
        worst = max(worst, float(np.abs(a - b).max())
                    / arch.train.learning_rate)
    assert worst <= STEP_U_TOL, worst
    assert int(state["step"]) == int(jstate["step"]) == 1
