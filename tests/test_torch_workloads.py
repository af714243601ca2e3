"""The port's architecture workloads (``repro_torch.core.workloads``)
against the JAX package's, on the CPU, with the JAX parameters carried
across (``flat_from_numpy``).

- The flat parameter tensor is the JAX ``ravel_pytree`` vector bit for bit
  (keys sorted at every level, stacked leaves raveled row-major).
- ``ArchWorkload.grad`` agrees with the JAX ``value_and_grad`` at the
  reduced configs: in fp32 (the config's dtype replaced in both packages)
  the loss and every gradient element within ``rtol=1e-5, atol=1e-6``
  (fp32 sums in other orders); in bfloat16 (the configs' own dtype) the
  loss within ``BF16_LOSS_RTOL``, the whole gradient within
  ``BF16_GRAD_TOL`` of its largest |g|, and each leaf's within
  ``BF16_LEAF_TOL`` of that leaf's largest |g| -- the two frameworks round
  to bf16 at other places, a few bf16 ulps (2^-8 each) that compound
  through the layers; leaves with small gradients (the ssm families'
  conv and dt parameters) carry the most of it.  Measured: losses 4e-5 to
  6e-5 apart, whole gradients up to 2.8e-2 of the largest |g|, leaves up
  to 6.9e-2 of their own largest.
- The ssm and hybrid families train on the CPU through the chunked plain
  SSD scan (``ssm_chunk=4`` in both packages, so chunk borders are
  crossed); on any other device the SSD scan under autograd goes through
  ``SSDScan`` to the CUDA kernels (``device="meta"`` reaches the kernel's
  device check), and ``ArchWorkload`` builds them for any device.
- bfloat16 parameters become fp32 at their first merge, call for call as
  in the JAX package, through every algorithm and sync protocol (the wire
  is fp32; the JAX ``unravel`` of a single-dtype tree casts nothing).
- Sizes, names and spec-time validation equal the JAX package's.

The port runs on one intra-op thread here (its reduced-model ops are
tiny; threads spinning against the other test workers' slow them a
hundredfold).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import repro.configs as jconfigs
from repro.core import workloads as jworkloads
from repro.experiments import ExperimentSpec as JExperimentSpec
from repro_torch.core import workloads as tworkloads
from repro_torch.core.workloads import ArchWorkload, flat_from_numpy
from repro_torch.experiments import ExperimentSpec
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import SSDScan, ssd_scan_fused
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked

BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = 5e-2
BF16_LEAF_TOL = 1e-1
ARCHS = ["smollm_360m", "mamba2_370m", "zamba2_2_7b"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _with(dtype):
    """A ``get_reduced`` that sets the config dtype (and 4-position SSD
    chunks, a config value both packages read)."""
    def patch(get):
        def get_reduced(name):
            arch = get(name)
            return arch.replace(model=arch.model.replace(dtype=dtype,
                                                         ssm_chunk=4))
        return get_reduced
    return patch


@pytest.fixture
def configs(monkeypatch):
    """Replace the reduced configs' dtype in both packages."""
    def apply(dtype):
        monkeypatch.setattr(jconfigs, "get_reduced",
                            _with(dtype)(jconfigs.get_reduced))
        monkeypatch.setattr(tworkloads, "get_reduced",
                            _with(dtype)(tworkloads.get_reduced))
    return apply


def _pair(name, seed=0):
    jw = jworkloads.ArchWorkload(name)
    tw = ArchWorkload(name)
    tree = jax.tree.map(np.asarray, jw.init(jax.random.key(seed)))
    return jw, tw, tree


def _grads(jw, tw, tree, rows=8):
    ds = tw.make_data(rows, seed=2)
    jl, jg = jw.grad(jax.tree.map(jnp.asarray, tree),
                     {"x": jnp.asarray(ds.x), "y": jnp.asarray(ds.y)})
    tl, tg = tw.grad(flat_from_numpy(tree, tw),
                     {"x": torch.from_numpy(ds.x), "y": torch.from_numpy(ds.y)})
    return (float(jl), np.asarray(ravel_pytree(jg)[0], np.float32),
            float(tl), tg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_flat_order_is_ravel_pytree_bitwise(name, dtype, configs):
    configs(dtype)
    jw, tw, tree = _pair(name)
    flat = flat_from_numpy(tree, tw)
    want = ravel_pytree(jax.tree.map(jnp.asarray, tree))[0]
    assert flat.dtype == getattr(torch, dtype) and str(want.dtype) == dtype
    assert flat.float().numpy().tobytes() == \
        np.asarray(want, np.float32).tobytes()
    # and back: the dict view of the flat tensor holds the JAX leaves
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = tw.params(flat)
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))


@pytest.mark.parametrize("name", ARCHS)
def test_grad_matches_jax_in_fp32(name, configs):
    configs("float32")
    jl, jg, tl, tg = _grads(*_pair(name))
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_grad_matches_jax_in_bf16(name, configs):
    configs("bfloat16")
    jw, tw, tree = _pair(name)
    jl, jg, tl, tg = _grads(jw, tw, tree)
    assert tg.dtype == torch.bfloat16
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_RTOL)
    tg = tg.float().numpy()
    assert np.abs(tg - jg).max() <= BF16_GRAD_TOL * np.abs(jg).max()
    off = 0
    for path, shape in tw.layout:
        n = int(np.prod(shape))
        j, t = jg[off:off + n], tg[off:off + n]
        off += n
        assert np.abs(t - j).max() <= BF16_LEAF_TOL * np.abs(j).max(), path
    assert off == jg.size


def test_grad_is_views_and_never_copies_the_params():
    tw = ArchWorkload("smollm_360m")
    flat = tw.init(torch.Generator().manual_seed(0))
    p = tw.params(flat)
    leaves = [p["embed"], p["unembed"], p["blocks"]["attn"]["wq"]]
    assert all(t.untyped_storage().data_ptr()
               == flat.untyped_storage().data_ptr() for t in leaves)
    ds = tw.make_data(4)
    before = flat.clone()
    loss, g = tw.grad(flat, {"x": torch.from_numpy(ds.x),
                             "y": torch.from_numpy(ds.y)})
    assert torch.equal(flat, before) and not flat.requires_grad
    assert g.shape == flat.shape and g.dtype == flat.dtype
    assert bool(g.float().abs().sum() > 0) and loss.dim() == 0


def test_sizes_and_names_equal_jax():
    assert tworkloads.list_workloads() == jworkloads.list_workloads()
    for name in ARCHS + ["stablelm_3b"]:
        for reduced in (True, False):
            args = {"reduced": reduced}
            assert (tworkloads.estimate_update_bytes(name, "tokens", args)
                    == jworkloads.estimate_update_bytes(name, "tokens", args))
    for name in ARCHS:
        jw, tw = jworkloads.ArchWorkload(name), ArchWorkload(name)
        assert (tw.n_params, tw.flops_per_row, tw.convex) == \
            (jw.n_params, jw.flops_per_row, jw.convex)
    full = ArchWorkload("smollm_360m", reduced=False)
    assert full.n_params == 409_007_040
    assert full.flops_per_row == 6.0 * 409_007_040 * tworkloads.DEFAULT_SEQ_LEN


@pytest.mark.parametrize("name,exc", [
    ("hubert_xlarge", ValueError), ("llama_3_2_vision_90b", ValueError)])
def test_encoder_and_vlm_raise_as_in_jax(name, exc):
    with pytest.raises(exc):
        jworkloads.ArchWorkload(name)
    with pytest.raises(exc, match="encoder/VLM"):
        ArchWorkload(name)


def test_arch_specs_need_the_token_corpus():
    with pytest.raises(ValueError, match="tokens"):
        ExperimentSpec(model="smollm_360m", dataset="higgs")
    with pytest.raises(ValueError, match="study stand-in"):
        ExperimentSpec(model="lr", dataset="tokens")
    spec = ExperimentSpec(model="smollm_360m", dataset="tokens", rows=64)
    wl, _algo, tr, va = spec.build_workload()
    assert isinstance(wl, ArchWorkload) and tr.n + va.n == 64


@pytest.mark.parametrize("name,dataset,match", [
    ("smollm_360m", "higgs", "tokens"), ("lr", "tokens", "study stand-in")])
def test_make_workload_checks_the_pairing_as_the_spec_does(name, dataset,
                                                           match):
    with pytest.raises(ValueError, match=match):
        tworkloads.make_workload(name, dataset=dataset, rows=64)


# --------------------------------------------------------- SSD guard -------

def _ssd_inputs(device, grad):
    b, s, h, p, n = 1, 4, 2, 3, 5
    x = torch.zeros(b, s, h, p, device=device, requires_grad=grad)
    return (x, torch.zeros(b, s, h, device=device),
            torch.zeros(h, device=device), torch.zeros(b, s, n, device=device),
            torch.zeros(b, s, n, device=device))


def _ssd_values():
    """Seeded x, dt >= 0, a_log, B, C on the CPU (b 1, s 8, h 2, p 3, n 5)."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 8, 2, 3, 5
    x, dt, a_log, B, C = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((b, s, h, p), (b, s, h), (h,), (b, s, n),
                                   (b, s, n)))
    return x, dt.abs(), a_log, B, C


def _spy_on_ssd_scan(monkeypatch) -> list:
    """Record every call of ``SSDScan.forward`` (then run it)."""
    calls, forward = [], SSDScan.forward

    def spy(ctx, *args):
        calls.append(args[0].device.type)
        return forward(ctx, *args)
    monkeypatch.setattr(SSDScan, "forward", staticmethod(spy))
    return calls


def test_ssd_scan_under_autograd_takes_the_kernels_off_the_cpu(monkeypatch):
    """Off the CPU a call that autograd differentiates goes through
    ``SSDScan`` to the forward kernel's own device check (``meta`` reaches
    it and raises naming CUDA); a call without gradients goes to the
    kernel directly, not through ``SSDScan``; no launch is counted."""
    calls = _spy_on_ssd_scan(monkeypatch)
    before = dict(ssd_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_fused(*_ssd_inputs("meta", grad=True))
    assert calls == ["meta"]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ssd_scan_fused(*_ssd_inputs("meta", grad=True))
    assert calls == ["meta"]
    assert ssd_kernel.launches == before


def test_ssd_scan_on_the_cpu_differentiates_the_plain_version():
    """The CPU route is the chunked plain version: its gradient is autograd
    of ``ssd_scan_chunked``, bit for bit."""
    def grads(fn):
        args = [t.requires_grad_(True) for t in _ssd_values()]
        y, st = fn(*args)
        return torch.autograd.grad((y.sum() + st.square().sum()), args)
    got = grads(lambda *a: ssd_scan_fused(*a, chunk=4))
    want = grads(lambda *a: ssd_scan_chunked(*a, 4))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", ["mamba2_370m", "zamba2_2_7b"])
def test_ssd_families_build_for_any_device(name, monkeypatch):
    """No family guard: ``ArchWorkload.grad`` of the ssm and hybrid families
    on ``meta`` tensors runs the model up to its first SSD scan, which goes
    through ``SSDScan`` to the kernel's device check (ValueError naming
    CUDA), as a CUDA tensor goes to the kernels."""
    calls = _spy_on_ssd_scan(monkeypatch)
    wl = ArchWorkload(name)
    assert wl.cfg.family in ("ssm", "hybrid")
    flat = torch.zeros(wl.n_params, dtype=wl.dtype, device="meta")
    tokens = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wl.grad(flat, {"x": tokens, "y": tokens})
    assert calls == ["meta"]


# ------------------------------------------------ dtype through merges ------

class _Dtypes:
    """Wraps a workload: records the dtype of the parameters handed to
    each ``grad`` and ``eval_loss`` call (``dtype_of`` reads it)."""

    def __init__(self, wl, dtype_of):
        self.wl, self.dtype_of, self.seen = wl, dtype_of, []

    def __getattr__(self, name):
        return getattr(self.wl, name)

    def grad(self, params, batch):
        self.seen.append(("grad", self.dtype_of(params)))
        return self.wl.grad(params, batch)

    def eval_loss(self, params, *a, **k):
        self.seen.append(("eval", self.dtype_of(params)))
        return self.wl.eval_loss(params, *a, **k)


@pytest.mark.parametrize("sync,algorithm", [
    ("bsp", "ga_sgd"), ("asp", "ga_sgd"), ("ssp:1", "ga_sgd"),
    ("local:2", "ga_sgd"), ("local:2:c8", "ga_sgd"), ("diloco:2", "ga_sgd"),
    ("diloco:2:c8", "ga_sgd"), ("bsp", "ma_sgd")])
def test_leaf_dtype_follows_jax_through_every_merge(sync, algorithm):
    """The parameters' dtype at every gradient and evaluation, call for
    call as in the JAX package: bfloat16 until the first merge (or from
    the start, where a protocol hands workers its fp32 global model), then
    the merged vector's fp32 (the JAX ``unravel`` of a single-dtype tree
    casts nothing)."""
    kw = dict(platform="pod", model="smollm_360m", dataset="tokens",
              rows=48, algorithm=algorithm,
              algo_args={"lr": 0.05, "batch_size": 8}, sync=sync,
              max_epochs=1, fleet={"workers": 2})
    spec = ExperimentSpec(**kw)
    wl, algo, tr, va = spec.build_workload()
    assert wl.dtype == torch.bfloat16
    port = _Dtypes(wl, lambda p: str(p.dtype).removeprefix("torch."))
    res = spec.build_runtime().train(port, algo, tr, va, max_epochs=1,
                                     device="cpu")
    jspec = JExperimentSpec(**kw)
    wl, algo, tr, va = jspec.build_workload()
    ref = _Dtypes(wl, lambda p: str(jax.tree.leaves(p)[0].dtype))
    jres = jspec.build_runtime().train(ref, algo, tr, va, max_epochs=1)
    assert not res.error and not jres.error and res.rounds > 0
    assert port.seen == ref.seen and len(port.seen) > res.rounds
    assert ("eval", "float32") in port.seen


def test_algorithms_keep_the_merged_dtype_as_jax_unravel_does():
    from repro_torch.core.algorithms import WorkerState, make_algorithm
    from repro_torch.data.synthetic import Dataset
    part = Dataset("tokens", np.zeros((1, 1), np.int32),
                   np.zeros((1, 1), np.int32))
    params = torch.ones(300, dtype=torch.bfloat16)
    merged = torch.full((300,), 1.0 / 3.0)
    for name in ("ga_sgd", "ma_sgd", "admm"):
        algo = make_algorithm(name)
        st = WorkerState(part, params)
        if name == "admm":
            st.extra.update(x=merged.clone(), u=torch.zeros(300))
        algo.apply_merged(None, st, merged, 2)
        assert st.params.dtype == torch.float32 and st.params.shape == (300,)
    # GA-SGD: unravel(flat - lr * merged) of the bf16 tree, bit for bit
    st = WorkerState(part, params)
    make_algorithm("ga_sgd", lr=0.1).apply_merged(None, st, merged, 2)
    flat, unravel = ravel_pytree({"w": jnp.ones(300, jnp.bfloat16)})
    want = unravel(flat - 0.1 * jnp.asarray(merged.numpy()))["w"]
    assert want.dtype == jnp.float32
    np.testing.assert_array_equal(st.params.numpy(), np.asarray(want))


def test_moe_specs_raise_naming_their_roadmap_item():
    """No longer refused: the MoE family trains.  Its specs build and hash
    as the JAX package's, in every zoo preset that trains a model, and its
    sizes (update bytes, parameters, FLOPs per row) are the JAX package's,
    published and reduced."""
    from repro.experiments import get_preset as jget
    from repro_torch.experiments import get_preset
    for name in ("deepseek_v2_lite_16b", "grok_1_314b"):
        spec = ExperimentSpec(model=name, dataset="tokens")
        assert spec.spec_hash() == JExperimentSpec(
            model=name, dataset="tokens").spec_hash()
        for preset in ("faas_vs_pod", "pod_local_sgd"):
            got = [s.with_(model=name).spec_hash()
                   for s in get_preset(preset).build(True)]
            want = [s.with_(model=name).spec_hash()
                    for s in jget(preset).build(True)]
            assert got == want and len(got) > 1
        for reduced in (True, False):
            args = {"reduced": reduced}
            assert (tworkloads.estimate_update_bytes(name, "tokens", args)
                    == jworkloads.estimate_update_bytes(name, "tokens", args))
        jw, tw = jworkloads.ArchWorkload(name), ArchWorkload(name)
        assert (tw.n_params, tw.flops_per_row) == (jw.n_params,
                                                   jw.flops_per_row)
    assert {"deepseek_v2_lite_16b", "grok_1_314b"} <= set(
        tworkloads.list_workloads())
