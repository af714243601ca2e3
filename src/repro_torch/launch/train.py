"""Distributed training launcher: compose mesh + steps + data + checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 50 --batch 8 --seq 128 --mesh 1x1

The port's counterpart of the JAX package's ``launch/train.py``, with the
same flags, plus ``--device`` (default: the card; without CUDA it raises
unless ``--device cpu`` is given).  Without --mesh it asks for the
production 16x16 mesh (or --multi-pod for 2x16x16 with --algorithm diloco
for the cross-pod-efficient MA-SGD path), which needs that many ranks
(``torch.distributed``); ``--mesh 2x1x1`` carries two pods stacked on one
rank.  Fault tolerance: deadline-aware checkpointing via PreemptionGuard;
rerun the same command to resume (elastic: change --data-workers between
runs).

:func:`train` takes the initial parameters (default: ``build_model``'s
seeded init), so a caller can start it from other weights; :func:`main`
returns what :func:`train` returns.  One deliberate difference from the
JAX launcher: a local-SGD checkpoint also holds the outer state
("outer": outer parameters, DiLoCo's momentum, the int8 residuals), so a
resume continues the outer optimizer where it stopped (a checkpoint
without it, as the JAX launcher writes, starts the outer state from the
restored parameters).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_arch, get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed.step import fence_ssd_rounding
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.common import param_count, tree_map


def _mesh_from_arg(arg: str | None, multi_pod: bool, device):
    if arg:
        dims = tuple(int(x) for x in arg.split("x"))
        names = (("data", "model") if len(dims) == 2
                 else ("pod", "data", "model"))
        return make_mesh(dims, names, device=device)
    return make_production_mesh(multi_pod=multi_pod, device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: 8)")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--mesh", default=None, help="e.g. 1x1, 2x4, 2x2x2")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--algorithm", default=None,
                    choices=[None, "ga_sgd", "ma_sgd", "diloco"])
    ap.add_argument("--sync-period", type=int, default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lifetime", type=float, default=900.0)
    ap.add_argument("--data-workers", type=int, default=1)
    ap.add_argument("--data-worker", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def _arch(args):
    arch = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    tc = arch.train
    if args.algorithm:
        tc = dataclasses.replace(tc, algorithm=args.algorithm)
    if args.sync_period:
        tc = dataclasses.replace(tc, sync_period=args.sync_period)
    if args.compress:
        tc = dataclasses.replace(tc, compress_cross_pod=True)
    # micro-batching needs batch % micro == 0 on arbitrary CLI batches
    if args.batch and args.batch % max(tc.micro_batches, 1) != 0:
        tc = dataclasses.replace(tc, micro_batches=1)
    return arch.replace(train=tc)


def train(args: argparse.Namespace, params: dict | None = None) -> dict:
    """Run the launcher's loop.  ``params``: the initial parameter tree
    (nested dicts of tensors; default the seeded init).  -> {"losses": the
    loss of every step this call ran, "pod_losses" (local SGD), "step0":
    the step it resumed from, "params" / "opt" (/ "outer"): the final full
    trees, "seconds"}."""
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    dev = resolve_device(args.device)
    arch = _arch(args)
    tc = arch.train
    mesh = _mesh_from_arg(args.mesh, args.multi_pod, dev)
    batch_size = args.batch or 8
    seq = args.seq or 128
    shape = ShapeConfig("cli", seq, batch_size, "train")
    fence_ssd_rounding(arch, seq)
    local_sgd = (tc.algorithm in ("ma_sgd", "diloco")
                 and "pod" in mesh.axis_names)

    from repro_torch.models import transformer as tfm
    if params is None:
        params = build_model(arch, device=dev, seed=0).params
    params = tree_map(lambda x: x.to(dev), params)
    opt = make_optimizer(tc)
    stream = TokenStream(arch.model.vocab_size, seed=0,
                         worker=args.data_worker,
                         num_workers=args.data_workers)
    lead = mesh.rank == 0

    if lead:
        print(f"arch={arch.name} "
              f"({param_count(tfm.model_spec(arch.model)):,} params) "
              f"mesh={dict(mesh.shape)} algo={tc.algorithm} "
              f"local_sgd={local_sgd}")

    if local_sgd:
        from repro_torch.distributed.local_sgd import build_local_sgd
        ls = build_local_sgd(arch, mesh, shape)
        params_st = ls.stack(params)
        opt_st = ls.stack(opt.init(params), 1)
        outer = ls.init_outer_fn(params_st)
    else:
        from repro_torch.distributed.step import build_train_step
        step = build_train_step(arch, mesh, shape)
        opt_state = step.shard(opt.init(params), 1)
        params = step.shard(params)

    def full_tree() -> dict:
        if local_sgd:
            return {"params": ls.gather(params_st), "opt": ls.gather(opt_st, 1),
                    "outer": ls.gather_outer(outer)}
        return {"params": step.gather(params), "opt": step.gather(opt_state, 1)}

    def save(at: int) -> dict:
        tree = full_tree()
        if lead:
            ckpt.save(args.ckpt_dir, at, tree, {"stream": stream.state()})
        return tree

    # resume
    step0 = 0
    if args.ckpt_dir:
        restored, meta = ckpt.load_latest(args.ckpt_dir)
        if restored is not None:
            step0 = int(meta["step"])
            stream.restore(meta["stream"], args.data_worker,
                           args.data_workers)
            restored = tree_map(lambda x: x.to(dev), restored)
            if local_sgd:
                params_st = ls.restack(restored["params"])
                opt_st = ls.restack(restored["opt"], 1)
                outer = (ls.shard_outer(restored["outer"])
                         if "outer" in restored
                         else ls.init_outer_fn(params_st))
            else:
                params = step.shard(restored["params"])
                opt_state = step.shard(restored["opt"], 1)
            if lead:
                print(f"resumed from step {step0}")

    guard = ckpt.PreemptionGuard(lifetime_s=args.lifetime)
    t0 = time.time()
    loss = float("nan")
    losses, pod_losses = [], []
    for it in range(step0, args.steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch(batch_size, seq).items()}
        ts = time.time()
        if local_sgd:
            params_st, opt_st, m = ls.inner_fn(params_st, opt_st, b)
            per_pod = ls.pod_losses(m)
            loss = float(per_pod.mean())
            pod_losses.append(per_pod.tolist())
            if (it + 1) % ls.sync_period == 0:
                params_st, outer = ls.outer_fn(params_st, outer)
        else:
            params, opt_state, m = step.fn(params, opt_state, b)
            loss = float(m["loss"])
        losses.append(loss)
        guard.record_step(time.time() - ts)
        if lead and (it % args.log_every == 0 or it == args.steps - 1):
            print(f"step {it:5d}  loss {loss:.4f}  "
                  f"{time.time() - t0:6.1f}s")
        if args.ckpt_dir and ((it and it % args.ckpt_every == 0)
                              or guard.should_checkpoint()):
            save(it + 1)
            if lead:
                ckpt.retain(args.ckpt_dir, keep=2)
            if guard.should_checkpoint():
                if lead:
                    print(f"step {it}: lifetime deadline -- checkpointed; "
                          "re-invoke to resume")
                guard.renew()
    tree = save(args.steps) if args.ckpt_dir else full_tree()
    if lead:
        print(f"done: step {args.steps}, loss {loss:.4f}")
    return {"losses": losses, "pod_losses": pod_losses, "step0": step0,
            "seconds": time.time() - t0, **tree}


def main(argv: list[str] | None = None, params: dict | None = None) -> dict:
    return train(parser().parse_args(argv), params)


if __name__ == "__main__":
    main()
