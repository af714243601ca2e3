"""Serving launcher: batched generation against a zoo arch of the
families the port builds (dense, ssm, hybrid).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --reduced --device cpu --batch 4 --prompt-len 16 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b

The flags are the JAX launcher's plus ``--device`` (default: the card;
without one it raises and says to pass ``--device cpu``).  The model runs
in fp32, as the JAX launcher forces, with parameters from a
``torch.Generator`` seeded with 0.  Per request it prints the tokens, the
seconds, tok/s and the perplexity of the generated sequences.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Generator, perplexity


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--requests", type=int, default=2,
                    help="number of batched requests to serve")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to ask for it)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    arch = arch.replace(model=arch.model.replace(dtype="float32"))
    model = build_model(arch, device=device, seed=0)
    gen = Generator(arch, model,
                    max_seq=args.prompt_len + args.new_tokens + 1,
                    device=device)
    rng = np.random.default_rng(0)
    total_tok, total_t = 0, 0.0
    for r in range(args.requests):
        prompts = rng.integers(0, arch.model.vocab_size,
                               (args.batch, args.prompt_len)).astype(np.int32)
        t0 = time.perf_counter()
        out = gen.generate(prompts, max_new_tokens=args.new_tokens,
                           temperature=args.temperature, seed=r)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        n_tok = args.batch * args.new_tokens
        total_tok += n_tok
        total_t += dt
        print(f"request {r}: {args.batch}x{args.new_tokens} = {n_tok} tokens "
              f"in {dt:.3f} s  {n_tok / dt:.1f} tok/s  "
              f"ppl={perplexity(model, out):.1f}")
    print(f"served {total_tok} tokens @ {total_tok / total_t:.1f} tok/s "
          f"on {device}")


if __name__ == "__main__":
    main()
