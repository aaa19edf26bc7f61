"""Autoregressive generation with the Llama KV cache on the port — decode
throughput, the counterpart of ``examples/jax_llama_generation.py``:

    python -m horovod_tpu_torch.examples.llama_generation --model 300m \\
        --prompt-len 128 --max-new-tokens 256 --batch-size 8

Prefill, then single-token steps through the contiguous decode kernel
(``models.llama.generate``), on random weights from seed 0 and a prompt
from ``RandomState(0)``, as the JAX example draws them. One unmeasured
call first (it builds the kernels and warms the allocator), then one
timed call; it prints the JAX example's line, ``... N decode tokens/sec
(x tok/s/sequence) ...``, where the time covers prefill and decode as
there. Runs on ``cuda`` unless given ``--device cpu``.

The MoE choices (``moe-tiny``, ``moe-small``) decode ``MoeLM`` through
the same ``generate()`` (no-drop expert capacity) and print the model's
name without the ``llama-`` prefix, as the JAX example does. Not ported
yet: ``--checkpoint`` (it waits for the port of the checkpoint
utilities).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_8B, LLAMA_300M,
                                            LLAMA_TINY, LlamaLM, generate)
from horovod_tpu_torch.models.moe_lm import MOE_SMALL, MOE_TINY, MoeLM

CONFIGS = {"tiny": (LlamaLM, LLAMA_TINY), "300m": (LlamaLM, LLAMA_300M),
           "1b": (LlamaLM, LLAMA_1B), "8b": (LlamaLM, LLAMA_8B),
           "moe-tiny": (MoeLM, MOE_TINY), "moe-small": (MoeLM, MOE_SMALL)}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=sorted(CONFIGS), default="300m")
    parser.add_argument("--prompt-len", type=int, default=128)
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    model_cls, cfg = CONFIGS[args.model]
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    held_before = torch.cuda.memory_allocated(device) if on_card else 0
    model = model_cls(cfg, device=device, seed=0)
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (args.batch_size, args.prompt_len)))
    generator = None
    if args.temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(1)

    def run():
        if generator is not None:
            generator.manual_seed(1)
        out = generate(model, prompt, max_new_tokens=args.max_new_tokens,
                       temperature=args.temperature, generator=generator)
        int(out[0, -1])        # the barrier: fetch a token
        return out

    run()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    out = run()
    _sync(device)
    dt = time.perf_counter() - t0

    new_tokens = args.batch_size * args.max_new_tokens
    sample = out[0, args.prompt_len:args.prompt_len + 8].cpu().numpy()
    label = args.model if model_cls is MoeLM else f"llama-{args.model}"
    print(f"{label} prompt={args.prompt_len} "
          f"b={args.batch_size}: "
          f"{new_tokens / dt:.0f} decode tokens/sec "
          f"({args.max_new_tokens / dt:.1f} tok/s/sequence), "
          f"sample ids {sample}")
    # Peak device memory of the timed call: the weights, the cache and the
    # activations, above whatever the caller held before this run.
    peak = (torch.cuda.max_memory_allocated(device) - held_before
            if on_card else None)
    return {"tokens_per_s": new_tokens / dt, "seconds": dt,
            "tokens": new_tokens, "device": str(device),
            "peak_memory_bytes": peak, "out": out}


if __name__ == "__main__":
    main()
