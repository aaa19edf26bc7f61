"""Per-rank memory budget for FSDP (ZeRO-3) Llama training on the port —
the counterpart of ``examples/fsdp_hbm_budget.py``: what each of N ranks
holds of the parameters, their gradients and Adam's state.

Exact per-rank bytes from the port's own spec functions
(``fsdp_param_specs`` and ``fsdp_state_specs``) over the real modules
built on the ``meta`` device (no memory: Llama-8B's 32 GB of float32
parameters are never allocated) and Adam's state evaluated the same way.
Gradients are the parameters' bytes (the reduce-scatter output is the
1/N shard). Activations and temporaries are not counted: they depend on
batch, sequence and recompute. torch's Adam keeps one 0-d ``step`` per
parameter where optax keeps one count, so the Adam column is a few
hundred bytes above the JAX table's; every printed figure is the same.

    python -m horovod_tpu_torch.examples.fsdp_hbm_budget [--json-out PATH]

With a card present, each row also says whether it fits the card's
memory (``torch.cuda.get_device_properties(0).total_memory``). Nothing is
written unless ``--json-out`` names a file.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Dict, List, Optional

import torch

from horovod_tpu_torch.models.llama import (LLAMA_1B, LLAMA_8B, LLAMA_300M,
                                            LlamaConfig, LlamaLM)
from horovod_tpu_torch.torch.fsdp import (fsdp_param_specs, fsdp_state_specs,
                                          sharded_size_bytes)
from horovod_tpu_torch.torch.partition import abstract_state

CONFIGS = {
    "llama-8b": LLAMA_8B,
    "llama-1b": LLAMA_1B,
    "llama-300m": LLAMA_300M,
}
SHARDS = (1, 8, 16, 32, 64)
GIB = 2 ** 30


@functools.lru_cache(maxsize=None)
def _model(cfg: LlamaConfig):
    """The model's parameters on ``meta``, Adam over them, and Adam's
    state evaluated there."""
    with torch.device("meta"):
        model = LlamaLM(cfg, device="meta", param_dtype=torch.float32)
    params = dict(model.named_parameters())
    optimizer = torch.optim.Adam(model.named_parameters(), lr=1e-4)
    state = abstract_state(optimizer, {
        # hvdlint: disable=HVD002 (one insertion order on every rank)
        name: (p, tuple(p.shape), p.dtype) for name, p in params.items()})
    return params, optimizer, state


def budget(cfg: LlamaConfig, num_shards: int) -> Dict:
    """Per-rank bytes (and GiB) of params, grads and Adam state at
    ``num_shards`` FSDP shards."""
    params, optimizer, state = _model(cfg)
    specs = fsdp_param_specs(params, num_shards=num_shards)
    sspecs = fsdp_state_specs(optimizer, specs)
    shards = {"data": num_shards}
    p = sharded_size_bytes(params, specs, shards)
    s = sharded_size_bytes(state, sspecs, shards)
    total = p + p + s
    # hvdlint: disable=HVD002 (a sum of integers: order-free)
    return {"num_params": sum(x.numel() for x in params.values()),
            "fsdp": num_shards, "params_bytes": p, "grads_bytes": p,
            "opt_state_bytes": s, "total_bytes": total,
            "params_gib": p / GIB, "grads_gib": p / GIB,
            "opt_state_gib": s / GIB, "total_gib": total / GIB}


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None,
                    help="also write the rows here as JSON")
    args = ap.parse_args(argv)
    card = None
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        card = (props.name, props.total_memory)
    rows = []
    # The table's rows in the catalog's order, as the JAX example prints
    # them. hvdlint: disable=HVD002
    for name, cfg in CONFIGS.items():
        for n in SHARDS:
            row = {"model": name, **budget(cfg, n)}
            fits = ""
            if card is not None:
                row["fits_card"] = row["total_bytes"] < card[1]
                fits = (f" {'fits' if row['fits_card'] else 'OOM'} "
                        f"{card[0]}")
            rows.append(row)
            print(f"{name:>11} fsdp={n:>2}: params {row['params_gib']:7.2f} "
                  f"+ grads {row['grads_gib']:7.2f} "
                  f"+ adam {row['opt_state_gib']:7.2f} "
                  f"= {row['total_gib']:7.2f} GiB/rank{fits}", flush=True)
    if args.json_out:
        out = {"method": "exact per-rank bytes from fsdp_param_specs/"
                         "fsdp_state_specs over the modules on the meta "
                         "device; grads = param bytes. Activations and "
                         "temporaries excluded.",
               "optimizer": "torch.optim.Adam (f32 exp_avg + exp_avg_sq, "
                            "a 0-d step per parameter)",
               "card": None if card is None else
               {"name": card[0], "total_memory_bytes": card[1]},
               "rows": rows}
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json_out}")
    return rows


if __name__ == "__main__":
    main()
