#!/usr/bin/env python3
"""Time one path of two checkouts in turns on one card.

    python3 chip_compare.py OTHER_ROOT [--rounds N] [--path PATH]

OTHER_ROOT is another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory ``.gitignore``
lists). Each round runs the path in a fresh process from each tree, in
the order other, this, this, other, so that drift of the card's clocks
hits both alike. ``training`` (the default) is
``chip_smoke.run_training_timed`` (Llama-300M, bf16, seq 1024, batch 8,
AdamW, 10 timed steps and one profiled step); ``decode`` is
``chip_smoke.check_kernels`` (both decode kernels against their plain
versions at the serving slice's and Llama-8B's shapes, each kernel's
median time with the L2 flushed); ``flash`` is ``chip_smoke.check_flash``
(the three flash kernels on its eight cases, in both dtypes, each
kernel's median time); ``serving`` is the serving engine's decode step
at Llama-300M bf16, 8 slots at ~130-170 positions, 40 steps timed
without the profiler: the eager step, and where the tree has one the
step the engine captured as a CUDA graph; ``mask`` times the three bf16
flash kernels at BERT-base's shape (b32 S512 H12 D64, non-causal) under
no mask, an all-true mask, ``tail_mask`` and ``padded_mask``, and at
the unmasked ``slice``, ``llama8b``, ``moe_small`` and ``vit_s16`` cases,
through the wrappers with the bool mask (each tree's per-call mask
conversion included), and, where the tree has the bitmap, with the words
built once, the bitmap's kernel alone, and ``scaled_dot_product_attention``
with the mask as ``attn_mask``; ``bert`` is the BERT example (base, bf16,
seq 512, b32, 10 timed steps and a profiled flash split), then 10 steps
of the same model over ``padded_mask``. The masks come from this tree's
``chip_smoke.py`` whichever tree runs. Each process builds its own tree's
kernels. Prints one JSON line per run, then the medians per tree and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

_RUN = """
import json, chip_smoke
out = chip_smoke.run_training_timed(chip_smoke.card_line())
prof = out["step_profile"]
print("RESULT " + json.dumps({
    "tokens_per_s": out["tokens_per_s"], "step_ms": out["step_ms"],
    "peak_memory_gib": out["peak_memory_gib"],
    "flash_ms_per_step": prof["flash_ms_per_step"],
    "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
    "loss_first_last": [out["losses"][0], out["losses"][-1]]}))
"""


_RUN_DECODE = """
import json, torch, chip_smoke
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rows = chip_smoke.check_kernels(torch.device("cuda"), flush.zero_)
print("RESULT " + json.dumps({" ".join(key) + " ms": row["ms"]
                              for key, row in rows.items()}))
"""
_RUN_FLASH = """
import json, torch, chip_smoke
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
rows = chip_smoke.check_flash(torch.device("cuda"), flush.zero_)
print("RESULT " + json.dumps({" ".join(key) + " " + name: ms
                              for key, row in rows.items()
                              for name, ms in row["ms"].items()}))
"""
_RUN_SERVING = """
import contextlib, json, time
import numpy as np, torch
from horovod_tpu_torch import serving
from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM
from horovod_tpu_torch.serving import engine as engine_mod

model = LlamaLM(LLAMA_300M, seed=0)
scfg = serving.ServingConfig(max_batch=8, block_size=16, num_blocks=0,
                             queue_depth=8, max_seq_len=256)
modes = {"eager": getattr(engine_mod, "_eager_decode",
                          contextlib.nullcontext)}
if hasattr(engine_mod, "_eager_decode"):
    modes["graph"] = contextlib.nullcontext
out = {}
for mode, ctx in modes.items():
    with ctx():
        engine = serving.ServingEngine(model, scfg)
    rng = np.random.RandomState(3)
    for _ in range(8):
        engine.submit(rng.randint(0, LLAMA_300M.vocab_size, 128), 60)
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(40):
        engine.step()
    torch.cuda.synchronize()
    out[mode + "_step_ms"] = (time.perf_counter() - t0) * 1e3 / 40
    engine.shutdown()
print("RESULT " + json.dumps(out))
"""
# Loads this tree's chip_smoke.py (its masks) as ``masks``, whichever tree
# the process runs.
_MASKS = """
import importlib.util, os
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_masks", os.path.join(os.environ["HVD_COMPARE_HERE"],
                                     "chip_smoke.py"))
masks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(masks)
"""
_RUN_MASK = _MASKS + """
import json, torch, chip_smoke
import torch.nn.functional as F
from horovod_tpu_torch.ops import attention as A
flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda").zero_
dev = torch.device("cuda")
cases = [("bert_nomask", 32, 512, 12, 12, 64, None, False),
         ("bert_alltrue", 32, 512, 12, 12, 64, "alltrue", False),
         ("bert", 32, 512, 12, 12, 64, "tail", False),
         ("bert_padded", 32, 512, 12, 12, 64, "padded", False),
         ("slice", 8, 1024, 16, 8, 64, None, True),
         ("llama8b", 1, 4096, 32, 8, 128, None, True),
         ("moe_small", 8, 1024, 12, 6, 64, None, True),
         ("vit_s16", 64, 197, 6, 6, 64, None, False)]
out = {}
for label, b, s, h, hkv, d, kind, causal in cases:
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = ((torch.randn(b, s, n, d, generator=gen, device=dev) * 0.5)
                  .bfloat16() for n in (h, hkv, hkv, h))
    mask = None
    if kind == "alltrue":
        mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    elif kind is not None:
        mask = {"tail": masks.tail_mask,
                "padded": masks.padded_mask}[kind](b, s, dev)
    p_out, lse = A.flash_attention_forward_plain(q, k, v, mask, causal)
    delta = A.flash_delta(p_out, g)
    def row(**kw):
        return {
            "fwd": chip_smoke.time_ms(lambda: A._flash_forward(
                q, k, v, mask, causal, **kw), flush),
            "dq": chip_smoke.time_ms(lambda: A.flash_backward_dq(
                q, k, v, mask, g, lse, delta, causal, **kw), flush),
            "dkdv": chip_smoke.time_ms(lambda: A.flash_backward_dkdv(
                q, k, v, mask, g, lse, delta, causal, **kw), flush)}
    for key, ms in row().items():
        out[f"{label} {key} ms"] = ms
    if mask is not None and hasattr(A, "flash_mask_words"):
        words = A.flash_mask_words(mask)
        for key, ms in row(words=words).items():
            out[f"{label} {key} ms, words built once"] = ms
        out[f"{label} mask words ms"] = chip_smoke.time_ms(
            lambda: A.flash_mask_words(mask), flush)
    if mask is not None:
        qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
        qr, kr, vr = (x.detach().requires_grad_() for x in (qt, kt, vt))
        am = mask[:, None, None, :]
        o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=am)
        out[f"{label} sdpa fwd ms"] = chip_smoke.time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am),
            flush)
        out[f"{label} sdpa bwd ms"] = chip_smoke.time_ms(
            lambda: torch.autograd.grad(o, (qr, kr, vr), gt,
                                        retain_graph=True), flush)
    del q, k, v, g, p_out, lse, delta
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
"""
_RUN_BERT = _MASKS + """
import json, time, torch, chip_smoke
from horovod_tpu_torch.examples import bert_pretraining as ex
from horovod_tpu_torch.models.bert import mlm_loss
out = ex.main(["--model", "base", "--seq-len", "512", "--batch-size", "32",
               "--num-iters", "10"])
model, opt, ids, mlm = (out[k] for k in ("model", "optimizer", "ids", "mlm"))
res = {"sequences_per_s": out["sequences_per_s"], "step_ms": out["step_ms"]}
prof = chip_smoke.profile_step(
    lambda: ex.train_step(model, opt, ids, mlm), out["step_ms"],
    chip_smoke.TRANSFORMER_SPLIT, "flash", "bert-base")
res["flash_ms_per_step"] = prof["flash_ms_per_step"]
padded = masks.padded_mask(*ids.shape, ids.device)
def step():
    opt.zero_grad(set_to_none=True)
    loss = mlm_loss(model(ids, attention_mask=padded, deterministic=True),
                    ids, mlm)
    loss.backward()
    opt.step()
step()
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(10):
    step()
torch.cuda.synchronize()
ms = (time.perf_counter() - t0) * 1e2
res["padded_sequences_per_s"] = ids.shape[0] * 1e3 / ms
res["padded_step_ms"] = ms
prof = chip_smoke.profile_step(step, ms, chip_smoke.TRANSFORMER_SPLIT,
                               "flash", "bert-base padded")
res["padded_flash_ms_per_step"] = prof["flash_ms_per_step"]
print("RESULT " + json.dumps(res))
"""
RUNS = {"training": _RUN, "decode": _RUN_DECODE, "flash": _RUN_FLASH,
        "serving": _RUN_SERVING, "mask": _RUN_MASK, "bert": _RUN_BERT}


def run(tree: Path, path: str = "training") -> dict:
    here = str(Path(__file__).resolve().parent)
    proc = subprocess.run([sys.executable, "-c", RUNS[path]], cwd=tree,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "HVD_COMPARE_HERE": here})
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{tree}: no result (exit {proc.returncode})\n"
                       f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--path", choices=sorted(RUNS), default="training")
    args = parser.parse_args(argv)
    here = Path(__file__).resolve().parent
    trees = {"other": args.other.resolve(), "this": here}
    runs = {"other": [], "this": []}
    for _ in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            result = run(trees[name], args.path)
            runs[name].append(result)
            print(json.dumps({"tree": name, **result}), flush=True)
    medians = {name: {key: statistics.median(r[key] for r in rs)
                      for key in rs[0] if key != "loss_first_last"}
               for name, rs in runs.items()}
    print(json.dumps({"medians": medians}))
    sys.path.insert(0, str(here))
    import chip_smoke
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
