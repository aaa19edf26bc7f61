"""Distributed word2vec (skip-gram, negative sampling) on the port — the
counterpart of ``examples/jax_word2vec.py``:

    python -m horovod_tpu_torch.examples.word2vec --steps 200

Each rank draws skip-gram pairs from its contiguous shard of the corpus
with ``RandomState(rank)``, and the negatives from the same stream, as
the JAX example does. The two embedding tables are dense parameters:
the gradient of a row gather is a dense table (the VJP of a gather, as
in JAX), which ``DistributedOptimizer`` averages over the ranks before
the port's ``Adagrad(lr)`` (``optax.adagrad``) steps. The default corpus
is the synthetic Zipf stream (``--corpus`` takes a text file). Rank 0
prints ``step N: loss=... (... pairs/sec)`` every 50 steps.

The torch generator cannot redraw ``jax.random.uniform``'s initial
``in`` table: this one is ``torch.Generator`` seed 0 over the same range
(``tables=`` passes both tables in, as the tests do).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.torch.optim import Adagrad


def build_corpus(path, vocab_size):
    if path:
        with open(path) as f:
            words = f.read().split()
        vocab, counts = np.unique(words, return_counts=True)
        keep = vocab[np.argsort(-counts)][:vocab_size - 1]
        index = {w: i + 1 for i, w in enumerate(keep)}  # 0 = UNK
        return np.array([index.get(w, 0) for w in words], dtype=np.int32)
    # Synthetic Zipf stream: frequency structure like natural text, which
    # the sampled-softmax objective needs to be non-degenerate.
    rng = np.random.RandomState(0)
    zipf = rng.zipf(1.3, size=200_000)
    return np.clip(zipf, 1, vocab_size - 1).astype(np.int32)


def skipgram_batches(corpus, batch, window, rng):
    while True:
        centers = rng.randint(window, len(corpus) - window, size=batch)
        offsets = rng.randint(1, window + 1, size=batch)
        signs = rng.choice([-1, 1], size=batch)
        yield corpus[centers], corpus[centers + signs * offsets]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--vocab-size", type=int, default=10_000)
    parser.add_argument("--embedding-dim", type=int, default=128)
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--window", type=int, default=2)
    parser.add_argument("--negatives", type=int, default=8)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--corpus", default=None)
    return parser.parse_args(argv)


def loss_fn(p, centers, contexts, negatives):
    v = p["in"][centers]                          # [b, d]
    u_pos = p["out"][contexts]                    # [b, d]
    u_neg = p["out"][negatives]                   # [b, k, d]
    pos = F.logsigmoid(torch.sum(v * u_pos, dim=-1))
    neg = F.logsigmoid(-torch.einsum("bd,bkd->bk", v, u_neg))
    return -(pos + neg.sum(dim=-1)).mean()


def init_tables(vocab_size: int, dim: int) -> Dict[str, np.ndarray]:
    """``in`` uniform in [-0.5, 0.5) / dim from seed 0, ``out`` zeros."""
    gen = torch.Generator().manual_seed(0)
    table = (torch.rand(vocab_size, dim, generator=gen) - 0.5) / dim
    return {"in": table.numpy(),
            "out": np.zeros((vocab_size, dim), np.float32)}


def main(argv: Optional[List[str]] = None,
         tables: Optional[Dict[str, np.ndarray]] = None) -> Dict:
    args = parse_args(argv)
    hvd.init()
    device = hvd.device()
    corpus = build_corpus(args.corpus, args.vocab_size)
    # Each rank samples from its contiguous shard of the corpus.
    if hvd.size() > 1:
        chunk = len(corpus) // hvd.size()
        corpus = corpus[hvd.rank() * chunk:(hvd.rank() + 1) * chunk]

    rng = np.random.RandomState(hvd.rank())
    if tables is None:
        tables = init_tables(args.vocab_size, args.embedding_dim)
    params = {name: torch.nn.Parameter(torch.tensor(
        np.asarray(tables[name], np.float32), device=device))
        for name in ("in", "out")}
    named = sorted(params.items())
    opt = hvd.DistributedOptimizer(Adagrad([p for _, p in named], lr=args.lr),
                                   named_parameters=named)

    batch = args.batch_size
    data = skipgram_batches(corpus, batch, args.window, rng)
    losses = []
    pairs_per_s = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        centers, contexts = next(data)
        negatives = rng.randint(1, args.vocab_size,
                                size=(batch, args.negatives))
        opt.zero_grad()
        loss = loss_fn(params, *(torch.from_numpy(np.asarray(a)).long().to(
            device) for a in (centers, contexts, negatives)))
        loss.backward()
        opt.step()
        loss = hvd.allreduce(loss.detach(), average=True,
                             name="word2vec.loss")
        losses.append(loss)
        if (i + 1) % 50 == 0 and hvd.rank() == 0:
            dt = time.perf_counter() - t0
            pairs_per_s.append(50 * batch / dt)
            print(f"step {i + 1}: loss={float(loss):.4f} "
                  f"({50 * batch / dt:.0f} pairs/sec)", flush=True)
            t0 = time.perf_counter()
    return {"losses": [float(x) for x in losses],
            "pairs_per_s": pairs_per_s,
            "tables": {k: v.detach() for k, v in named}}


if __name__ == "__main__":
    main()
