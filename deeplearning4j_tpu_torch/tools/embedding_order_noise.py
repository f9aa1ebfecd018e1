"""How far the Word2Vec tables move when only the order of their sums
changes: the fits of ``tools/embedding_reference.py`` on the CPU, once as
they are and once with every ``index_add_`` of a step adding its rows in a
seeded random order, and each table's largest gap over its largest
|value|. On the card ``index_add_``'s atomics sum in no fixed order, so this
is the scale ``chip_smoke.py``'s card-vs-CPU gate on the embedding tables
must allow (``TOL_EMBED_REL``): hierarchical softmax sends every pair of a
batch through the root's row, so its float32 sums reorder most. Run::

    python3 -m deeplearning4j_tpu_torch.tools.embedding_order_noise [--hs] [--threads 4]
"""

from __future__ import annotations

import argparse
import time
from unittest import mock

import numpy as np


def fit(hs: bool, seed: int, permuted: bool):
    import torch

    from deeplearning4j_tpu_torch.nlp import Word2Vec, word2vec
    from deeplearning4j_tpu_torch.tools import embedding_reference as er

    model = Word2Vec(hs=hs, seed=seed, device="cpu", **er.W2V)
    text = er._sentences(er.zipf_tokens(er.W2V_TOKENS, er.W2V_TYPES, seed), er.SENTENCE)
    if not permuted:
        model.fit(text)
        return model.syn0, model.syn1
    gen = torch.Generator().manual_seed(seed)

    def add_sparse(table, ids, deltas):
        ids = ids.reshape(-1)
        order = torch.randperm(ids.numel(), generator=gen)
        table.table.index_add_(0, ids[order], deltas.reshape(-1, table.table.shape[1])[order])

    with mock.patch.object(word2vec._Table, "add_sparse", add_sparse):
        model.fit(text)
    return model.syn0, model.syn1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hs", action="store_true", help="hierarchical softmax (else NS)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    plain = fit(args.hs, args.seed, False)
    permuted = fit(args.hs, args.seed, True)
    for name, a, b in zip(("syn0", "syn1"), plain, permuted):
        gap = float(np.abs(a - b).max())
        print(f"word2vec {'hs' if args.hs else 'ns'} {name}: largest |value| "
              f"{float(np.abs(a).max()):.6g}, largest gap under permuted sums {gap:.6g} = "
              f"{gap / float(np.abs(a).max()):.3e} of it")
    print(f"{time.perf_counter() - t0:.1f} s on the CPU")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
