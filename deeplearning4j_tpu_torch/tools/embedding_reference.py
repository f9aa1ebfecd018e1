"""The NLP embedding trainers at card scale on one device: the corpora and
settings of ``chip_smoke.py``'s phase "Word2Vec, GloVe and
ParagraphVectors".

The phase trains them on the card and holds the tables against this
module's run of the same fits on the CPU, which it starts as a process of
its own at the script's start (the CPU run takes minutes, the card run
seconds). Both draw the same pairs, negatives and permutations from the
same seed, so the tables differ only by summation order: ``index_add_``'s
atomics on the card against the CPU's sequential sum.

Sizes: every table at its published width (300, the word2vec and GloVe
papers' vectors); the corpora are seeded Zipf text (word rank ``r`` drawn
with probability ~ 1/r) cut in tokens only: Word2Vec 1,000,000 tokens
over 60,000 word types (21,343 pass ``min_count=5`` at seed 1234), GloVe
200,000 tokens over 20,000 types, ParagraphVectors 2,000 documents of 50
tokens over 5,000 types. Run on the CPU::

    python3 -m deeplearning4j_tpu_torch.tools.embedding_reference --device cpu --out tables.npz
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np

W2V_TOKENS, W2V_TYPES = 1_000_000, 60_000
GLOVE_TOKENS, GLOVE_TYPES = 200_000, 20_000
PV_DOCS, PV_DOC_LEN, PV_TYPES = 2_000, 50, 5_000
SENTENCE = 20
W2V = dict(vector_size=300, window=5, negative=5, batch_size=1024, min_count=5)
GLOVE = dict(vector_size=300, window=5, min_count=5)
PV = dict(vector_size=300, window=5)
UNSEEN_DOC = 60  # tokens of the document ``infer_vector`` meets


def zipf_tokens(n_tokens: int, n_types: int, seed: int) -> List[str]:
    """``n_tokens`` words ``w<rank>``, rank r drawn with probability ~ 1/r."""
    rs = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, n_types + 1)
    words = np.asarray([f"w{i}" for i in range(n_types)])
    return words[rs.choice(n_types, n_tokens, p=p / p.sum())].tolist()


def _sentences(tokens: List[str], length: int) -> List[List[str]]:
    return [tokens[i:i + length] for i in range(0, len(tokens), length)]


def _counted(model) -> List[int]:
    """Counts the (center, context) pairs ``model.fit`` trains on."""
    n = [0]
    pairs = model._pairs

    def counting(sentences, rng):
        for p in pairs(sentences, rng):
            n[0] += 1
            yield p

    model._pairs = counting
    return n


def run(device, seed: int) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
    """Fits Word2Vec (negative sampling, then hierarchical softmax), GloVe
    and ParagraphVectors on ``device`` and infers one unseen document's
    vector. Returns the tables and, per model, its fit seconds and sizes."""
    import torch

    from deeplearning4j_tpu_torch.nlp import Glove, LabelledDocument, ParagraphVectors, Word2Vec

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    tables, stats = {}, {}
    w2v_text = _sentences(zipf_tokens(W2V_TOKENS, W2V_TYPES, seed), SENTENCE)
    for name, hs in (("w2v_ns", False), ("w2v_hs", True)):
        model = Word2Vec(hs=hs, seed=seed, device=device, **W2V)
        pairs = _counted(model)
        t0 = time.perf_counter()
        model.fit(w2v_text)
        sync()
        secs = time.perf_counter() - t0
        tables[f"{name}_syn0"], tables[f"{name}_syn1"] = model.syn0, model.syn1
        stats[name] = dict(seconds=secs, pairs=pairs[0], vocab=len(model.vocab),
                           tokens=W2V_TOKENS)
    glove_text = _sentences(zipf_tokens(GLOVE_TOKENS, GLOVE_TYPES, seed + 1), SENTENCE)
    glove = Glove(seed=seed, device=device, **GLOVE)
    t0 = time.perf_counter()
    glove.fit(glove_text)
    sync()
    stats["glove"] = dict(seconds=time.perf_counter() - t0, vocab=len(glove.vocab),
                          tokens=GLOVE_TOKENS, epochs=glove.epochs)
    tables["glove_syn0"] = glove.syn0
    docs = _sentences(zipf_tokens(PV_DOCS * PV_DOC_LEN + UNSEEN_DOC, PV_TYPES, seed + 2),
                      PV_DOC_LEN)
    pv = ParagraphVectors(seed=seed, device=device, **PV)
    t0 = time.perf_counter()
    pv.fit([LabelledDocument(d, f"doc{i}") for i, d in enumerate(docs[:PV_DOCS])])
    sync()
    stats["pv"] = dict(seconds=time.perf_counter() - t0, docs=PV_DOCS,
                       vocab=len(pv._w2v.vocab), epochs=pv.epochs)
    tables["pv_docs"], tables["pv_syn1"] = pv.doc_vectors, pv._syn1_final
    tables["pv_unseen"] = pv.infer_vector(docs[PV_DOCS])
    return tables, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0: default)")
    ap.add_argument("--out", required=True, help="npz of the tables")
    args = ap.parse_args(argv)
    import json

    import torch

    if args.threads:
        torch.set_num_threads(args.threads)
    tables, stats = run(args.device, args.seed)
    np.savez(args.out, stats=np.asarray(json.dumps(stats)), **tables)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
