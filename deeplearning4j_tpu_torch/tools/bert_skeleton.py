"""The frozen BERT-base graph of ``bench.py``'s SameDiff TF-import
benchmark, shipped as a skeleton and filled from a seed.

``data/bert_base_b16_t128.pb.gz`` is the GraphDef that ``bench.py``'s
``_frozen_bert(16, 128, 768, 12, 12, 30522)`` freezes (a random-initialised
``TFBertModel``: L 12, H 768, 12 heads, vocab 30522, on [16, 128] int32
ids), with every ``Const`` of more than 4,096 elements emptied: its dtype and
shape are kept, its values dropped (the 72 encoder kernels, the word and
position tables, the pooler's kernel). Everything kept is small (biases,
LayerNorm's gamma and beta, shape vectors, the 2 x 768 token-type table).
``tools/make_bert_skeleton.py`` at the repository root writes it, and the
JAX package's output on :func:`bench_ids` beside it
(``data/bert_base_b16_t128_jax_golden.npz``).

:func:`load_bert_base` reads the skeleton with the port's own reader (no
TensorFlow, no protobuf) and fills each emptied tensor, in node-name order,
from ``np.random.default_rng(seed)``: a standard normal times 0.02, clipped
to +-0.04, in float32 (BERT's ``initializer_range`` truncated normal). The
fill is numpy, so a test can write the very same arrays into a TF GraphDef
for the JAX importer (:func:`fill_arrays`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..samediff.tf_graphdef import GraphDef, read_graph_def

DATA = Path(__file__).resolve().parent / "data"
SKELETON = DATA / "bert_base_b16_t128.pb.gz"
GOLDEN = DATA / "bert_base_b16_t128_jax_golden.npz"
INPUT, OUTPUT = "input_ids", "Identity"
BATCH, SEQ, HIDDEN, VOCAB = 16, 128, 768, 30522
EMPTIED_MIN = 4096  # a Const of more elements than this ships without values


def _numel(node) -> int:
    return int(np.prod([d.size for d in node.attr["value"].tensor.tensor_shape.dim],
                       dtype=np.int64))


def emptied(gd) -> List[str]:
    """Names of the emptied constants, sorted: every ``Const`` of more than
    ``EMPTIED_MIN`` elements whose tensor holds no values."""
    out = []
    for n in gd.node:
        if n.op != "Const" or _numel(n) <= EMPTIED_MIN:
            continue
        t = n.attr["value"].tensor
        if not t.tensor_content and not t.float_val:
            out.append(n.name)
    return sorted(out)


def fill_arrays(gd, seed: int) -> Dict[str, np.ndarray]:
    """The seeded float32 values of each emptied constant of ``gd`` (the
    port's or TF's GraphDef), drawn in node-name order."""
    rng = np.random.default_rng(seed)
    by_name = {n.name: n for n in gd.node}
    out = {}
    for name in emptied(gd):
        shape = [d.size for d in by_name[name].attr["value"].tensor.tensor_shape.dim]
        out[name] = np.clip(rng.standard_normal(shape) * 0.02, -0.04, 0.04).astype(np.float32)
    return out


def load_bert_base(seed: int = 0) -> Tuple[GraphDef, str, str]:
    """The skeleton filled from ``seed``: (GraphDef, input name, output name)."""
    gd = read_graph_def(SKELETON)
    by_name = {n.name: n for n in gd.node}
    for name, arr in fill_arrays(gd, seed).items():
        by_name[name].attr["value"].tensor.tensor_content = arr.tobytes()
    return gd, INPUT, OUTPUT


def bench_ids() -> np.ndarray:
    """``bench.py``'s ids: ``default_rng(0).integers(0, VOCAB, (BATCH, SEQ))``,
    the skeleton's static input shape."""
    return np.random.default_rng(0).integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)


def golden() -> Dict[str, np.ndarray]:
    """The JAX package's output on :func:`bench_ids` for seed 0 on the CPU:
    ``first2`` = positions 0-1 [16, 2, 768] float32, ``mean`` and
    ``mean_abs`` of the whole output."""
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}
