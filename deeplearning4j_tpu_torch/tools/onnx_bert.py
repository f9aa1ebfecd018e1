"""BERT-base as an ONNX skeleton, filled from a seed.

``data/onnx_bert_base_b16_t128.onnx.gz`` is a ModelProto (opset 17) of
BERT-base's encoder (L 12, H 768, 12 heads, FFN 3072, vocab 30522, 512
positions) on [16, 128] int64 ``input_ids`` and ``attention_mask``, with
output ``last_hidden_state`` [16, 128, 768]. It is spelled as the BERT-style
fixture of ``tests/test_onnx_import.py`` repeated over 12 layers (MatMul +
Add projections, Reshape/Transpose head splits, scaled scores, Softmax,
LayerNormalization, the erf GELU spelled out), behind word, position and
token-type embeddings, with the mask taken onto the scores as an exported
HF ``BertModel`` spells it: Unsqueeze -> Cast -> Sub from 1 -> Mul by
-10000 -> Add. Every initializer of more than 4,096 elements is emptied
(its dims kept, no data): the embedding tables and the 72 encoder kernels.
The rest keeps BERT's initial values (biases and LayerNorm's beta 0, its
gamma 1; the 2 x 768 token-type table seeded). ``tools/make_onnx_bert_skeleton.py``
at the repository root writes it, and beside it the JAX package's output
for seed 0 on :func:`bench_feeds` (``data/onnx_bert_base_b16_t128_jax_golden.npz``).

:func:`load` reads the skeleton with the port's own wire reader (no
protobuf) and fills each emptied initializer, in name order, from
``np.random.default_rng(seed)``: a standard normal times 0.02, clipped to
+-0.04, float32 (BERT's ``initializer_range``). :func:`fill_arrays` takes
the port's or protoc's ModelProto, so a test can put the very same arrays
into the JAX package's import.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..modelimport.onnx_proto import onnx_wire

DATA = Path(__file__).resolve().parent / "data"
SKELETON = DATA / "onnx_bert_base_b16_t128.onnx.gz"
GOLDEN = DATA / "onnx_bert_base_b16_t128_jax_golden.npz"
INPUTS, OUTPUT = ("input_ids", "attention_mask"), "last_hidden_state"
BATCH, SEQ, HIDDEN, HEADS, FFN, LAYERS, VOCAB, POSITIONS = 16, 128, 768, 12, 3072, 12, 30522, 512
EMPTIED_MIN = 4096  # an initializer of more elements than this ships without data


def emptied(model) -> List[str]:
    """Names of the emptied initializers, sorted: more than
    ``EMPTIED_MIN`` elements and no data."""
    return sorted(t.name for t in model.graph.initializer
                  if int(np.prod(list(t.dims), dtype=np.int64)) > EMPTIED_MIN
                  and not t.raw_data and not t.float_data)


def fill_arrays(model, seed: int) -> Dict[str, np.ndarray]:
    """The seeded float32 values of each emptied initializer of ``model``,
    drawn in name order."""
    rng = np.random.default_rng(seed)
    dims = {t.name: tuple(t.dims) for t in model.graph.initializer}
    return {name: np.clip(rng.standard_normal(dims[name]) * 0.02, -0.04, 0.04).astype(np.float32)
            for name in emptied(model)}


def load(seed: int = 0) -> onnx_wire.ModelProto:
    """The skeleton, read by the port's reader, with each emptied
    initializer's seeded values in ``raw_data``."""
    model = onnx_wire.ModelProto.FromString(gzip.decompress(SKELETON.read_bytes()))
    by_name = {t.name: t for t in model.graph.initializer}
    for name, arr in fill_arrays(model, seed).items():
        by_name[name].raw_data = arr.tobytes()
    return model


def bench_feeds() -> Dict[str, np.ndarray]:
    """``input_ids`` = ``default_rng(0).integers(0, VOCAB, (16, 128))``
    (the TF skeleton's ids) and ``attention_mask`` with seeded ragged
    lengths from ``default_rng(1)`` in [32, 128] (row 0 full), int64."""
    ids = np.random.default_rng(0).integers(0, VOCAB, (BATCH, SEQ)).astype(np.int64)
    lengths = np.random.default_rng(1).integers(32, SEQ + 1, BATCH)
    lengths[0] = SEQ
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int64)
    return {INPUTS[0]: ids, INPUTS[1]: mask}


def golden() -> Dict[str, np.ndarray]:
    """The JAX package's output on :func:`bench_feeds` for seed 0 on the
    CPU: ``first2`` = positions 0-1 [16, 2, 768] float32, and ``mean`` and
    ``mean_abs`` of the whole output, the padded positions included."""
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}
