#!/usr/bin/env python3
"""Write the ONNX BERT-base skeleton and its JAX golden for the PyTorch port
(``deeplearning4j_tpu_torch/tools/onnx_bert.py``).

Needs JAX and protobuf (the JAX package's vendored ``onnx_pb2``); downloads
nothing. Run from the repository root::

    JAX_PLATFORMS=cpu python tools/make_onnx_bert_skeleton.py

1. Builds the ModelProto (opset 17) of BERT-base's encoder on [16, 128]
   int64 ids and attention mask: ``tests/test_onnx_import.py``'s BERT-style
   block repeated over 12 layers, behind word, position and token-type
   embeddings and their LayerNorm, with the mask added onto the scores
   (Unsqueeze -> Cast -> Sub -> Mul -> Add). Biases and LayerNorm beta 0,
   gamma 1, the token-type table seeded.
2. Empties every initializer of more than 4,096 elements (dims kept) and
   writes the model gzipped to
   ``deeplearning4j_tpu_torch/tools/data/onnx_bert_base_b16_t128.onnx.gz``.
3. Fills those initializers with the port's rule (seed 0), imports the
   model with the JAX package's ``OnnxGraphMapper`` on the CPU (float32)
   and runs it on ``bench_feeds()``.
4. Writes ``onnx_bert_base_b16_t128_jax_golden.npz`` beside the skeleton:
   positions 0-1 of the output [16, 2, 768] float32, and the whole output's
   mean and mean absolute value (padded positions included).
"""

import gzip
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from deeplearning4j_tpu.modelimport.onnx_proto import onnx_pb2 as P  # noqa: E402
from deeplearning4j_tpu_torch.tools import onnx_bert as ob  # noqa: E402

_NP_TO_ONNX = {np.dtype(np.float32): 1, np.dtype(np.int64): 7}


def tensor(name, arr):
    t = P.TensorProto()
    t.name, t.data_type = name, _NP_TO_ONNX[arr.dtype]
    t.dims.extend(arr.shape)
    t.raw_data = np.ascontiguousarray(arr).tobytes()
    return t


def node(op, inputs, outputs, **attrs):
    n = P.NodeProto()
    n.op_type, n.name = op, outputs[0]
    n.input.extend(inputs)
    n.output.extend(outputs)
    for k, v in attrs.items():
        a = n.attribute.add()
        a.name = k
        if isinstance(v, int):
            a.type, a.i = P.AttributeProto.INT, v
        elif isinstance(v, float):
            a.type, a.f = P.AttributeProto.FLOAT, v
        else:
            a.type = P.AttributeProto.INTS
            a.ints.extend(v)
    return n


def value_info(name, elem, shape):
    vi = P.ValueInfoProto()
    vi.name = name
    vi.type.tensor_type.elem_type = elem
    for d in shape:
        vi.type.tensor_type.shape.dim.add().dim_value = d
    return vi


def build() -> P.ModelProto:
    b, s, h, nh, ffn = ob.BATCH, ob.SEQ, ob.HIDDEN, ob.HEADS, ob.FFN
    hd = h // nh
    rng = np.random.default_rng(1234)
    f32 = np.float32
    inits = {
        "emb.word": np.zeros((ob.VOCAB, h), f32), "emb.pos": np.zeros((ob.POSITIONS, h), f32),
        "emb.type": np.clip(rng.standard_normal((2, h)) * 0.02, -0.04, 0.04).astype(f32),
        "emb.ln_g": np.ones(h, f32), "emb.ln_b": np.zeros(h, f32),
        "position_ids": np.arange(s, dtype=np.int64)[None, :],
        "token_type_ids": np.zeros((1, s), np.int64),
        "split_shape": np.asarray([b, s, nh, hd], np.int64),
        "merge_shape": np.asarray([b, s, h], np.int64),
        "mask_axes": np.asarray([1, 2], np.int64),
        "scale": np.asarray(1.0 / np.sqrt(hd), f32), "half": np.asarray(0.5, f32),
        "one": np.asarray(1.0, f32), "inv_sqrt2": np.asarray(1.0 / np.sqrt(2.0), f32),
        "mask_min": np.asarray(-10000.0, f32),
    }
    nodes = [
        node("Gather", ["emb.word", "input_ids"], ["we"], axis=0),
        node("Gather", ["emb.pos", "position_ids"], ["pe"], axis=0),
        node("Gather", ["emb.type", "token_type_ids"], ["te"], axis=0),
        node("Add", ["we", "pe"], ["e1"]), node("Add", ["e1", "te"], ["e2"]),
        node("LayerNormalization", ["e2", "emb.ln_g", "emb.ln_b"], ["h0"], axis=-1,
             epsilon=1e-12),
        node("Unsqueeze", ["attention_mask", "mask_axes"], ["mask4"]),
        node("Cast", ["mask4"], ["maskf"], to=1),
        node("Sub", ["one", "maskf"], ["mask_inv"]),
        node("Mul", ["mask_inv", "mask_min"], ["mask_add"]),
    ]

    def proj(x, w, bias, out):
        return [node("MatMul", [x, w], [f"{out}_mm"]), node("Add", [f"{out}_mm", bias], [out])]

    def split(x, out):
        return [node("Reshape", [x, "split_shape"], [f"{out}_r"]),
                node("Transpose", [f"{out}_r"], [out], perm=[0, 2, 1, 3])]

    x = "h0"
    for i in range(ob.LAYERS):
        p = f"l{i:02d}."
        for w, shape in (("wq", (h, h)), ("wk", (h, h)), ("wv", (h, h)), ("wo", (h, h)),
                         ("wf1", (h, ffn)), ("wf2", (ffn, h))):
            inits[p + w] = np.zeros(shape, f32)
        for bname, n in (("bq", h), ("bk", h), ("bv", h), ("bo", h), ("bf1", ffn), ("bf2", h),
                         ("ln1_b", h), ("ln2_b", h)):
            inits[p + bname] = np.zeros(n, f32)
        inits[p + "ln1_g"], inits[p + "ln2_g"] = np.ones(h, f32), np.ones(h, f32)
        out = ob.OUTPUT if i == ob.LAYERS - 1 else f"{p}out"
        nodes += [
            *proj(x, p + "wq", p + "bq", p + "q"), *split(p + "q", p + "qh"),
            *proj(x, p + "wk", p + "bk", p + "k"), *split(p + "k", p + "kh"),
            *proj(x, p + "wv", p + "bv", p + "v"), *split(p + "v", p + "vh"),
            node("Transpose", [p + "kh"], [p + "kt"], perm=[0, 1, 3, 2]),
            node("MatMul", [p + "qh", p + "kt"], [p + "scores_raw"]),
            node("Mul", [p + "scores_raw", "scale"], [p + "scores"]),
            node("Add", [p + "scores", "mask_add"], [p + "scores_masked"]),
            node("Softmax", [p + "scores_masked"], [p + "probs"], axis=-1),
            node("MatMul", [p + "probs", p + "vh"], [p + "ctx_h"]),
            node("Transpose", [p + "ctx_h"], [p + "ctx_t"], perm=[0, 2, 1, 3]),
            node("Reshape", [p + "ctx_t", "merge_shape"], [p + "ctx"]),
            *proj(p + "ctx", p + "wo", p + "bo", p + "attn_out"),
            node("Add", [x, p + "attn_out"], [p + "res1"]),
            node("LayerNormalization", [p + "res1", p + "ln1_g", p + "ln1_b"], [p + "ln1"],
                 axis=-1, epsilon=1e-12),
            *proj(p + "ln1", p + "wf1", p + "bf1", p + "f1"),
            node("Mul", [p + "f1", "inv_sqrt2"], [p + "f1_s"]),
            node("Erf", [p + "f1_s"], [p + "f1_erf"]),
            node("Add", [p + "f1_erf", "one"], [p + "f1_e1"]),
            node("Mul", [p + "f1", p + "f1_e1"], [p + "f1_xe"]),
            node("Mul", [p + "f1_xe", "half"], [p + "gelu"]),
            *proj(p + "gelu", p + "wf2", p + "bf2", p + "f2"),
            node("Add", [p + "ln1", p + "f2"], [p + "res2"]),
            node("LayerNormalization", [p + "res2", p + "ln2_g", p + "ln2_b"], [out], axis=-1,
                 epsilon=1e-12),
        ]
        x = out
    m = P.ModelProto()
    m.ir_version, m.producer_name = 8, "make_onnx_bert_skeleton"
    op = m.opset_import.add()
    op.domain, op.version = "", 17
    g = m.graph
    g.name = "bert_base"
    g.node.extend(nodes)
    g.input.extend([value_info(n, 7, (b, s)) for n in ob.INPUTS])
    g.output.extend([value_info(ob.OUTPUT, 1, (b, s, h))])
    for name, arr in inits.items():
        t = tensor(name, arr)
        if arr.size > ob.EMPTIED_MIN:
            t.raw_data = b""
        g.initializer.append(t)
    return m


def main() -> int:
    t0 = time.time()
    m = build()
    raw = m.SerializeToString()
    ob.DATA.mkdir(parents=True, exist_ok=True)
    with open(ob.SKELETON, "wb") as f:
        f.write(gzip.compress(raw, mtime=0))
    n_emptied = len(ob.emptied(m))
    print(f"skeleton: {len(m.graph.node)} nodes, {len(m.graph.initializer)} initializers "
          f"({n_emptied} emptied), {len(raw)} bytes, {os.path.getsize(ob.SKELETON)} gzipped "
          f"-> {ob.SKELETON}")
    by_name = {t.name: t for t in m.graph.initializer}
    for name, arr in ob.fill_arrays(m, 0).items():
        by_name[name].raw_data = arr.tobytes()
    from deeplearning4j_tpu.modelimport.onnx import OnnxGraphMapper

    sd = OnnxGraphMapper.import_model(m, outputs=[ob.OUTPUT])
    out = np.asarray(sd.output(ob.bench_feeds(), [ob.OUTPUT])[ob.OUTPUT])
    assert out.shape == (ob.BATCH, ob.SEQ, ob.HIDDEN) and out.dtype == np.float32, out.shape
    assert np.isfinite(out).all()
    np.savez(ob.GOLDEN, first2=np.ascontiguousarray(out[:, :2, :]),
             mean=np.float64(out.mean(dtype=np.float64)),
             mean_abs=np.float64(np.abs(out).mean(dtype=np.float64)))
    print(f"golden: mean {out.mean(dtype=np.float64):.9g}, mean |x| "
          f"{np.abs(out).mean(dtype=np.float64):.9g}, {os.path.getsize(ob.GOLDEN)} bytes -> "
          f"{ob.GOLDEN}; {time.time() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
