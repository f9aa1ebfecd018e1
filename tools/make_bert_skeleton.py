#!/usr/bin/env python3
"""Write the frozen BERT-base skeleton and its JAX golden for the PyTorch
port (``deeplearning4j_tpu_torch/tools/bert_skeleton.py``).

Needs TensorFlow, transformers and JAX; downloads nothing. Run from the
repository root::

    JAX_PLATFORMS=cpu python tools/make_bert_skeleton.py

1. Freezes ``bench.py``'s ``_frozen_bert(16, 128, 768, 12, 12, 30522)``.
2. Empties every ``Const`` of more than 4,096 elements (dtype and shape
   kept) and writes the GraphDef gzipped to
   ``deeplearning4j_tpu_torch/tools/data/bert_base_b16_t128.pb.gz``.
3. Fills those constants with the port's fill rule (seed 0), imports the
   graph with the JAX package's ``TFGraphMapper`` on the CPU (float32) and
   runs it on ``bench.py``'s ids.
4. Writes ``bert_base_b16_t128_jax_golden.npz`` beside the skeleton: the
   output's first two positions [16, 2, 768] float32, and the whole
   output's mean and mean absolute value.
"""

import gzip
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from bench import _frozen_bert  # noqa: E402
from deeplearning4j_tpu_torch.tools import bert_skeleton as bs  # noqa: E402


def main() -> int:
    t0 = time.time()
    frozen = _frozen_bert(bs.BATCH, bs.SEQ, bs.HIDDEN, 12, 12, bs.VOCAB)
    gd = frozen.graph.as_graph_def()
    in_name = frozen.inputs[0].name.split(":")[0]
    out_name = frozen.outputs[0].name.split(":")[0]
    assert (in_name, out_name) == (bs.INPUT, bs.OUTPUT), (in_name, out_name)
    print(f"frozen: {len(gd.node)} nodes, {gd.ByteSize()} bytes, {time.time() - t0:.1f} s")

    n_emptied = 0
    for n in gd.node:
        if n.op == "Const" and bs._numel(n) > bs.EMPTIED_MIN:
            n.attr["value"].tensor.tensor_content = b""
            del n.attr["value"].tensor.float_val[:]
            n_emptied += 1
    raw = gd.SerializeToString()
    bs.DATA.mkdir(parents=True, exist_ok=True)
    with open(bs.SKELETON, "wb") as f:
        f.write(gzip.compress(raw, mtime=0))
    print(f"skeleton: {n_emptied} constants emptied, {len(raw)} bytes, "
          f"{os.path.getsize(bs.SKELETON)} gzipped -> {bs.SKELETON}")

    by_name = {n.name: n for n in gd.node}
    for name, arr in bs.fill_arrays(gd, 0).items():
        by_name[name].attr["value"].tensor.tensor_content = arr.tobytes()
    from deeplearning4j_tpu.samediff.tf_import import TFGraphMapper

    sd = TFGraphMapper.import_graph(gd, outputs=[out_name])
    out = np.asarray(sd.output({in_name: bs.bench_ids()}, [out_name])[out_name])
    assert out.shape == (bs.BATCH, bs.SEQ, bs.HIDDEN) and out.dtype == np.float32, out.shape
    np.savez(bs.GOLDEN, first2=np.ascontiguousarray(out[:, :2, :]),
             mean=np.float64(out.mean(dtype=np.float64)),
             mean_abs=np.float64(np.abs(out).mean(dtype=np.float64)))
    print(f"golden: mean {out.mean(dtype=np.float64):.9g}, mean |x| "
          f"{np.abs(out).mean(dtype=np.float64):.9g}, {os.path.getsize(bs.GOLDEN)} bytes -> "
          f"{bs.GOLDEN}; {time.time() - t0:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
