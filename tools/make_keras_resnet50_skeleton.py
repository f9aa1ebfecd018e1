#!/usr/bin/env python3
"""Write the Keras ResNet-50 skeleton and its JAX golden for the PyTorch port
(``deeplearning4j_tpu_torch/tools/keras_resnet50.py``).

Needs TensorFlow/Keras, h5py and JAX; downloads nothing. Run from the
repository root::

    JAX_PLATFORMS=cpu python tools/make_keras_resnet50_skeleton.py

1. Saves ``keras.applications.ResNet50(weights=None)`` with ``model.save``
   to an h5 file in a temporary directory.
2. Rewrites it with h5py (``libver="earliest"``): every group and attribute
   (with its stored datatype) kept, every dataset created with its shape and
   dtype and never written. Writes it gzipped to
   ``deeplearning4j_tpu_torch/tools/data/keras_resnet50.h5.gz``.
3. Writes the port's seeded fill (seed 0, ``fill_arrays``) into a copy of
   the skeleton, imports it with the JAX package's ``KerasModelImport`` on
   the CPU (float32) and runs it on ``golden_input()``.
4. Writes ``keras_resnet50_jax_golden.npz`` beside the skeleton: the
   ``avg_pool`` features [2, 2048] and the probabilities [2, 1000]. The top
   probability must stay below 0.5, so that a gate on the probabilities is
   not a gate on a saturated softmax.
5. Saves a small functional model with a ``Lambda`` layer (``double_shift``:
   6 -> Dense 5 relu -> x * 2 + 1 -> Dense 3 softmax, Keras's seed 0),
   gzipped, as ``keras_lambda_graph.h5.gz``: the card test of the Lambda
   import reads it, where neither Keras nor h5py is installed.
"""

import gzip
import os
import shutil
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import h5py  # noqa: E402
import numpy as np  # noqa: E402

from deeplearning4j_tpu_torch.tools import keras_resnet50 as kr  # noqa: E402


def skeleton(src: str, dst: str) -> int:
    """Copy ``src``'s groups and attributes into ``dst``, datasets unwritten."""
    n = 0
    with h5py.File(src, "r") as fin, h5py.File(dst, "w", libver="earliest") as fout:
        def attrs(a, b):
            for k in a.attrs:
                b.attrs.create(k, a.attrs[k], dtype=a.attrs.get_id(k).dtype)

        def copy(name, obj):
            nonlocal n
            if isinstance(obj, h5py.Dataset):
                d = fout.create_dataset(name, shape=obj.shape, dtype=obj.dtype)
                n += 1
            else:
                d = fout.create_group(name)
            attrs(obj, d)

        attrs(fin, fout)
        fin.visititems(copy)
    return n


def main() -> int:
    t0 = time.time()
    import keras

    tmp = tempfile.mkdtemp()
    try:
        full = os.path.join(tmp, "resnet50.h5")
        keras.applications.ResNet50(weights=None).save(full)
        print(f"saved: {os.path.getsize(full)} bytes, {time.time() - t0:.1f} s")
        skel = os.path.join(tmp, "skeleton.h5")
        n = skeleton(full, skel)
        raw = open(skel, "rb").read()
        kr.DATA.mkdir(parents=True, exist_ok=True)
        with open(kr.SKELETON, "wb") as f:
            f.write(gzip.compress(raw, mtime=0))
        print(f"skeleton: {n} datasets unwritten, {len(raw)} bytes, "
              f"{os.path.getsize(kr.SKELETON)} gzipped -> {kr.SKELETON}")

        filled = os.path.join(tmp, "filled.h5")
        shutil.copy(skel, filled)
        with h5py.File(filled, "r+") as f:
            specs = []
            f.visititems(lambda name, o: specs.append(("/" + name, o.shape))
                         if isinstance(o, h5py.Dataset) else None)
            for path, arr in kr.fill_arrays(specs, 0).items():
                f[path][...] = arr
        from deeplearning4j_tpu.modelimport import KerasModelImport

        t1 = time.time()
        net = KerasModelImport.import_keras_model_and_weights(filled)
        assert net.num_params() == kr.N_PARAMS, net.num_params()
        print(f"JAX import: {time.time() - t1:.1f} s, {net.num_params()} params")
        acts, _ = net.forward_pure(net.params, net.state, [kr.golden_input()], train=False,
                                   rng=None)
        feats = np.asarray(acts[kr.FEATURES], np.float32)
        probs = np.asarray(acts[kr.OUTPUT], np.float32)
        assert feats.shape == (2, 2048) and probs.shape == (2, 1000), (feats.shape, probs.shape)
        top = probs.max(axis=1)
        print(f"features: mean {feats.mean():.6g}, max {feats.max():.6g}; top probabilities "
              f"{top.tolist()}")
        assert np.isfinite(feats).all() and top.max() < 0.5, top
        np.savez(kr.GOLDEN, features=feats, probs=probs)
        print(f"golden: {os.path.getsize(kr.GOLDEN)} bytes -> {kr.GOLDEN}")

        keras.utils.set_random_seed(0)
        inp = keras.layers.Input((6,))
        h = keras.layers.Dense(5, activation="relu")(inp)
        h = keras.layers.Lambda(lambda t: t * 2.0 + 1.0, name="double_shift")(h)
        lam = os.path.join(tmp, "lambda.h5")
        keras.Model(inp, keras.layers.Dense(3, activation="softmax")(h)).save(lam)
        with open(kr.LAMBDA_GRAPH, "wb") as f:
            f.write(gzip.compress(open(lam, "rb").read(), mtime=0))
        print(f"lambda graph: {os.path.getsize(kr.LAMBDA_GRAPH)} gzipped -> {kr.LAMBDA_GRAPH}; "
              f"{time.time() - t0:.1f} s in all")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
