#!/usr/bin/env python3
"""How far float32 gradients of the imported Keras ResNet-50 lie from float64,
in the JAX package and in the PyTorch port, on the CPU.

Needs JAX and h5py (for the JAX package's importer); downloads nothing. Run
from the repository root::

    JAX_PLATFORMS=cpu python tools/keras_resnet50_grad_precision.py

Both packages import the Keras ResNet-50 skeleton filled from seed 0
(``deeplearning4j_tpu_torch/tools/keras_resnet50.py``), copy it into a
float64 network, and take ``calculate_gradients`` on one batch of 8 seeded
224x224 images with one-hot labels (``chip_smoke.py``'s fine-tune phase's
first batch: ``RandomState(1274)`` images, ``RandomState(1275)`` labels),
batch norms in training mode. Printed for each package: the worst
per-parameter error, the norm of the float32 - float64 difference over the
larger of the float64 gradient's norm and 1e-4 of the largest
(``chip_smoke.py``'s rule), with the parameter's name; and the error of the
whole gradient vector by norm.
"""

import dataclasses
import gzip
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from deeplearning4j_tpu_torch.tools import keras_resnet50 as kr  # noqa: E402

FLOOR = 1e-4


def report(name, g32, g64):
    norms = {key: float(np.linalg.norm(g)) for key, g in g64.items()}
    floor = FLOOR * max(norms.values())
    errs = {key: float(np.linalg.norm(g32[key] - g64[key])) for key in g64}
    worst = max((errs[k] / max(norms[k], floor), "/".join(k)) for k in g64)
    total = np.sqrt(sum(e * e for e in errs.values())) / np.sqrt(sum(n * n for n in norms.values()))
    print(f"{name}: worst per-parameter f32 vs f64 error (by norm) {worst[0]:.3e} at {worst[1]}; "
          f"whole gradient {total:.3e}")


def batch():
    x = np.random.RandomState(1234 + 40).randn(8, 3, 224, 224).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[np.random.RandomState(1234 + 41).randint(0, 1000, 32)][:8]
    return x, y


def jax_grads():
    import h5py
    import jax.numpy as jnp

    from deeplearning4j_tpu.modelimport import KerasModelImport
    from deeplearning4j_tpu.nn.graph import ComputationGraph

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "filled.h5")
        with open(path, "wb") as f:
            f.write(gzip.decompress(kr.SKELETON.read_bytes()))
        with h5py.File(path, "r+") as f:
            specs = []
            f.visititems(lambda n, o: specs.append(("/" + n, o.shape))
                         if isinstance(o, h5py.Dataset) else None)
            for p, a in kr.fill_arrays(specs, 0).items():
                f[p][...] = a
        net = KerasModelImport.import_keras_model_and_weights(path)
    n64 = ComputationGraph(dataclasses.replace(net.conf, dtype="float64")).init()
    n64.params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), net.params)
    n64.state = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), net.state)
    x, y = batch()
    g32, g64 = net.calculate_gradients(x, y), n64.calculate_gradients(x.astype(np.float64),
                                                                    y.astype(np.float64))

    def flat(g):
        return {(l, k): np.asarray(v, np.float64) for l, lg in g.items() for k, v in lg.items()}

    return flat(g32), flat(g64)


def port_grads():
    import torch

    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = KerasModelImport.import_keras_model_and_weights(kr.load(0), device="cpu")
    n64 = ComputationGraph(dataclasses.replace(net.conf, dtype="float64"), device="cpu").init()
    n64.set_params_flat(net.params_flat())
    n64.state = {n: {k: t.double() for k, t in st.items()} for n, st in net.state.items()}
    x, y = batch()
    g32 = net.calculate_gradients(torch.from_numpy(x), torch.from_numpy(y))
    g64 = n64.calculate_gradients(torch.from_numpy(x).double(), torch.from_numpy(y).double())
    return ({(l, k): v.double().numpy() for l, lg in g32.items() for k, v in lg.items()},
            {(l, k): v.numpy() for l, lg in g64.items() for k, v in lg.items()})


def main() -> int:
    t0 = time.time()
    report("port (torch, CPU)", *port_grads())
    report("JAX package (XLA, CPU)", *jax_grads())
    print(f"{time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
