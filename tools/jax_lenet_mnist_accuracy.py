#!/usr/bin/env python
"""The JAX package's LeNet-MNIST recipe on the CPU, for the accuracy gate of
the PyTorch port's "LeNet from MnistDataSetIterator" phase in chip_smoke.py.

The recipe is ``bench.py``'s LeNet row as ``chip_smoke.py`` drives it in the
port: the zoo ``LeNet(seed=...)``, one epoch of
``model.fit(MnistDataSetIterator(64, train=True, num_examples=12800))``,
then ``model.evaluate(MnistDataSetIterator(64, train=False))``. The digits
are the procedural ones (no download), the same bytes in both packages.
Prints one JSON line with the accuracy. Run from the repository root::

    JAX_PLATFORMS=cpu python tools/jax_lenet_mnist_accuracy.py [--seed 1234]
"""

from __future__ import annotations

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

from deeplearning4j_tpu.data.mnist import MnistDataSetIterator  # noqa: E402
from deeplearning4j_tpu.model.zoo import LeNet  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--train-examples", type=int, default=12800)
    args = ap.parse_args()
    model = LeNet(seed=args.seed).init()
    t0 = time.perf_counter()
    model.fit(MnistDataSetIterator(args.batch, train=True, num_examples=args.train_examples),
              epochs=1)
    fit_s = time.perf_counter() - t0
    ev = model.evaluate(MnistDataSetIterator(args.batch, train=False))
    print(json.dumps({"package": "deeplearning4j_tpu", "platform": "cpu", "seed": args.seed,
                      "train_examples": args.train_examples,
                      "eval_examples": int(ev.confusion.sum()),
                      "accuracy": ev.accuracy(), "score": float(model.score_value),
                      "fit_s": fit_s}))


if __name__ == "__main__":
    main()
