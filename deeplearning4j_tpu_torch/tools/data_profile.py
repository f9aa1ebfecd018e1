"""Where the two iterator-fed training paths spend their time on the card.

Run from the repository root on a machine with a CUDA device::

    python3 -m deeplearning4j_tpu_torch.tools.data_profile

1. LeNet from ``MnistDataSetIterator``: the zoo ``LeNet()`` trained by
   ``model.fit`` over one epoch of 64-image batches (the procedural digits
   made on the host, each batch copied to the card by the step).
2. ResNet-50 from image files: 512 seeded 256x256x3 P6 ``.ppm`` files in 8
   class directories -> ``ImageRecordReader(output_dtype="uint8")`` ->
   ``RecordReaderDataSetIterator(batch_size=128)`` ->
   ``AsyncDataSetIterator(device_put_fn=device_put_dataset,
   device_buffers=2)`` -> ``MappedDataSetIterator`` (NHWC -> NCHW, /255,
   random 224 crop and flip on the card) -> ``GraphSolver.fit_iterator`` on
   ``ResNet50(num_classes=8, compute_dtype="bfloat16")``; beside it the
   same model's step on one synthetic batch already on the card.

For each it prints the host wall time of an unprofiled run, the device busy
time that ``torch.profiler`` attributes to CUDA kernels in a profiled run,
the device's idle share (1 - busy / wall), the kernel launches and the top
kernels; for the file pipeline also the prefetch iterator's ``stats()``.
``chip_smoke.py`` imports the file writer and the pipeline from here.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.image_transform import batch_random_crop, batch_random_flip
from deeplearning4j_tpu_torch.data.iterators import (AsyncDataSetIterator,
                                                     MappedDataSetIterator, device_put_dataset)
from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.data.records import ImageRecordReader, RecordReaderDataSetIterator
from deeplearning4j_tpu_torch.model.zoo import LeNet, ResNet50
from deeplearning4j_tpu_torch.obs import MetricsRegistry
from deeplearning4j_tpu_torch.tools.serving_profile import _device_profile
from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver

SEED = 1234
LENET_BATCH = 64
N_IMAGES, RAW, OUT, N_CLASSES, FILE_BATCH = 512, 256, 224, 8, 128


def write_ppm_tree(root: str, n_images: int = N_IMAGES, raw: int = RAW,
                   n_classes: int = N_CLASSES, seed: int = 0) -> None:
    """``bench.py``'s image files: ``n_images`` P6 files of raw x raw x 3
    random bytes from ``seed``, image i in class directory ``c{i % n}``."""
    rng = np.random.RandomState(seed)
    header = f"P6 {raw} {raw} 255\n".encode()
    for c in range(n_classes):
        os.makedirs(os.path.join(root, f"c{c}"), exist_ok=True)
    for i in range(n_images):
        body = rng.randint(0, 256, (raw, raw, 3), np.uint8).tobytes()
        with open(os.path.join(root, f"c{i % n_classes}", f"{i}.ppm"), "wb") as f:
            f.write(header + body)


def augment(features: torch.Tensor, gen: torch.Generator, out: int = OUT) -> torch.Tensor:
    """[b, raw, raw, 3] uint8 on the card -> [b, 3, out, out] float32 in
    [0, 1], randomly cropped and flipped, on the card."""
    x = features.permute(0, 3, 1, 2).float() * (1.0 / 255.0)
    return batch_random_flip(batch_random_crop(x, gen, out, out), gen)


def image_batches(root: str, batch: int = FILE_BATCH, raw: int = RAW,
                  n_classes: int = N_CLASSES) -> RecordReaderDataSetIterator:
    """The host half: files -> uint8 [b, raw, raw, 3] batches, one-hot labels."""
    reader = ImageRecordReader(raw, raw, 3, root=root, output_dtype="uint8")
    return RecordReaderDataSetIterator(reader, batch_size=batch, label_index=1,
                                       num_classes=n_classes)


def file_pipeline(root: str, gen: torch.Generator, *, registry=None, put=device_put_dataset,
                  batch: int = FILE_BATCH):
    """(mapped iterator, its prefetch iterator): the whole input path of the
    ResNet-50-from-files run."""
    prefetch = AsyncDataSetIterator(image_batches(root, batch), device_put_fn=put,
                                    device_buffers=2,
                                    registry=registry if registry is not None else MetricsRegistry())
    return MappedDataSetIterator(prefetch, feature_fn=lambda f: augment(f, gen)), prefetch


def _report(label: str, wall_ms: float, fn, images: int) -> None:
    busy, launches, rows = _device_profile(fn)
    print(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}, {launches:.0f} kernel launches, "
          f"{images / wall_ms * 1e3:.1f} images/s")
    for key, ms, count in rows[:8]:
        print(f"    {ms:9.4f} ms  {count:6.0f}x  {key[:100]}")


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("data_profile needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    # ---- LeNet from MnistDataSetIterator: a 20-batch epoch ----
    lenet = LeNet(seed=SEED).init()
    n = 20 * LENET_BATCH
    data = MnistDataSetIterator(LENET_BATCH, train=True, num_examples=n)
    lenet.fit(data, epochs=1)                     # warm-up: cuDNN handles, pools
    wall = _timed(lambda: lenet.fit(data, epochs=1))
    _report(f"LeNet fit(MnistDataSetIterator) {n // LENET_BATCH} x [{LENET_BATCH},784]", wall,
            lambda: lenet.fit(data, epochs=1), n)
    del lenet

    # ---- ResNet-50 from files, bf16 compute ----
    root = tempfile.mkdtemp(prefix="data_profile_")
    try:
        write_ppm_tree(root)
        model = ResNet50(seed=SEED, num_classes=N_CLASSES, compute_dtype="bfloat16").init()
        solver = GraphSolver(model)
        gen = torch.Generator(device="cuda").manual_seed(SEED)

        def one_pass():
            it, prefetch = file_pipeline(root, gen)
            try:
                solver.fit_iterator(it, epochs=1)
            finally:
                prefetch.close()
            return prefetch

        one_pass()                                # warm-up: cuDNN plans, page cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefetch = one_pass()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        print(f"prefetch stats: {prefetch.stats()}")
        _report(f"ResNet-50 bf16 fit_iterator from {N_IMAGES} files, batch {FILE_BATCH}", wall,
                one_pass, N_IMAGES)
        rs = np.random.RandomState(SEED)
        x = torch.from_numpy(rs.rand(FILE_BATCH, 3, OUT, OUT).astype(np.float32)).cuda()
        y = torch.from_numpy(np.eye(N_CLASSES, dtype=np.float32)[
            rs.randint(0, N_CLASSES, FILE_BATCH)]).cuda()
        solver.fit_batch((x,), (y,))
        steps = N_IMAGES // FILE_BATCH

        def synthetic():
            for _ in range(steps):
                solver.fit_batch((x,), (y,))

        _report(f"ResNet-50 bf16 synthetic batch on the card, {steps} steps of {FILE_BATCH}",
                _timed(synthetic), synthetic, N_IMAGES)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
