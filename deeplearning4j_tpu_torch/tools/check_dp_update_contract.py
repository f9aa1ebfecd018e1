#!/usr/bin/env python
"""Data-parallel weight-update contract of the port: the counterpart of the
JAX package's ``tools/check_dp_update_contract.py``.

It spawns a world of gloo ranks (each a process of this module) and holds,
on every rank, the ZeRO-1 sharded weight update and the compressed
gradient exchange end to end:

  * **Equivalence**: the ZeRO-1 trajectory (scores and final params) is the
    replicated-updater trajectory, on the implicit path (``SyncAllReduce``)
    and under a compressed strategy (``TopKCompressedSync``).
  * **Memory**: the updater bytes a rank holds shrink to about 1/N for an
    Adam-family updater (only the host step counts stay whole).
  * **Conservation**: top-k's residual error feedback loses nothing:
    ``exchanged + new_residual == grad + old_residual`` elementwise, and the
    realized density tracks the target.
  * **Checkpoint layout independence**: an ``OrbaxCheckpointer`` checkpoint
    of a ZeRO-1 trainer restores into a replicated one and trains on the
    same trajectory; another updater's checkpoint fails with a clear
    ``ValueError``.
  * **Observability**: ``dl4j_tpu_training_updater_state_bytes{sharded=}``
    and ``dl4j_tpu_training_grad_compression_ratio`` land in the registry
    and in the Prometheus exposition.
  * **Trust ratios**: ZeRO-1 x {Lars, Lamb} x {BucketedAllReduceSync,
    TopKCompressedSync} stays on the replicated trajectory (the layer norms
    are slice sums plus an all-reduce), and the trust-ratio series is
    exposed.

Run ``python -m deeplearning4j_tpu_torch.tools.check_dp_update_contract
[--device cpu] [--world N]``: on the card unless ``--device`` says
otherwise (ranks sharing ``cuda:0`` over gloo; world 2 by default there,
4 on the CPU). It prints each gate as it passes and exits non-zero on the
first that fails.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def _mlp(device, seed=7, updater=None):
    from deeplearning4j_tpu_torch.nn import (Activation, InputType, LossFunction,
                                             NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train import Adam

    conf = (NeuralNetConfiguration.builder().seed(seed).updater(updater or Adam(0.01)).list()
            .layer(DenseLayer(n_out=64, activation=Activation.TANH))
            .layer(OutputLayer(n_out=8, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(16)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _data(rank, world, n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 16).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.randint(0, 8, n)]
    per = n // world
    return x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]


def _params_close(a, b, rtol=2e-5, atol=2e-6):
    for ln in a:
        for pn in a[ln]:
            np.testing.assert_allclose(a[ln][pn].detach().cpu().numpy(),
                                       b[ln][pn].detach().cpu().numpy(),
                                       rtol=rtol, atol=atol, err_msg=f"{ln}/{pn}")


def run_gates(rank: int, world: int, device: str, log=print) -> None:
    """Every gate, on this rank (every rank of the world calls it)."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.obs.prom import render_prometheus
    from deeplearning4j_tpu_torch.parallel import (BucketedAllReduceSync, DistributedTrainer,
                                                   TopKCompressedSync)
    from deeplearning4j_tpu_torch.train import Lamb, Lars, OrbaxCheckpointer, Sgd

    say = log if rank == 0 else (lambda m: None)
    x, y = _data(rank, world)

    # --- 1. implicit-path equivalence + per-replica memory -----------------
    t_rep = DistributedTrainer(_mlp(device, 3))
    t_z = DistributedTrainer(_mlp(device, 3), zero1=True)
    for _ in range(5):
        s_rep = float(t_rep.fit_batch(x, y))
        s_z = float(t_z.fit_batch(x, y))
    assert np.isclose(s_rep, s_z, rtol=1e-5), (s_rep, s_z)
    _params_close(t_rep.model.params, t_z.model.params)
    say("PASS implicit-path zero1 trajectory == replicated")
    rep_b, z_b = t_rep.updater_state_bytes(), t_z.updater_state_bytes()
    # Adam: mu and nu are param-shaped and sliced; only the step counts stay
    assert z_b < rep_b / (world / 1.6), (z_b, rep_b)
    assert t_z.updater_state_bytes(per_replica=False) == rep_b
    assert t_z.stats()["zero1"] and t_z.stats()["updater_state_bytes"] == z_b
    say(f"PASS per-replica updater bytes {rep_b} -> {z_b} (~1/{world})")

    # --- 2. equivalence under compression -------------------------------------
    e_rep = DistributedTrainer(_mlp(device, 5), strategy=TopKCompressedSync(density=0.05))
    e_z = DistributedTrainer(_mlp(device, 5), strategy=TopKCompressedSync(density=0.05),
                             zero1=True)
    for _ in range(5):
        s0 = float(e_rep.fit_batch(x, y))
        s1 = float(e_z.fit_batch(x, y))
    assert np.isclose(s0, s1, rtol=1e-5), (s0, s1)
    _params_close(e_rep.model.params, e_z.model.params)
    comp = e_z.compression_stats()
    assert comp and comp["compression_ratio"] > 1.0, comp
    assert e_z.threshold_value() is None  # top-k has no threshold
    say(f"PASS explicit-path zero1 under top-k, ratio {comp['compression_ratio']:.1f}x")

    # --- 3. top-k residual-feedback conservation --------------------------------
    topk = TopKCompressedSync(density=0.1)
    g = {"l": {"W": torch.linspace(-1, 1, 64, device=device).reshape(8, 8)}}
    synced, new_st = topk.sync(g, topk.init_state(g), t_z.group)
    exchanged = synced["l"]["W"].cpu().numpy()
    residual = new_st["residual"]["l"]["W"].cpu().numpy()
    # identical gradients on every rank: the mean of the exchanged is the
    # exchanged, so exchanged + residual rebuilds the accumulator
    np.testing.assert_allclose(exchanged + residual, g["l"]["W"].cpu().numpy(), atol=1e-7)
    got_density = float(np.mean(exchanged != 0))
    assert 0.05 <= got_density <= 0.2, got_density
    say(f"PASS top-k conservation, realized density {got_density:.3f}")

    # --- 4. checkpoint layout independence + a clear mismatch error -------------
    tmp = [tempfile.mkdtemp(prefix="dp_contract_") if rank == 0 else None]
    dist.broadcast_object_list(tmp, src=0)
    ck = OrbaxCheckpointer(os.path.join(tmp[0], "ck"), async_save=False)
    ck.save(5, t_z)
    ck.wait()
    ref = [float(t_z.fit_batch(x, y)) for _ in range(2)]
    back = DistributedTrainer(_mlp(device, 3))  # a replicated trainer
    meta = ck.restore(back)
    assert meta["zero1"] is True and meta["data_axis"] == world, meta
    got = [float(back.fit_batch(x, y)) for _ in range(2)]
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    wrong = DistributedTrainer(_mlp(device, 3, updater=Sgd(0.1)))
    try:
        ck.restore(wrong)
        raise AssertionError("incompatible restore did not raise")
    except ValueError as e:
        assert "incompatible" in str(e) and "opt_state" in str(e), e
    ck.close()
    dist.barrier()
    if rank == 0:
        import shutil

        shutil.rmtree(tmp[0], ignore_errors=True)
    say("PASS zero1->replicated checkpoint round trip + mismatch error")

    # --- 4b. zero1 x {Lars, Lamb} x {Bucketed, TopK} ----------------------------
    for updater in (Lars(0.1), Lamb(0.01)):
        for strat_cls, kw in ((BucketedAllReduceSync, {"bucket_bytes": 1 << 12}),
                              (TopKCompressedSync, {"density": 0.05})):
            c_rep = DistributedTrainer(_mlp(device, 7, updater), strategy=strat_cls(**kw))
            c_z = DistributedTrainer(_mlp(device, 7, updater), strategy=strat_cls(**kw),
                                     zero1=True)
            for _ in range(4):
                sr = float(c_rep.fit_batch(x, y))
                sz = float(c_z.fit_batch(x, y))
            names = (type(updater).__name__, strat_cls.__name__)
            assert np.isclose(sr, sz, rtol=1e-5), (names, sr, sz)
            _params_close(c_rep.model.params, c_z.model.params)
            trust = c_z.trust_ratio_stats()
            assert trust and all(v["trust_ratio"] > 0 for v in trust.values()), (names, trust)
            say(f"PASS zero1 x {names[0]} x {names[1]}: trajectory == replicated, "
                f"trust ratios exposed")

    # --- 5. metrics land in the registry and the exposition ---------------------
    reg = MetricsRegistry()
    m = DistributedTrainer(_mlp(device, 9), zero1=True, strategy=TopKCompressedSync(density=0.05),
                           registry=reg)
    for _ in range(3):
        m.fit_batch(x, y)
    gauge = reg.get("dl4j_tpu_training_updater_state_bytes")
    assert gauge is not None and gauge.labels("true").value > 0
    hist = reg.get("dl4j_tpu_training_grad_compression_ratio")
    assert hist is not None and hist.labels("TopKCompressedSync").count == 3
    text = render_prometheus(reg)
    assert "dl4j_tpu_training_updater_state_bytes" in text
    assert "dl4j_tpu_training_grad_compression_ratio_bucket" in text
    say("PASS updater-bytes gauge + compression-ratio histogram exported")
    say("dp update contract OK")


def _rank_main(device: str) -> int:
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import initialize_distributed

    dev = "cuda:0" if device == "cuda" else "cpu"
    initialize_distributed(backend="gloo", device=dev)
    run_gates(dist.get_rank(), dist.get_world_size(), dev, log=lambda m: print(m, flush=True))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main(device: str = "cuda", world: int = 0, timeout: float = 600.0) -> int:
    """Spawn the ranks and wait; the output of rank 0 carries the gates.
    Returns 0 when every rank passed."""
    from deeplearning4j_tpu_torch.parallel.mesh import spawn_ranks, wait_ranks

    world = world or (2 if device == "cuda" else 4)
    env = dict(os.environ)
    if device != "cuda":
        env["OMP_NUM_THREADS"] = "1"
    procs = spawn_ranks([sys.executable, "-m",
                         "deeplearning4j_tpu_torch.tools.check_dp_update_contract",
                         "--worker", "--device", device], world, env=env)
    return abs(wait_ranks(procs, timeout=timeout))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=0)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        sys.exit(_rank_main(args.device))
    sys.exit(main(device=args.device, world=args.world))
