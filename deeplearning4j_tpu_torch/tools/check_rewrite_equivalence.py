#!/usr/bin/env python
"""Graph-rewrite equivalence contract of the port: the counterpart of the JAX
package's ``tools/check_rewrite_equivalence.py``, with its gates in its
order and its tolerance (``TOL``).

Asserts the contract every rewrite pass must keep:

    match     → forward parity to float tolerance on ResNet-50-style
                graphs (ComputationGraph AND MultiLayerNetwork spellings),
                in both inference and training mode
    backward  → input gradients and shared-parameter gradients of
                training-safe passes match the unrewritten graph
    no match  → byte-identical config (to_json), the SAME params/state
                objects, changed=False — BERT-style (attention+LayerNorm),
                LSTM and MoE graphs pass through every pass untouched
    serving   → ModelManager.deploy serves the rewritten (BN-folded)
                graph by default while the store artifact stays
                un-rewritten

The graphs are the harness's own, which define the contract, in float32 by
default (on the card too: ``ops/helpers.py``'s convolution keeps cuDNN out
of TF32).

Run ``python -m deeplearning4j_tpu_torch.tools.check_rewrite_equivalence
[--device cpu]``: on the card unless ``--device`` says otherwise
(``--model`` is accepted and changes nothing: the graphs are the
contract's). It prints each gate as it passes and exits non-zero on the
first that fails.
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np

from deeplearning4j_tpu_torch.tools.contract_common import cli

TOL = 2e-5


def _build_sequential_stem(device, dtype, seed=7):
    from deeplearning4j_tpu_torch.nn import (
        Activation, InputType, LossFunction, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        ActivationLayer, BatchNormalizationLayer, ConvolutionLayer,
        ConvolutionMode, OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

    conf = (
        NeuralNetConfiguration.builder().seed(seed).data_type(dtype)
        .list()
        .layer(ConvolutionLayer(
            name="stem_conv", n_out=8, kernel_size=(7, 7), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME,
            activation=Activation.IDENTITY, has_bias=False))
        .layer(BatchNormalizationLayer(name="stem_bn"))
        .layer(ActivationLayer(name="stem_relu", activation=Activation.RELU))
        .layer(OutputLayer(name="out", n_out=5, loss=LossFunction.MCXENT,
                           activation=Activation.SOFTMAX))
        .set_input_type(InputType.convolutional(16, 16, 3))
        .build())
    return MultiLayerNetwork(conf, device=device).init()


def _build_graph_resnet_block(device, dtype, seed=11):
    """ResNet-50-style mini graph using the zoo's own block builders:
    7×7/2 stem conv+BN+relu → maxpool → one projected bottleneck →
    global-avg-pool → softmax."""
    from deeplearning4j_tpu_torch.model.zoo.resnet50 import ResNet50
    from deeplearning4j_tpu_torch.nn import (
        Activation, InputType, LossFunction, NeuralNetConfiguration,
        WeightInit,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionMode, GlobalPoolingLayer, OutputLayer, PoolingType,
        SubsamplingLayer,
    )

    rn = ResNet50(num_classes=5, height=32, width=32)
    g = (NeuralNetConfiguration.builder().seed(seed).data_type(dtype).updater(rn.updater)
         .weight_init(WeightInit.RELU).graph_builder().add_inputs("input"))
    x = rn._conv_bn(g, "stem", 16, (7, 7), (2, 2), "input")
    g.add_layer("stem_pool", SubsamplingLayer(
        kernel_size=(3, 3), stride=(2, 2),
        convolution_mode=ConvolutionMode.SAME,
        pooling_type=PoolingType.MAX), x)
    x = rn._bottleneck(g, "s0b0", "stem_pool", (8, 8, 32), project=True)
    g.add_layer("avgpool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), x)
    g.add_layer("fc", OutputLayer(n_out=5, loss=LossFunction.MCXENT,
                                  activation=Activation.SOFTMAX), "avgpool")
    g.set_outputs("fc")
    g.set_input_types(InputType.convolutional(32, 32, 3))
    return ComputationGraph(g.build(), device=device).init()


def _build_unmatched_nets(device, dtype):
    """Graphs without any rewrite pattern: BERT-style attention+LayerNorm,
    LSTM, and MoE."""
    from deeplearning4j_tpu_torch.nn import (
        Activation, InputType, LossFunction, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        DenseLayer, LSTMLayer, MixtureOfExpertsLayer, OutputLayer,
        RnnOutputLayer, SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.norm import LayerNormLayer
    from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork

    bert_ish = (NeuralNetConfiguration.builder().seed(3).data_type(dtype).list()
                .layer(SelfAttentionLayer(n_out=8, n_heads=2, project_input=True))
                .layer(LayerNormLayer())
                .layer(RnnOutputLayer(n_out=4, loss=LossFunction.MCXENT,
                                      activation=Activation.SOFTMAX))
                .set_input_type(InputType.recurrent(8, 6))
                .build())
    lstm = (NeuralNetConfiguration.builder().seed(4).data_type(dtype).list()
            .layer(LSTMLayer(n_out=8))
            .layer(RnnOutputLayer(n_out=4, loss=LossFunction.MCXENT,
                                  activation=Activation.SOFTMAX))
            .set_input_type(InputType.recurrent(5, 6))
            .build())
    moe = (NeuralNetConfiguration.builder().seed(5).data_type(dtype).list()
           .layer(DenseLayer(n_out=8, activation=Activation.RELU))
           .layer(MixtureOfExpertsLayer(n_out=8, num_experts=2, hidden=16))
           .layer(OutputLayer(n_out=4, loss=LossFunction.MCXENT,
                              activation=Activation.SOFTMAX))
           .set_input_type(InputType.feed_forward(6))
           .build())
    return {
        "bert_ish": MultiLayerNetwork(bert_ish, device=device).init(),
        "lstm": MultiLayerNetwork(lstm, device=device).init(),
        "moe": MultiLayerNetwork(moe, device=device).init(),
    }


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _input_grad(model, x, y):
    """d loss / d input: a parametrization-independent backward probe."""
    import torch

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    xx = torch.as_tensor(x, dtype=model.dtype, device=model.device).requires_grad_(True)
    yy = torch.as_tensor(y, dtype=model.dtype, device=model.device)
    if isinstance(model, ComputationGraph):
        s, _ = model.loss_pure(model.params, model.state, (xx,), (yy,),
                               rng=None, train=True)
    else:
        s, _ = model.loss_pure(model.params, model.state, xx, yy,
                               rng=None, train=True)
    return torch.autograd.grad(s, xx)[0]


def _shared_param_grads(model, x, y):
    """{layer: {param: grad}} for comparison across rewrites (shared
    layers keep their names; the transformed stem kernel is excluded by
    shape mismatch in the comparison)."""
    return model.calculate_gradients(x, y)


def main(device: str = "cuda", model="tiny", log=print, dtype: str = "float32",
         record=None) -> int:
    """Every gate, on the harness's graphs in ``dtype``; ``record`` (a
    dict, optional) receives, under ``"forward"``, one ``(label, passes,
    fitted base network, x, rewritten output)`` per matched rewrite."""
    from deeplearning4j_tpu_torch.core.config import to_json
    from deeplearning4j_tpu_torch.nn.rewrite import (
        BatchNormAffinePass,
        ConvBatchNormFoldPass,
        SpaceToDepthStemPass,
        inference_passes,
        resolve_passes,
        rewrite_model,
        training_passes,
    )

    record = {} if record is None else record
    record["forward"] = []
    fdt = np.dtype(dtype)
    rng = np.random.RandomState(0)
    every_pass = [SpaceToDepthStemPass(), ConvBatchNormFoldPass(),
                  BatchNormAffinePass()]

    # ---- matched graphs: forward + backward parity -----------------------
    for label, net, x, y in (
        ("sequential-stem", _build_sequential_stem(device, dtype),
         rng.rand(4, 3, 16, 16).astype(fdt),
         np.eye(5, dtype=fdt)[rng.randint(0, 5, 4)]),
        ("graph-resnet-block", _build_graph_resnet_block(device, dtype),
         rng.rand(2, 3, 32, 32).astype(fdt),
         np.eye(5, dtype=fdt)[rng.randint(0, 5, 2)]),
    ):
        # a few train steps so BN running stats are non-trivial
        net.fit(x, y, epochs=3)
        base_out = _np(net.output(x))
        base_igrad = _np(_input_grad(net, x, y))
        base_pgrads = _shared_param_grads(net, x, y)

        for p in every_pass + [inference_passes(), training_passes()]:
            plist = p if isinstance(p, list) else [p]
            pname = "+".join(q.name for q in plist)
            m2, applied = rewrite_model(net, plist, context="inference")
            assert applied, f"{label}: {pname} should have matched"
            out2 = _np(m2.output(x))
            record["forward"].append((label, pname, net, x, out2))
            diff = float(np.abs(out2 - base_out).max())
            assert diff < TOL, f"{label}/{pname}: forward diff {diff}"
            if all(q.training_safe for q in plist):
                ig = _np(_input_grad(m2, x, y))
                gdiff = float(np.abs(ig - base_igrad).max())
                assert gdiff < TOL, f"{label}/{pname}: input-grad diff {gdiff}"
                g2 = _shared_param_grads(m2, x, y)
                n_shared = 0
                for lname, lg in base_pgrads.items():
                    for k, g in lg.items():
                        other = g2.get(lname, {}).get(k)
                        if other is not None and other.shape == g.shape:
                            d = float(np.abs(_np(other) - _np(g)).max())
                            assert d < TOL, \
                                f"{label}/{pname}: grad[{lname}][{k}] {d}"
                            n_shared += 1
                assert n_shared > 0, f"{label}/{pname}: no shared params"
            log(f"ok: {label} / {pname} (forward diff {diff:.2e})")

    # ---- unmatched graphs: provable no-ops -------------------------------
    x_by_kind = {
        "bert_ish": rng.rand(2, 8, 6).astype(fdt),
        "lstm": rng.rand(2, 5, 6).astype(fdt),
        "moe": rng.rand(2, 6).astype(fdt),
    }
    for kind, net in _build_unmatched_nets(device, dtype).items():
        before_json = to_json(net.conf)
        # the port's params/state are built views: take each once, and the
        # pass must hand back the very objects it was given
        params, state = net.params, net.state
        for p in every_pass:
            conf2, params2, state2, changed = p.apply(net.conf, params, state)
            assert not changed, f"{kind}: {p.name} claimed a match"
            assert conf2 is net.conf, f"{kind}: {p.name} rebuilt config"
            assert params2 is params and state2 is state, \
                f"{kind}: {p.name} rebuilt params/state"
            assert to_json(conf2) == before_json
        m2, applied = rewrite_model(net, "inference")
        assert m2 is net and not applied
        out = _np(net.output(x_by_kind[kind]))  # still functional
        assert np.all(np.isfinite(out))
        log(f"ok: {kind} untouched by every pass")

    # ---- training-context gating -----------------------------------------
    try:
        resolve_passes([ConvBatchNormFoldPass()], context="training")
    except ValueError:
        log("ok: conv_bn_fold rejected at training time")
    else:
        raise AssertionError("inference-only pass accepted for training")

    # ---- serving: deploy serves the folded graph, store stays clean ------
    from deeplearning4j_tpu_torch.obs import MetricsRegistry
    from deeplearning4j_tpu_torch.serving import ModelManager, ModelStore

    net = _build_sequential_stem(device, dtype, seed=21)
    x = rng.rand(4, 3, 16, 16).astype(fdt)
    y = np.eye(5, dtype=fdt)[rng.randint(0, 5, 4)]
    net.fit(x, y, epochs=2)
    expected = _np(net.output(x))
    n_layers_orig = len(net.conf.layers)
    with tempfile.TemporaryDirectory() as root:
        store = ModelStore(root, device=device)
        store.publish("m", net)
        reg = MetricsRegistry()
        mgr = ModelManager(store, "m", registry=reg, warmup_example=x,
                           workers=1)
        try:
            served = _np(mgr.output(x))
            assert np.abs(served - expected).max() < TOL
            live = mgr.engine.model
            has_bn = any(type(l).__name__ == "BatchNormalizationLayer"
                         for l in live.conf.layers)
            assert not has_bn, "served graph still contains BatchNorm"
            events = reg.events("model_rewrite")
            assert events and "conv_bn_fold" in events[0]["passes"]
        finally:
            mgr.shutdown(drain=False)
        # the artifact in the store is the UN-rewritten model
        reloaded, _ = store.load("m")
        assert to_json(reloaded.conf) == to_json(net.conf)
        assert len(reloaded.conf.layers) == n_layers_orig
    log("ok: deploy serves folded graph; store artifact un-rewritten")

    log("rewrite equivalence contract: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(cli(main, __doc__))
