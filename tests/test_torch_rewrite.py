"""The port's graph rewrite passes (``nn/rewrite/{base,passes}.py``) against
the JAX package's, on the CPU in float64 with the same weights.

* Each pass and pipeline on a sequential stem network (named and unnamed
  layers, so the inserted space-to-depth layer shifts the implicit
  ``layer_i`` names) and on the JAX package's zoo ResNet block graph
  (``tests/test_rewrite.py``'s): the same applied pass names, the same
  rewritten config JSON, the rewritten parameters bit-equal to JAX's (the
  fold's float64 host arithmetic, the stem's pad and reshape), and the
  output within 1e-10 of the JAX rewrite's and of the unrewritten model.
* The no-op contract: every pass either pipeline emits returns the same
  config, params and state objects on networks without its pattern (an
  LSTM stack, a TransformerLM, BERT's graph).
* ``resolve_passes``' specs and errors, ``Solver``/``GraphSolver``
  ``optimize=`` (the applied passes and the training scores of JAX's
  solvers on the same weights, within 1e-10), what ``rewrite_model``
  leaves alone and what ``rewrite_model_inplace`` rebuilds, and the
  artifact of a rewritten model's original staying un-rewritten."""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.core.config import to_json as jax_to_json
from deeplearning4j_tpu.model.zoo.resnet50 import ResNet50 as JaxResNet50
from deeplearning4j_tpu.model.zoo.transformer_lm import TransformerLM as JaxLM
from deeplearning4j_tpu.nn import (Activation as JA, InputType as JIT,
                                   LossFunction as JL, NeuralNetConfiguration as JNNC,
                                   WeightInit as JWI)
from deeplearning4j_tpu.nn import rewrite as jrw
from deeplearning4j_tpu.nn.layers import (ConvolutionMode as JCM,
                                          GlobalPoolingLayer as JGP, LSTMLayer as JLSTM,
                                          OutputLayer as JOut, PoolingType as JPT,
                                          RnnOutputLayer as JRnnOut,
                                          SubsamplingLayer as JSub)
from deeplearning4j_tpu.train.graph_solver import GraphSolver as JaxGraphSolver
from deeplearning4j_tpu.train.solver import Solver as JaxSolver

from deeplearning4j_tpu_torch.core.config import from_json, to_json
from deeplearning4j_tpu_torch.model import restore_model, write_model
from deeplearning4j_tpu_torch.model.zoo import BertEncoder, TransformerLM
from deeplearning4j_tpu_torch.nn.layers import LayerModule, SpaceToDepthLayer
from deeplearning4j_tpu_torch.nn import rewrite as prw
from deeplearning4j_tpu_torch.nn.sequential import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import Solver
from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver

from torch_rewrite_helpers import pair, stem_conf

TOL = 1e-10

# pass specs by name: the same spec is given to both packages
SPECS = {
    "stem": lambda m: [m.SpaceToDepthStemPass()],
    "fold": lambda m: [m.ConvBatchNormFoldPass()],
    "affine": lambda m: [m.BatchNormAffinePass()],
    "training": lambda m: "training",
    "inference": lambda m: "inference",
}


def _resnet_block_conf():
    """``tests/test_rewrite.py``'s zoo ResNet block: the stem conv+BN, a max
    pool, one projecting bottleneck, global pooling and the output layer."""
    rn = JaxResNet50(num_classes=4, height=32, width=32, dtype="float64")
    g = (JNNC.builder().seed(9).data_type("float64").updater(rn.updater)
         .weight_init(JWI.RELU).graph_builder().add_inputs("input"))
    x = rn._conv_bn(g, "stem", 16, (7, 7), (2, 2), "input")
    g.add_layer("stem_pool", JSub(kernel_size=(3, 3), stride=(2, 2),
                                  convolution_mode=JCM.SAME, pooling_type=JPT.MAX), x)
    x = rn._bottleneck(g, "s0b0", "stem_pool", (8, 8, 32), project=True)
    g.add_layer("avgpool", JGP(pooling_type=JPT.AVG), x)
    g.add_layer("fc", JOut(n_out=4, loss=JL.MCXENT, activation=JA.SOFTMAX), "avgpool")
    g.set_outputs("fc")
    g.set_input_types(JIT.convolutional(32, 32, 3))
    return g.build()


def _params_equal(pm, jm) -> None:
    assert sorted(pm.params) == sorted(jm.params)
    for l, lp in pm.params.items():
        assert sorted(lp) == sorted(jm.params[l]), l
        for k, p in lp.items():
            assert np.array_equal(p.detach().numpy(), np.asarray(jm.params[l][k])), (l, k)


def _check_rewrite(jconf, spec_name, x, expect):
    pm, jm = pair(jconf)
    base = pm.output(x).numpy()
    rm, applied = prw.rewrite_model(pm, SPECS[spec_name](prw))
    jrm, japplied = jrw.rewrite_model(jm, SPECS[spec_name](jrw))
    assert applied == japplied == expect
    assert json.loads(to_json(rm.conf)) == json.loads(jax_to_json(jrm.conf))
    _params_equal(rm, jrm)
    got = rm.output(x).numpy()
    assert np.abs(got - np.asarray(jrm.output(x))).max() <= TOL
    assert np.abs(got - base).max() <= TOL
    return pm, rm


_SEQ_EXPECT = {
    "stem": ["space_to_depth_stem"],
    "fold": ["conv_bn_fold"],
    "affine": ["bn_affine_precompute"],
    "training": ["space_to_depth_stem", "bn_affine_precompute"],
    "inference": ["space_to_depth_stem", "conv_bn_fold"],
}


@pytest.mark.parametrize("named", [True, False], ids=["named", "unnamed"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_sequential_pass_matches_jax(spec, named):
    x = np.random.RandomState(0).rand(3, 3, 16, 16)
    pm, rm = _check_rewrite(stem_conf(named), spec, x, _SEQ_EXPECT[spec])
    if spec in ("stem", "training", "inference"):
        assert isinstance(rm.layers[0], SpaceToDepthLayer)
        assert rm.layers[1].n_in == 12 and rm.layers[1].kernel_size == (4, 4)
    if spec in ("fold", "inference"):  # both BNs folded, the stem's s2d added
        assert len(rm.layers) == len(pm.layers) - 2 + (spec == "inference")
        assert not any(type(l).__name__ == "BatchNormalizationLayer" for l in rm.layers)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_resnet_block_graph_pass_matches_jax(spec):
    x = np.random.RandomState(0).rand(2, 3, 32, 32)
    expect = {"stem": ["space_to_depth_stem"], "fold": ["conv_bn_fold"],
              "affine": ["bn_affine_precompute"],
              "training": ["space_to_depth_stem", "bn_affine_precompute"],
              "inference": ["space_to_depth_stem", "conv_bn_fold"]}[spec]
    pm, rm = _check_rewrite(_resnet_block_conf(), spec, x, expect)
    names = [v.name for v in rm.conf.vertices]
    if "space_to_depth_stem" in expect:
        assert "stem_conv_s2d" in names
        assert rm.conf.spec("stem_conv").inputs == ("stem_conv_s2d",)
    if spec in ("fold", "inference"):
        assert not any(type(v.layer).__name__ == "BatchNormalizationLayer"
                       for v in rm.conf.vertices)


def test_stem_kernel_layout_is_an_exact_pad_and_reshape():
    pm, _ = pair(stem_conf(True))
    rm, _ = prw.rewrite_model(pm, [prw.SpaceToDepthStemPass()], context="training")
    w = pm.params["stem_conv"]["W"].detach().numpy()
    w2 = rm.params["stem_conv"]["W"].detach().numpy()
    assert w2.shape == (4, 12, 4, 4)
    for dh in range(7):
        for dw in range(7):
            m_, u, n_, v = dh // 2, dh % 2, dw // 2, dw % 2
            for c in range(3):
                assert np.array_equal(w2[:, (u * 2 + v) * 3 + c, m_, n_], w[:, c, dh, dw])
    assert np.count_nonzero(w2) == np.count_nonzero(w)


def test_stem_pass_skips_odd_input():
    conf = from_json(jax_to_json(stem_conf(True, hw=15)))
    pm = MultiLayerNetwork(conf, device="cpu").init()
    rm, applied = prw.rewrite_model(pm, [prw.SpaceToDepthStemPass()], context="training")
    assert rm is pm and applied == []


def _patternless():
    b = JNNC.builder().seed(17).data_type("float64").list()
    b.layer(JLSTM(n_out=8))
    b.layer(JLSTM(n_out=8))
    b.layer(JRnnOut(n_out=4, loss=JL.MCXENT, activation=JA.SOFTMAX))
    b.set_input_type(JIT.recurrent(5, 6))
    return MultiLayerNetwork(from_json(jax_to_json(b.build())), device="cpu").init()


def _discovered_passes(m):
    cands = m.training_passes() + m.inference_passes()
    for q in ("int8", "fp8"):
        cands += m.inference_passes(quantize=q)
    return sorted({p.name: p for p in cands}.items())


@pytest.mark.parametrize("which", ["lstm", "lm", "bert"])
def test_every_pass_is_a_noop_without_its_pattern(which):
    assert [n for n, _ in _discovered_passes(prw)] == [n for n, _ in _discovered_passes(jrw)]
    if which == "lstm":
        model = _patternless()
        quant_free = True
    elif which == "lm":
        model = TransformerLM(vocab_size=20, hidden=8, n_layers=1, n_heads=2,
                              max_len=8).init(device="cpu")
        quant_free = False  # its decoder block holds the quantizable products
    else:
        model = BertEncoder(vocab_size=20, hidden=8, n_layers=1, n_heads=2, ffn_size=16,
                            max_len=8).init(device="cpu")
        quant_free = False
    conf, params, state = model.conf, model.params, model.state
    before = to_json(conf)
    for name, p in _discovered_passes(prw):
        if name.startswith("quantize_weights") and not quant_free:
            continue
        conf2, params2, state2, changed = p.apply(conf, params, state)
        assert not changed, name
        assert conf2 is conf and params2 is params and state2 is state, name
        assert to_json(conf2) == before, name
    rm, applied = prw.rewrite_model(model, "inference")
    assert rm is model and applied == []


def test_resolve_passes_specs_and_errors():
    for spec in (None, False, True, "training", "inference", "inference:int8",
                 "inference:fp8"):
        for ctx in ("inference", "training"):
            try:
                want = [p.name for p in jrw.resolve_passes(spec, context=ctx)]
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    prw.resolve_passes(spec, context=ctx)
                assert str(got.value) == str(e)
                continue
            assert [p.name for p in prw.resolve_passes(spec, context=ctx)] == want
    for bad, ctx in (("nonsense", "inference"), ([jrw.ConvBatchNormFoldPass()], "training"),
                     ("inference:int4", "inference")):
        with pytest.raises(ValueError) as e:
            jrw.resolve_passes(bad, context=ctx)
        pbad = [prw.ConvBatchNormFoldPass()] if isinstance(bad, list) else bad
        with pytest.raises(ValueError) as got:
            prw.resolve_passes(pbad, context=ctx)
        assert str(got.value) == str(e.value)
    single = prw.BatchNormAffinePass()
    assert prw.resolve_passes(single, context="training") == [single]


def _stem_grads_match(rewritten, plain, stem, inputs, labels) -> None:
    """The training rewrite is an exact reparametrization at the start: the
    rewritten stem kernel's gradient at each original tap is the original
    kernel's gradient there, and every other parameter's gradient is the
    original's. (The 15 zero taps of the 8x8 padding get gradients too, so
    training moves them and later steps leave the original trajectory, in
    the JAX package as here.)"""
    g2 = rewritten.calculate_gradients(inputs, labels)
    g1 = plain.calculate_gradients(inputs, labels)
    taps = prw.SpaceToDepthStemPass._transform_kernel(torch.ones_like(g1[stem]["W"])) != 0
    mapped = prw.SpaceToDepthStemPass._transform_kernel(g1[stem]["W"])
    assert float((g2[stem]["W"] - mapped)[taps].abs().max()) <= TOL
    for l in g1:
        for k in g1[l]:
            if (l, k) != (stem, "W"):
                assert float((g2[l][k] - g1[l][k]).abs().max()) <= TOL, (l, k)


def test_solver_optimize_matches_jax_and_rejects_inference_passes():
    x = np.random.RandomState(0).rand(3, 3, 16, 16)
    y = np.eye(3)[np.random.RandomState(4).randint(0, 3, 3)]
    pm, jm = pair(stem_conf(True))
    plain, _ = pair(stem_conf(True))
    before = pm.output(x).numpy()
    ps = Solver(pm, optimize="training")
    js = JaxSolver(jm, optimize="training")
    assert ps.applied_rewrites == js.applied_rewrites == ["space_to_depth_stem",
                                                          "bn_affine_precompute"]
    assert isinstance(pm.layers[0], SpaceToDepthLayer)
    assert np.abs(pm.output(x).numpy() - before).max() <= TOL
    _stem_grads_match(pm, plain, "stem_conv", x, y)
    plain_solver = Solver(plain)
    assert plain_solver.applied_rewrites == []
    for step in range(3):
        ps_score, _ = ps.fit_batch(x, y)
        js_score, _ = js.fit_batch(x, y)
        plain_score, _ = plain_solver.fit_batch(x, y)
        assert abs(float(ps_score) - float(js_score)) <= TOL
        if step == 0:  # before any update the two graphs are one function
            assert abs(float(ps_score) - float(plain_score)) <= TOL
    assert np.abs(pm.output(x).numpy() - np.asarray(jm.output(x))).max() <= TOL
    with pytest.raises(ValueError, match="inference-only"):
        Solver(plain, optimize=[prw.ConvBatchNormFoldPass()])
    with pytest.raises(ValueError, match="inference-only"):
        Solver(plain, optimize="inference")


def test_graph_solver_optimize_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.rand(2, 3, 32, 32)
    y = np.eye(4)[rs.randint(0, 4, 2)]
    pm, jm = pair(_resnet_block_conf())
    plain, _ = pair(_resnet_block_conf())
    ps = GraphSolver(pm, optimize="training")
    js = JaxGraphSolver(jm, optimize="training")
    assert ps.applied_rewrites == js.applied_rewrites == ["space_to_depth_stem",
                                                          "bn_affine_precompute"]
    _stem_grads_match(pm, plain, "stem_conv", (x,), (y,))
    plain_solver = GraphSolver(plain)
    for step in range(3):
        ps_score = float(ps.fit_batch((x,), (y,)))
        js_score = float(js.fit_batch((x,), (y,)))
        assert abs(ps_score - js_score) <= TOL
        plain_score = float(plain_solver.fit_batch((x,), (y,)))
        if step == 0:
            assert abs(ps_score - plain_score) <= TOL
    for k in ("mean", "var"):
        assert np.abs(pm.state["stem_bn"][k].numpy()
                      - np.asarray(jm.state["stem_bn"][k])).max() <= TOL
    with pytest.raises(ValueError, match="inference-only"):
        GraphSolver(plain, optimize=[prw.ConvBatchNormFoldPass()])


def test_rewrite_model_copies_and_inplace_rebuilds():
    pm, _ = pair(stem_conf(False))
    x = np.random.RandomState(0).rand(2, 3, 16, 16)
    conf0 = pm.conf
    modules0 = dict(pm.named_children())
    w0 = pm.params["layer_0"]["W"].detach().clone()
    rm, applied = prw.rewrite_model(pm, "inference")
    assert applied and rm is not pm and rm.device == pm.device
    # the original is left as it was; untouched parameters are shared
    assert pm.conf is conf0 and dict(pm.named_children()) == modules0
    assert torch.equal(pm.params["layer_0"]["W"], w0)
    assert rm.params["layer_3"]["W"] is not pm.params["layer_3"]["W"]
    # in place: the solver's trainer, the transient carry and every old
    # module go; the rebuilt modules hold the rewritten triple
    pm._trainer = object()
    pm.rnn_state = {"layer_0": {"h": torch.zeros(1)}}
    old_params = {id(p) for p in pm.parameters()}
    applied2 = prw.rewrite_model_inplace(pm, "inference", context="inference")
    assert applied2 == applied
    assert pm._trainer is None and pm.rnn_state == {}
    assert pm.layers == pm.conf.layers and len(pm.layers) == 6
    assert sorted(n for n, m in pm.named_children() if isinstance(m, LayerModule)) == \
        pm.layer_names()
    assert sorted(pm._persistent_keys) == sorted(pm.state) == pm.layer_names()
    folded_conv = pm.params["layer_1"]["W"]
    assert id(folded_conv) not in old_params
    assert np.abs(pm.output(x).numpy() - rm.output(x).numpy()).max() == 0.0


def test_artifact_of_a_rewritten_models_original_stays_unrewritten(tmp_path):
    pm, _ = pair(stem_conf(True))
    x = np.random.RandomState(0).rand(2, 3, 16, 16)
    expected = pm.output(x).numpy()
    folded, applied = prw.rewrite_model(pm, "inference")
    assert "conv_bn_fold" in applied
    path = str(tmp_path / "m.zip")
    write_model(pm, path)
    again = restore_model(path, device="cpu")
    assert to_json(again.conf) == to_json(pm.conf)
    assert again.num_params() == pm.num_params()
    assert np.abs(again.output(x).numpy() - expected).max() == 0.0
    assert np.abs(folded.output(x).numpy() - expected).max() <= TOL


def test_lm_conf_json_unchanged_by_the_pipelines():
    # JAX's TransformerLM config decodes in the port and neither package
    # finds a structural pattern in it
    jm = JaxLM(vocab_size=20, hidden=8, n_layers=1, n_heads=2, max_len=8).init()
    pm = MultiLayerNetwork(from_json(jax_to_json(jm.conf)), device="cpu").init()
    for spec in ("training", "inference"):
        assert jrw.rewrite_model(jm, spec)[1] == prw.rewrite_model(pm, spec)[1] == []
