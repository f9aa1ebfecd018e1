"""The port's SameDiff engine and TF importer on the card.

These tests need a CUDA device and skip without one. Where there is one
(and no JAX for ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_samediff_cuda.py

* ``compile()`` captures small graphs as one CUDA graph (an MLP, and ops
  whose tables, shape vectors or numpy attrs reach the card: resize,
  mirror pads, reversed slices, color matrices, the attention op with a
  numpy key mask; dropout, the identity at inference; shapes, axes and
  paddings given as integer ndarrays): ``graphed`` is true and a replay
  equals eager ``output()`` within 1e-6; a graph with a while loop stays
  eager and names the op.
* Dropout under ``fit``, and every keyed random op given a generator on
  the card, draw there; one seed repeats its draw.
* The imported BERT-base skeleton (seed 0) on the card in float32 against
  the same graph in float64: within 1e-4 of the largest output.
* ``multi_head_dot_product_attention`` through B1 (forward) and B2/B3
  (``calculate_gradients``) against the attention seam's plain route:
  outputs within 1e-4, gradients within 1e-3, relative to the largest.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import ops as fa
from deeplearning4j_tpu_torch.samediff import SameDiff
from deeplearning4j_tpu_torch.samediff.tf_import import TFGraphMapper
from deeplearning4j_tpu_torch.tools import bert_skeleton

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SameDiff card path runs only there")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev
    fa.set_attention_impl("auto")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _mlp_graph():
    rs = np.random.RandomState(0)
    sd = SameDiff.create()
    x = sd.placeholder("x", (4, 16))
    h = sd.nn.gelu(x @ sd.var("w1", rs.randn(16, 32).astype(np.float32) * 0.1))
    h = sd.nn.layer_norm(h)
    (sd.nn.softmax(h @ sd.var("w2", rs.randn(32, 8).astype(np.float32) * 0.1))).rename("y")
    return sd, {"x": torch.from_numpy(rs.randn(4, 16).astype(np.float32)).cuda()}


def test_compile_graphs_and_matches_eager():
    sd, feeds = _mlp_graph()
    compiled = sd.compile(feeds, ["y"])
    assert compiled.graphed, compiled.reason
    eager = sd.output(feeds, ["y"])["y"]
    for _ in range(3):
        got = compiled(dict(sd._values), feeds)["y"]
        assert float((got - eager).abs().max()) <= 1e-6
    other = {"x": feeds["x"] * 2}
    assert float((compiled(dict(sd._values), other)["y"]
                  - sd.output(other, ["y"])["y"]).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="captured"):
        compiled({k: v.clone() for k, v in sd._values.items()}, feeds)


def test_compile_graphs_ops_with_tables_and_shapes():
    """Ops whose fixed tables (resize weights, pad indices, color matrices,
    shape vectors) or numpy attrs reach the card copy them on the eager
    call before the capture, so the replay issues no host copy."""
    rs = np.random.RandomState(2)
    sd = SameDiff.create()
    img = sd.placeholder("img", (2, 6, 8, 1))
    seq = sd.placeholder("seq", (2, 5, 8))
    mask = np.array([[1.0] * 5, [1.0, 1.0, 0.0, 0.0, 0.0]], np.float32)
    outs = {
        "shape": sd._op("cast", sd._op("shape_of", img), dtype="float32"),
        "size": sd._op("size", img), "rank": sd._op("rank", img),
        "rev": sd._op("strided_slice", img, begin=[-1, 0], end=[0, 0], strides=[-1, 1],
                      end_mask=3),
        "reflect": sd._op("pad", img, paddings=[[0, 0], [1, 2], [2, 1], [0, 0]], mode="REFLECT"),
        "symmetric": sd._op("mirror_pad", img, paddings=[[0, 0], [1, 1], [0, 2], [0, 0]],
                            mode="SYMMETRIC"),
        "bilinear": sd._op("resize_bilinear", img, size=(9, 5)),
        "bicubic": sd._op("resize_bicubic", img, size=(3, 4)),
        "nearest": sd._op("resize_nearest", img, size=(12, 3)),
        "sobel": sd._op("sobel_edges", img),
        "yiq": sd._op("rgb_to_yiq", sd._op("slice", seq, begin=[0, 0, 0], size=[-1, -1, 3])),
        "stats": sd._op("getitem", sd._op("sufficient_statistics", seq, axis=[1]), item=2),
        "quant": sd._op("fake_quant_with_min_max_args", seq, min=-1.0, max=1.0),
        "median": sd._op("reduce_median", seq, axis=[1]),
        "att": sd.nn.multi_head_dot_product_attention(
            seq, seq, seq, *(sd.var(n, rs.randn(8, 8).astype(np.float32) * 0.3)
                             for n in ("wq", "wk", "wv", "wo")), n_heads=2, mask=mask),
    }
    names = []
    for name, v in outs.items():
        v.rename(name)
        names.append(name)
    feeds = {"img": torch.from_numpy(rs.rand(2, 6, 8, 1).astype(np.float32)).cuda(),
             "seq": torch.from_numpy(rs.randn(2, 5, 8).astype(np.float32)).cuda()}
    compiled = sd.compile(feeds, names)
    assert compiled.graphed, compiled.reason
    eager = sd.output(feeds, names)
    got = compiled(dict(sd._values), feeds)
    for n in names:
        assert float((got[n].double() - eager[n].double()).abs().max()) <= 1e-6, n


def test_compile_graphs_dropout_and_integer_array_attrs():
    """Dropout returns its input at inference, and integer ndarray attrs
    are host values, so neither keeps the graph from being captured."""
    rs = np.random.RandomState(3)
    sd = SameDiff.create()
    x = sd.placeholder("x", (4, 6))
    h = sd.nn.dropout(x @ sd.var("w", rs.randn(6, 6).astype(np.float32)), rate=0.5)
    sd._op("reduce_mean", h, axis=np.array([1]), name="m")
    sd._op("pad", sd.math.reshape(h, shape=np.array([4, 2, 3])),
           paddings=np.array([[0, 0], [1, 0], [0, 2]]), name="p")
    sd.math.transpose(h, perm=np.array([1, 0])).rename("t")
    names = ["m", "p", "t"]
    feeds = {"x": torch.from_numpy(rs.randn(4, 6).astype(np.float32)).cuda()}
    compiled = sd.compile(feeds, names)
    assert compiled.graphed, compiled.reason
    eager = sd.output(feeds, names)
    got = compiled(dict(sd._values), feeds)
    for n in names:
        assert float((got[n] - eager[n]).abs().max()) <= 1e-6, n


def test_dropout_draws_on_the_card_under_fit():
    from deeplearning4j_tpu_torch.samediff import TrainingConfig
    from deeplearning4j_tpu_torch.train.updaters import Sgd

    sd = SameDiff.create()
    x = sd.placeholder("x", (256, 256))
    d = sd.nn.dropout(x, rate=0.25, name="d")
    sd._op("reduce_mean", sd._op("square", d @ sd.var("w", np.eye(256, dtype=np.float32))),
           name="loss")
    sd.set_loss_variables("loss")
    cfg = TrainingConfig(updater=Sgd(0.0), data_set_feature_mapping=("x",))
    ones = torch.ones(256, 256, device="cuda")
    loss = sd.fit([(ones, None)], cfg, epochs=1).loss_curve[0]
    # E[mask / 0.75^2] = 1 / 0.75 over 65,536 draws
    assert abs(float(loss) - 1 / 0.75) < 0.02
    drawn = sd._eval_graph({"x": ones}, dict(sd._values), ["d"],
                           rng=torch.Generator().manual_seed(5), training=True)["d"]
    assert drawn.is_cuda and abs(float((drawn == 0).float().mean()) - 0.25) < 0.01


def test_keyed_random_ops_draw_on_the_card():
    from deeplearning4j_tpu_torch.samediff.ops import SD_OPS, device_scope

    x = torch.arange(20.0, device="cuda").reshape(4, 5)
    calls = {name: {"shape": (64,)} for name in (
        "random_normal", "random_uniform", "random_bernoulli", "random_gamma", "random_poisson",
        "random_exponential", "random_truncated_normal", "random_binomial", "random_laplace",
        "random_cauchy")}
    calls.update(random_shuffle={"x": x}, random_crop={"x": x, "size": (2, 3)},
                 random_multinomial={"logits": torch.zeros(2, 3, device="cuda"),
                                     "num_samples": 4})
    with device_scope("cuda"):
        for name, kw in calls.items():
            draws = [SD_OPS[name](rng=torch.Generator(device="cuda").manual_seed(7), **kw)
                     for _ in range(2)]
            assert draws[0].is_cuda and torch.isfinite(draws[0].double()).all(), name
            assert torch.equal(draws[0], draws[1]), name


def test_compile_reports_host_ops():
    sd = SameDiff.create()
    x = sd.placeholder("x")
    outs = sd.while_loop([sd.constant(np.int32(0)), x],
                         lambda s, i, a: s._op("lt", i, s.constant(np.int32(3))),
                         lambda s, i, a: [s._op("add", i, s.constant(np.int32(1))),
                                          s._op("mul", a, a)])
    feeds = {"x": torch.tensor(1.1, device="cuda")}
    compiled = sd.compile(feeds, [outs[1].name])
    assert not compiled.graphed and "while_loop" in compiled.reason
    got = compiled(dict(sd._values), feeds)[outs[1].name]
    assert float(got) == pytest.approx(1.1 ** 8, rel=1e-5)


def test_bert_skeleton_f32_against_f64():
    gd, i, o = bert_skeleton.load_bert_base(0)
    sd = TFGraphMapper.import_graph(gd, outputs=[o])
    ids = torch.from_numpy(bert_skeleton.bench_ids()).cuda()  # the graph's static shape
    out = sd.output({i: ids}, [o])[o]
    sd._values = {k: v.double() if v.is_floating_point() else v for k, v in sd._values.items()}
    ref = sd.output({i: ids}, [o])[o]
    assert out.dtype == torch.float32 and ref.dtype == torch.float64
    assert _rel(out, ref) <= 1e-4


def test_attention_op_through_kernels_matches_plain_route():
    rs = np.random.RandomState(1)
    sd = SameDiff.create()
    x = sd.placeholder("x", (2, 96, 64))
    ws = [sd.var(n, (rs.randn(64, 64) * 0.1).astype(np.float32)) for n in ("wq", "wk", "wv", "wo")]
    mask = torch.tensor([[1.0] * 96, [1.0] * 40 + [0.0] * 56], device="cuda")
    att = sd.nn.multi_head_dot_product_attention(x, x, x, *ws, n_heads=4, mask=mask, name="att")
    sd._op("reduce_mean", sd._op("square", att), name="loss")
    sd.set_loss_variables("loss")
    feeds = {"x": torch.from_numpy(rs.randn(2, 96, 64).astype(np.float32)).cuda()}
    names = ["wq", "wk", "wv", "wo"]
    fa.reset_launch_counts()
    out = sd.output(feeds, ["att"])["att"]
    grads = sd.calculate_gradients(feeds, names)
    assert fa.LAUNCH_COUNTS["flash_forward"] == 2
    assert fa.LAUNCH_COUNTS["flash_bwd_dq"] == 1 and fa.LAUNCH_COUNTS["flash_bwd_dkv"] == 1
    fa.set_attention_impl("reference")
    ref = sd.output(feeds, ["att"])["att"]
    ref_grads = sd.calculate_gradients(feeds, names)
    assert _rel(out, ref) <= 1e-4
    for n in names:
        assert _rel(grads[n], ref_grads[n]) <= 1e-3, n
