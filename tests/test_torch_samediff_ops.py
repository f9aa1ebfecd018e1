"""The port's SameDiff op registry against the JAX package's, op by op.

* The registry holds the JAX package's 503 names, no more and no fewer, and
  the port's TF rules cover the JAX package's 227.
* One parity case per deterministic op: the same seeded numpy inputs through
  ``deeplearning4j_tpu.samediff.ops`` (JAX with x64, as ``tests/conftest.py``
  sets it) and ``deeplearning4j_tpu_torch.samediff.ops`` (CPU torch), every
  output held for shape, dtype and value. Float64 inputs, 1e-10 relative
  where the math is the same; looser only where named in ``TOL``. Ops whose
  outputs are defined up to sign or order (SVD, QR, eigh, LU) are compared
  by reconstruction. ``DTYPE_FREE`` names the ops whose output dtype comes
  from a Python float (JAX with x64 makes it float64, JAX on a card and torch
  float32); their values are still held.
* The keyed random ops cannot match threefry's bits: each is held by its
  law (mean, spread, support) on a large draw, and dropout by its keep rate
  and scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.samediff.ops import SD_OPS as J_OPS
from deeplearning4j_tpu.samediff.tf_import import TF_OP_RULES as J_RULES

from deeplearning4j_tpu_torch.samediff.ops import HOST_OPS, SD_OPS as P_OPS
from deeplearning4j_tpu_torch.samediff.tf_import import TF_OP_RULES as P_RULES

RANDOM_OPS = {"random_normal", "random_uniform", "random_bernoulli", "random_gamma",
              "random_poisson", "random_exponential", "random_shuffle",
              "random_truncated_normal", "random_crop", "random_binomial",
              "random_multinomial", "random_laplace", "random_cauchy"}


def test_registry_names_equal_jax():
    assert len(J_OPS) == 503
    assert sorted(P_OPS) == sorted(J_OPS)


def test_tf_rules_cover_jax():
    assert len(J_RULES) == 227
    assert sorted(P_RULES) == sorted(J_RULES)


def test_host_ops_are_registered_ops():
    assert HOST_OPS <= set(P_OPS) and RANDOM_OPS <= HOST_OPS


# ---- inputs ------------------------------------------------------------------
def rng(seed=0):
    return np.random.default_rng(seed)


def N(*shape, seed=0):
    return rng(seed).normal(size=shape)


def U(*shape, lo=0.0, hi=1.0, seed=0):
    return rng(seed).uniform(lo, hi, size=shape)


def I(*shape, lo=0, hi=10, seed=0, dtype=np.int32):
    return rng(seed).integers(lo, hi, size=shape).astype(dtype)


def B(*shape, seed=0):
    return rng(seed).random(shape) > 0.5


def spd(n=4, seed=0):
    a = N(n, n, seed=seed)
    return a @ a.T + n * np.eye(n)


# name -> (args, kwargs); a tuple of cases under one name is "name[i]"
CASES = {}


def case(name, *args, **kw):
    CASES.setdefault(name, []).append((args, kw))


# ---- elementwise -----------------------------------------------------------------
for _n in ["neg", "abs", "sign", "exp", "expm1", "sin", "cos", "tan", "atan", "sinh", "cosh",
           "tanh", "asinh", "erf", "erfc", "floor", "ceil", "round", "isnan", "isinf",
           "isfinite", "square", "reciprocal", "cube", "relu", "relu6", "elu", "selu",
           "sigmoid", "hard_sigmoid", "softplus", "softsign", "swish", "mish", "log_sigmoid",
           "exp2", "rint", "trunc", "frac", "hard_tanh", "rational_tanh", "rectified_tanh",
           "hard_swish", "tanhshrink", "gelu_precise", "ndtr", "sinc", "bessel_i0", "bessel_i1",
           "bessel_i0e", "bessel_i1e", "copy", "identity", "stop_gradient", "zeros_like",
           "ones_like", "squeeze_all", "atleast_2d", "l2_loss"]:
    case(_n, N(3, 4) * 3)
for _n in ["log", "log1p", "log2", "log10", "sqrt", "rsqrt", "lgamma", "digamma"]:
    case(_n, U(3, 4, lo=0.2, hi=4.0))
case("acosh", U(3, 4, lo=1.1, hi=4.0))
for _n in ["asin", "acos", "atanh", "erfinv"]:
    case(_n, U(3, 4, lo=-0.9, hi=0.9))
case("ndtri", U(3, 4, lo=0.05, hi=0.95))
case("logit", U(3, 4, lo=0.05, hi=0.95))
case("round", np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4]))
case("rint", np.array([0.5, 1.5, 2.5, -0.5, -1.5, 2.4]))
case("sign", np.array([np.nan, -0.0, 2.0, -3.0]))
case("abs", I(3, 4, lo=-5, hi=5))
case("neg", I(3, 4, lo=-5, hi=5))
case("sqrt", I(3, 4, lo=0, hi=9))
case("square", I(3, 4, lo=-5, hi=5))
case("floor", I(3, 4, lo=-5, hi=5))
case("reciprocal", I(3, 4, lo=1, hi=5))
case("leaky_relu", N(3, 4), alpha=0.2)
case("gelu", N(3, 4) * 2, approximate=False)
case("gelu", N(3, 4) * 2, approximate=True)
case("softmax", N(3, 4), axis=0)
case("log_softmax", N(3, 4), axis=-1)
case("softmax_temperature", N(3, 4), temperature=0.7)
case("celu", N(3, 4), alpha=0.5)
case("glu", N(3, 4), axis=-1)
case("hardshrink", N(3, 4), lambd=0.4)
case("softshrink", N(3, 4), lambd=0.4)
case("threshold_activation", N(3, 4), theta=0.1)
case("thresholded_relu", N(3, 4), theta=0.3)
case("crelu", N(3, 4), axis=0)
case("nan_to_num", np.array([np.nan, np.inf, -np.inf, 1.0]), nan=2.0)
case("nan_to_num", np.array([np.nan, np.inf, -np.inf, 1.0]), nan=0.0, posinf=9.0, neginf=-9.0)
case("replace_nans", np.array([np.nan, 3.0]), value=-1.0)
case("full_like", N(2, 3), value=1.5)
case("clip_by_value", N(3, 4), clip_value_min=-0.5, clip_value_max=0.7)
case("l2_normalize", N(3, 4), axis=0)
case("lerp", N(3, 4), N(3, 4, seed=1), w=0.3)
case("axpy", N(3, 4), N(3, 4, seed=1), alpha=2.5)
case("prelu", N(3, 4), U(4, lo=0.1, hi=0.3))
case("isclose", N(6), np.concatenate([N(3), N(3, seed=1)]))
case("allclose", N(6), N(6) + 1e-9)
case("compare_and_set", np.array([1.0, 2.0, 3.0]), 2.0, set_value=9.0)
case("compare_and_replace", N(6), N(6, seed=1), condition="gt", value=0.0)
case("adjust_gamma", U(3, 4), gamma=2.2, gain=1.5)
case("is_numeric_tensor", N(2))
case("is_numeric_tensor", B(2))
case("is_non_decreasing", np.sort(N(5)))
case("is_non_decreasing", N(5))
case("is_strictly_increasing", np.array([1.0, 2.0, 2.0]))
case("assert_equals", N(3), N(3))
case("assign", N(3, 4), N(4, seed=1))
case("assign", N(3, 4), I(3, 1))
for _n in ["euclidean_distance", "manhattan_distance", "cosine_similarity", "jaccard_distance"]:
    case(_n, U(4, 8), U(4, 8, seed=1))
    case(_n, U(4, 8), U(4, 8, seed=1), axis=1, keepdims=True)
case("hamming_distance", I(3, 4, hi=3), I(3, 4, hi=3, seed=1))
case("hamming_distance", I(3, 4, hi=3), I(3, 4, hi=3, seed=1), axis=0)

for _n in ["add", "sub", "mul", "div", "mod", "floordiv", "squareddifference", "maximum",
           "minimum", "atan2", "hypot", "logaddexp", "fmod", "truncatediv", "truncatemod",
           "floormod", "remainder", "rsub", "rdiv", "realdiv", "div_no_nan", "mul_no_nan",
           "squared_subtract", "relative_error", "eq", "neq", "gt", "gte", "lt", "lte",
           "mergeadd", "add_n", "accumulate_n", "mergemax", "mergeavg", "mergemaxindex"]:
    case(_n, N(3, 4) * 3, N(3, 4, seed=1) * 2)
for _n in ["add", "mul", "maximum", "div"]:
    case(_n, N(3, 4), N(4, seed=1))
for _n in ["div", "mod", "floordiv", "remainder", "add", "truncatediv", "fmod"]:
    case(_n, I(3, 4, lo=-9, hi=9), I(3, 4, lo=1, hi=4, seed=1))
case("pow", U(3, 4, lo=0.5, hi=2), N(3, 4, seed=1))
case("pow", I(3, 4, lo=0, hi=4), I(3, 4, lo=0, hi=3, seed=1))
case("pow_pairwise", U(3, 4, lo=0.5, hi=2), N(3, 4, seed=1))
case("xlogy", np.array([0.0, 1.0, 2.0]), np.array([0.5, 2.0, 3.0]))
case("xdivy", np.array([0.0, 1.0, 2.0]), np.array([0.5, 2.0, 3.0]))
case("safe_divide", np.array([1.0, 2.0, 3.0]), np.array([0.0, 2.0, 4.0]))
case("div_no_nan", np.array([1.0, 2.0, 3.0]), np.array([0.0, 2.0, 4.0]))
case("mul_no_nan", np.array([np.inf, 2.0, 3.0]), np.array([0.0, 2.0, 4.0]))
case("relative_error", np.array([0.0, 1.0]), np.array([0.0, 3.0]))
case("igamma", U(3, 4, lo=0.5, hi=3), U(3, 4, lo=0.1, hi=4, seed=1))
case("igammac", U(3, 4, lo=0.5, hi=3), U(3, 4, lo=0.1, hi=4, seed=1))
case("betainc", U(3, 4, lo=0.5, hi=3), U(3, 4, lo=0.5, hi=3, seed=1), U(3, 4, seed=2))
case("zeta", U(3, 4, lo=1.5, hi=4), U(3, 4, lo=0.5, hi=2, seed=1))
case("polygamma", np.array([0, 1, 2, 1]), U(4, lo=0.5, hi=3))
case("polygamma", np.array(1), U(4, lo=0.5, hi=3))
for _n in ["logical_and", "logical_or", "logical_xor"]:
    case(_n, B(3, 4), B(3, 4, seed=1))
case("logical_not", B(3, 4))
for _n in ["bitwise_and", "bitwise_or", "bitwise_xor"]:
    case(_n, I(3, 4, lo=-50, hi=50), I(3, 4, lo=-50, hi=50, seed=1))
case("bitwise_not", I(3, 4, lo=-50, hi=50))
case("toggle_bits", I(3, 4, lo=-50, hi=50))
for _n in ["left_shift", "right_shift", "shift_bits", "rshift_bits"]:
    case(_n, I(3, 4, lo=-50, hi=50), I(3, 4, lo=0, hi=5, seed=1))
case("population_count", I(3, 4, lo=-500, hi=500))
case("population_count", I(5, lo=-100, hi=100, dtype=np.int8))
case("cyclic_shift_bits", I(5, lo=-500, hi=500), 3)
case("cyclic_shift_bits", np.asarray([-127, 5], np.int8), 1)
case("cyclic_shift_bits", np.asarray([1], np.int32), 33)
case("cyclic_rshift_bits", I(5, lo=-500, hi=500), 7)
case("cyclic_rshift_bits", np.asarray([1], np.int8), 1)
case("bits_hamming_distance", I(5, lo=-500, hi=500), I(5, lo=-500, hi=500, seed=1))
case("bitcast", N(3).astype(np.float32), dtype="int32")
case("where", B(3, 4), N(3, 4), N(3, 4, seed=1))
case("where", B(3, 4))
case("select", B(3, 4), N(3, 4), N(3, 4, seed=1))

# ---- reductions --------------------------------------------------------------------
for _n in ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "reduce_std",
           "reduce_var", "norm1", "norm2", "normmax", "logsumexp", "amax", "amin", "amean",
           "asum", "squared_norm", "reduce_median", "nansum", "nanmean", "nanmax", "nanmin",
           "nanvar", "nanstd", "nanprod"]:
    case(_n, N(3, 4, 5))
    case(_n, N(3, 4, 5), axis=1)
    case(_n, N(3, 4, 5), axis=[0, 2], keepdims=True)
for _n in ["reduce_sum", "reduce_mean", "reduce_max", "reduce_prod", "reduce_any", "reduce_all"]:
    case(_n, N(3, 4), axis=[])
for _n in ["reduce_sum", "reduce_prod", "reduce_max", "reduce_mean"]:
    case(_n, I(3, 4, lo=-3, hi=4), axis=1)
for _n in ["reduce_any", "reduce_all"]:
    case(_n, B(3, 4))
    case(_n, B(3, 4), axis=1, keepdims=True)
for _n in ["nansum", "nanmean", "nanmax", "nanmin", "nanvar", "nanstd", "nanprod"]:
    case(_n, np.where(B(3, 4, seed=2), np.nan, N(3, 4)), axis=1)
    case(_n, np.array([[np.nan, np.nan], [1.0, 2.0]]), axis=1)
for _n in ["argmax", "argmin", "iamax", "iamin"]:
    case(_n, N(3, 4, 5))
    case(_n, N(3, 4, 5), axis=1)
case("argmax", N(3, 4), axis=0, keepdims=True)
case("logsumexp", np.array([[-np.inf, -np.inf], [0.0, 1.0]]), axis=1)
case("percentile", N(3, 5), q=30.0)
case("percentile", N(3, 5), q=75.0, axis=1)
case("count_nonzero", I(3, 4, lo=0, hi=3))
case("count_nonzero", I(3, 4, lo=0, hi=3), axis=1)
case("count_zero", I(3, 4, lo=0, hi=3), axis=0)
for _n in ["entropy", "shannon_entropy", "log_entropy"]:
    case(_n, U(3, 4, lo=0.01))
    case(_n, U(3, 4, lo=0.01), axis=1)
case("moments", N(3, 4))
case("moments", N(3, 4), axis=[0], keepdims=True)
case("normalize_moments", np.array(4.0), N(3), U(3, lo=5.0, hi=6.0), shift=0.5)
case("standardize", N(3, 4))
case("standardize", N(3, 4), axis=[0, 1])
case("ptp", N(3, 4))
case("ptp", N(3, 4), axis=0)
case("zero_fraction", np.array([0.0, 1.0, 0.0, 2.0]))
case("sufficient_statistics", N(2, 3))
case("sufficient_statistics", N(2, 3), axis=[1], shift=np.array(0.5))
case("weighted_moments", N(3, 4), U(3, 4))
case("weighted_moments", N(3, 4), U(3, 4), axis=1, keepdims=True)
case("cumsum", N(3, 4), axis=1)
case("cumsum", N(3, 4), axis=0, exclusive=True, reverse=True)
case("cumsum", I(3, 4), axis=1)
case("cumprod", U(3, 4, lo=0.5, hi=1.5), axis=1, exclusive=True)
case("cumprod", U(3, 4, lo=0.5, hi=1.5), axis=0, reverse=True)
for _n in ["cummax", "cummin", "cumlogsumexp"]:
    case(_n, N(4, 3), axis=0)
    case(_n, N(4, 3), axis=1)
case("cov", N(3, 20))
case("cov", N(20, 3), rowvar=False, bias=True)
case("corrcoef", N(3, 20))
case("corrcoef", N(20, 3), rowvar=False)
case("quantile", N(20), 0.25)
case("quantile", N(4, 20), np.array([0.1, 0.9]), axis=1)
case("quantile", N(20), 0.3, method="nearest")
case("quantile", N(20), 0.3, method="midpoint")
case("diff", N(3, 6))
case("diff", N(3, 6), n=2, axis=0)
case("ediff1d", N(3, 4))
case("trapz", N(3, 6))
case("trapz", N(3, 6), dx=0.5, axis=0)
case("trapz", N(6), x=np.sort(N(6, seed=1)))

# ---- shape ops ----------------------------------------------------------------------
case("reshape", N(2, 6), shape=[3, -1])
case("transpose", N(2, 3, 4))
case("transpose", N(2, 3, 4), perm=[1, 2, 0])
case("expand_dims", N(2, 3), axis=-1)
case("expand_dims", N(2, 3), axis=1)
case("squeeze", N(2, 1, 3, 1))
case("squeeze", N(2, 1, 3, 1), axis=[1, 2])
case("squeeze", N(2, 1, 3), axis=-2)
case("shape_of", N(2, 3, 4))
case("size", N(2, 3, 4))
case("rank", N(2, 3, 4))
case("concat", N(2, 3), N(2, 3, seed=1), axis=1)
case("concat", N(2, 3), I(1, 3), axis=0)
case("stack", N(2, 3), N(2, 3, seed=1), axis=-1)
case("unstack", N(3, 2, 4), axis=1)
case("split", N(4, 6), num_splits=3, axis=1)
case("split_v", N(4, 6), size_splits=[1, 2, 3], axis=1)
case("tile", N(2, 3), reps=[2, 1])
case("tile", N(2, 3), reps=[2, 1, 3])
case("flip", N(2, 3), axis=1)
case("broadcast_to", N(3), shape=[2, 3])
case("flatten2d", N(2, 3, 4))
case("reshape_onnx", N(2, 3, 4), shape=[0, -1])
case("slice_onnx", N(5, 6), starts=[1, -1], ends=[4, -10], axes=[0, 1], steps=[2, -2])
case("slice_onnx", N(5, 6), starts=[0], ends=[2 ** 62], axes=[1], steps=[1])
case("slice", N(4, 5), begin=[1, 0], size=[2, -1])
case("strided_slice", N(4, 5), begin=[1, 0], end=[3, 4], strides=[1, 2])
case("strided_slice", N(4, 5), begin=[-1, 0], end=[0, 0], strides=[-1, 1], end_mask=3)
case("strided_slice", N(4, 5), begin=[1, 0], end=[2, 5], strides=[1, 1], shrink_axis_mask=1)
case("strided_slice", N(4, 5), begin=[0, 0], end=[0, 0], strides=[1, 1], begin_mask=2,
     end_mask=2, new_axis_mask=1)
case("gather", N(5, 3), I(4, lo=-5, hi=5))
case("gather", N(3, 5), I(2, 2, lo=0, hi=5), axis=1)
case("gather_nd", N(4, 5, 2), I(3, 2, lo=0, hi=4))
case("take", N(4, 5), I(3, lo=-5, hi=5))
case("take", N(4, 5), I(3, lo=0, hi=5), axis=1)
case("take_along_axis", N(3, 4), I(3, 2, lo=0, hi=4), axis=1)
case("embedding_lookup", N(6, 3), I(2, 4, lo=0, hi=6))
case("scatter_update", N(5, 3), np.array([0, 3], np.int32), N(2, 3, seed=1))
case("scatter_add", N(5, 3), np.array([0, 3, 0], np.int32), N(3, 3, seed=1))
for _n in ["scatter_sub", "scatter_mul", "scatter_div", "scatter_max", "scatter_min"]:
    case(_n, U(5, 3, lo=0.5), np.array([0, 3, 0], np.int32), U(3, 3, lo=0.5, seed=1))
case("one_hot", I(4, lo=0, hi=5), depth=5)
case("one_hot", I(2, 3, lo=-1, hi=6), depth=5, axis=0, on_value=2.0, off_value=-1.0)
case("fill", shape=[2, 3], value=1.5)
case("fill", shape=[2], value=2, dtype="int32")
case("range", start=1, limit=9, delta=2)
case("range", start=0, limit=5, delta=1, dtype="float32")
case("cast", N(3, 4) * 3, dtype="int32")
case("cast", I(3, 4), dtype="float32")
case("cast", N(3, 4), dtype="bool")
case("pad", N(3, 4), paddings=[[1, 2], [0, 1]])
case("pad", N(3, 4), paddings=[[1, 2], [2, 1]], mode="REFLECT")
case("pad", N(3, 4), paddings=[[1, 2], [2, 3]], mode="SYMMETRIC")
case("pad", N(3, 4), paddings=[[1, 0], [0, 1]], constant_value=-2.0)
case("mirror_pad", N(4, 5), paddings=[[1, 1], [2, 2]])
case("mirror_pad", N(4, 5), paddings=[[1, 2], [0, 2]], mode="SYMMETRIC")
case("reverse_sequence", N(3, 5, 2), np.array([2, 5, 0], np.int32), seq_axis=1)
case("repeat", N(2, 3), repeats=2, axis=1)
case("roll", N(3, 4), shift=2, axis=1)
case("roll", N(3, 4), shift=-1)
case("meshgrid", N(3), N(4, seed=1))
case("meshgrid", N(3), N(4, seed=1), indexing="ij")
case("linspace", start=0.0, stop=2.0, num=7)
case("triu", N(4, 4), k=1)
case("tril", N(4, 4), k=-1)
case("dynamic_partition_padded", N(4, 3), I(4, lo=0, hi=3), num_partitions=3)
case("space_to_depth", N(2, 4, 6, 3), block_size=2)
case("space_to_depth", N(2, 3, 4, 6), block_size=2, data_format="NCHW")
case("depth_to_space", N(2, 2, 3, 12), block_size=2)
case("depth_to_space", N(2, 12, 2, 3), block_size=2, data_format="NCHW")
case("batch_to_space", N(8, 2, 3, 2), block_shape=[2, 2], crops=[(0, 1), (1, 0)])
case("space_to_batch", N(2, 3, 4, 2), block_shape=[2, 2], paddings=[(1, 0), (0, 0)])
case("swapaxes", N(2, 3, 4), a=0, b=2)
case("moveaxis", N(2, 3, 4), src=0, dst=-1)
case("reverse", N(2, 3, 4), axis=[0, 2])
case("reverse", N(2, 3))
case("unravel_index", I(5, lo=0, hi=24), shape=[2, 3, 4])
case("ravel_multi_index", np.stack([I(5, hi=2), I(5, hi=3, seed=1), I(5, hi=4, seed=2)], -1),
     shape=[2, 3, 4])
case("invert_permutation", rng(0).permutation(6).astype(np.int32))
case("matrix_band_part", N(4, 5), num_lower=1, num_upper=2)
case("matrix_band_part", N(2, 4, 4), num_lower=-1, num_upper=0)
case("matrix_diag", N(2, 3))
case("matrix_set_diag", N(2, 3, 4), N(2, 3, seed=1))
case("matrix_diag_part_v2", N(2, 3, 4), k=1)
case("tensor_diag", N(2, 3))
case("tensor_diag_part", N(2, 3, 2, 3))
case("diag", N(4))
case("diag", N(4, 4))
case("diag_part", N(3, 4))
case("trace", N(3, 4))
case("eye", 3)
case("eye", 2, m=4, dtype="int32")
case("tri", 3)
case("tri", 3, m=5, k=1)
case("zeros", shape=[2, 3])
case("ones", shape=[2], dtype="int32")
case("logspace", 0.0, 2.0, num=3)
case("logspace", 1.0, 3.0, num=4, base=2.0)
case("geomspace", 1.0, 8.0, num=4)
case("sequence_mask", np.array([1, 3, 0], np.int32), maxlen=4)
case("sequence_mask", np.array([1, 3, 0], np.int32), maxlen=4, dtype="int32")

# ---- linalg ----------------------------------------------------------------------------
case("matmul", N(3, 4), N(4, 2))
case("matmul", N(2, 4, 3), N(2, 5, 4), transpose_a=True, transpose_b=True)
case("batch_matmul", N(2, 3, 4), N(2, 4, 5))
case("batch_matmul", N(2, 4, 3), N(2, 4, 5), adj_x=True)
case("einsum", N(2, 3), N(3, 4), equation="ij,jk->ik")
case("einsum", N(2, 3, 4), equation="...ij->...ji")
case("tensordot", N(2, 3, 4), N(3, 4, 5))
case("tensordot", N(2, 3), N(3, 4), axes=1)
case("dot", N(3), N(3, seed=1))
case("dot", N(2, 3), N(3, 4))
case("dot", N(2, 2, 3), N(4, 3, 5))
case("outer", N(3), N(2, 2))
case("cholesky", spd())
case("matrix_inverse", spd())
case("matrix_determinant", N(3, 3))
case("solve", spd(), N(4, 2))
case("solve", spd(), N(4))
case("lstsq", N(6, 3), N(6, 2))
case("slogdet", N(4, 4))
case("pinv", N(4, 3))
case("matrix_rank", N(4, 3))
case("matrix_rank", N(4, 3) @ N(3, 5)[:, :3].T @ N(3, 3), tol=1e-6)
case("kron", N(2, 3), N(2, 2))
case("cross", N(4, 3), N(4, 3, seed=1))
case("triangular_solve", np.tril(spd()), N(4, 2))
case("triangular_solve", np.triu(spd()), N(4), lower=False)
case("eigvalsh", spd())
case("matrix_power", N(3, 3), 3)
case("cholesky_solve", np.linalg.cholesky(spd()), N(4, 2))
case("cholesky_solve", np.linalg.cholesky(spd()), N(4))
case("tensormmul", N(2, 3, 4), N(4, 3), axes_a=[1, 2], axes_b=[1, 0])
case("mmul_transpose", N(4, 3), N(4, 2), transpose_a=True)
case("mmul_transpose", N(3, 4), N(2, 4), transpose_b=True)
case("log_matrix_determinant", spd())
# up to sign or order: compared by reconstruction in test_decomposition
DECOMPOSITIONS = {"svd", "qr", "self_adjoint_eig", "lu"}

# ---- nn ---------------------------------------------------------------------------------
case("bias_add", N(2, 3, 4), N(4))
case("bias_add", N(2, 3, 4, 5), N(3), data_format="NCHW")
case("layer_norm", N(3, 6), N(6), N(6, seed=1), eps=1e-3)
case("layer_norm", N(3, 6), axis=0)
case("batch_norm", N(2, 3, 4), N(3), U(3, lo=0.5), N(3, seed=1), N(3, seed=2))
case("batch_norm", N(2, 4, 3), N(3), U(3, lo=0.5), axis=2, eps=1e-5)
case("dropout", N(3, 4), rate=0.5)
case("alpha_dropout", N(3, 4), rate=0.5)
case("conv2d", N(2, 3, 7, 7), N(3, 3, 3, 4), strides=(2, 2), padding="SAME")
case("conv2d", N(2, 7, 6, 3), N(3, 2, 3, 4), N(4), padding="VALID", data_format="NHWC",
     dilations=(2, 1))
case("conv2d", N(2, 4, 6, 6), N(3, 3, 2, 6), padding=[(1, 2), (0, 1)], groups=2)
case("conv1d", N(2, 9, 3), N(3, 3, 4), stride=2)
case("conv1d", N(2, 9, 3), N(3, 3, 4), N(4), padding="VALID")
case("conv3d", N(1, 5, 6, 5, 2), N(2, 3, 2, 2, 3), strides=(1, 2, 1))
case("conv3d", N(1, 5, 6, 5, 2), N(2, 3, 2, 2, 3), N(3), padding="VALID", dilations=(2, 1, 1))
case("deconv2d", N(1, 5, 5, 4), N(3, 3, 6, 4), strides=(2, 2), padding="VALID")
case("deconv2d", N(1, 5, 5, 4), N(3, 3, 6, 4), N(6), strides=(2, 2), padding="SAME")
case("deconv2d", N(1, 4, 5, 5), N(3, 3, 6, 4), N(6), strides=(1, 2), data_format="NCHW")
case("deconv3d", N(1, 3, 4, 3, 2), N(2, 3, 2, 3, 2), strides=(2, 1, 2))
case("max_pool2d", N(2, 3, 7, 7), kernel=(3, 3), strides=(2, 2), padding="SAME")
case("max_pool2d", N(2, 7, 6, 3), kernel=(2, 3), strides=(2, 1), data_format="NHWC")
case("max_pool2d", N(2, 3, 6, 6), kernel=(3, 3), strides=(2, 2), padding=[(1, 1), (0, 2)])
case("max_pool2d", I(1, 2, 4, 4, lo=-5, hi=5), kernel=(2, 2), strides=(2, 2))
case("avg_pool2d", N(2, 3, 7, 7), kernel=(3, 3), strides=(2, 2), padding="SAME")
case("avg_pool2d", N(2, 3, 7, 7), kernel=(3, 3), strides=(2, 2), padding="SAME",
     count_include_pad=True)
case("avg_pool2d", N(2, 6, 6, 3), kernel=(2, 2), strides=(1, 1), data_format="NHWC")
case("max_pool1d", N(2, 9, 3), kernel=3, strides=2, padding="SAME")
case("avg_pool1d", N(2, 9, 3), kernel=3, strides=2, padding="SAME")
case("max_pool3d", N(1, 4, 5, 4, 2))
case("avg_pool3d", N(1, 4, 5, 4, 2), padding="SAME")
case("upsampling1d", N(2, 3, 4), scale=3)
case("upsampling2d", N(2, 3, 4, 5), scale=2)
case("upsampling2d", N(2, 4, 5, 3), scale=2, data_format="NHWC")
case("upsampling3d", N(1, 2, 3, 2, 2), scale=2)
case("upsampling3d", N(1, 2, 2, 3, 2), scale=2, data_format="NCDHW")
case("local_response_normalization", N(1, 3, 3, 8), depth=5, bias=1.0, alpha=1e-2, beta=0.75)
case("multi_head_dot_product_attention", N(2, 5, 8), N(2, 6, 8, seed=1), N(2, 6, 8, seed=2),
     n_heads=2)
case("multi_head_dot_product_attention", N(2, 5, 8), N(2, 5, 8, seed=1), N(2, 5, 8, seed=2),
     N(8, 8, seed=3), N(8, 8, seed=4), N(8, 8, seed=5), N(8, 6, seed=6), n_heads=4,
     mask=np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.float64))
case("dot_product_attention", N(2, 5, 4), N(2, 6, 4, seed=1), N(2, 6, 3, seed=2))
case("dot_product_attention", N(2, 5, 4), N(2, 6, 4, seed=1), N(2, 6, 3, seed=2),
     mask=B(2, 5, 6), scale=0.3)
case("lstm_cell", N(2, 4), N(2, 3), N(2, 3, seed=1), N(4, 12), N(3, 12, seed=1), N(12))
case("gru_cell", N(2, 4), N(2, 3), N(4, 9), N(3, 9, seed=1), N(9))
case("rnn_cell", N(2, 4), N(2, 3), N(4, 3), N(3, 3, seed=1), N(3))
case("sru_cell", N(2, 3), U(2, 3), U(2, 3, seed=1), N(2, 3, seed=2), N(2, 3, seed=3))
case("lstm_layer", N(5, 2, 4), N(2, 3), N(2, 3, seed=1), N(4, 12) * 0.3, N(3, 12, seed=1) * 0.3)
case("gru", N(5, 2, 4), N(2, 3), N(4, 9) * 0.3, N(3, 9, seed=1) * 0.3, N(9))
case("rnn", N(5, 2, 4), N(2, 3), N(4, 3) * 0.3, N(3, 3, seed=1) * 0.3)
case("sru", N(5, 2, 4), N(2, 4), N(4, 12) * 0.3, N(8))
case("bidirectional_lstm", N(4, 2, 3), N(2, 2), N(2, 2, seed=1), N(2, 2, seed=2),
     N(2, 2, seed=3), N(3, 8), N(2, 8, seed=1), N(3, 8, seed=2), N(2, 8, seed=3), N(8), N(8, seed=1))
case("depthwise_conv2d", N(2, 8, 8, 3), N(3, 3, 3, 2))
case("depthwise_conv2d", N(2, 3, 8, 8), N(3, 3, 3, 1), N(3), strides=(2, 2), padding="VALID",
     data_format="NCHW", dilations=(1, 1))
case("depthwise_conv2d", N(1, 8, 8, 2), N(3, 3, 2, 1), dilations=(2, 2))
case("separable_conv2d", N(2, 8, 8, 3), N(3, 3, 3, 2), N(1, 1, 6, 4), N(4))
case("pointwise_conv2d", N(2, 5, 5, 3), N(1, 1, 3, 4), N(4))
case("conv2d_backprop_input", N(1, 3, 3, 4), N(3, 3, 2, 4), input_shape=[1, 5, 5, 2],
     strides=(2, 2), padding="SAME")
case("conv2d_backprop_input", N(1, 4, 3, 3), N(3, 3, 2, 4, seed=1), input_shape=[1, 2, 5, 5],
     padding="VALID", data_format="NCHW")
case("dilation2d", N(1, 5, 5, 2), N(3, 3, 2), padding="VALID")
case("dilation2d", N(1, 6, 6, 2), N(2, 3, 2), strides=(2, 1), rates=(1, 2))
case("im2col", N(1, 2, 6, 6), kernel=(3, 3), strides=(2, 2), padding="VALID")
case("im2col", N(1, 2, 5, 5), kernel=(2, 3))
case("col2im", N(1, 18, 4), output_size=(6, 6), kernel=(3, 3), strides=(2, 2), padding="VALID")
case("max_pool_with_argmax", N(2, 5, 5, 3))
case("max_pool_with_argmax", N(1, 5, 5, 2), kernel=(3, 3), strides=(2, 2), padding="SAME")
case("max_unpooling2d", N(1, 2, 2, 1), np.array([[[[5], [7]], [[13], [15]]]], np.int32),
     input_shape=(1, 4, 4, 1))
case("instance_norm", N(2, 3, 4, 4), N(3), N(3, seed=1))
case("group_norm", N(2, 4, 3, 3), N(4), N(4, seed=1), groups=2)
case("fused_batch_norm", N(2, 4, 4, 3), U(3), N(3))
case("fused_batch_norm", N(2, 4, 4, 3), U(3), N(3), N(3, seed=1), U(3, lo=0.5), training=False)
case("extract_image_patches", N(1, 6, 6, 2), ksizes=(3, 3), strides=(2, 2))
case("extract_image_patches", N(1, 5, 5, 2), ksizes=(2, 2), rates=(2, 1), padding="SAME")
case("crop_and_resize", U(2, 10, 10, 3), np.array([[0.1, 0.1, 0.8, 0.9], [-0.2, 0.0, 1.2, 1.0]]),
     np.array([0, 1], np.int32), crop_size=(5, 4))
case("crop_and_resize", U(1, 8, 8, 2), np.array([[0.2, 0.2, 0.8, 0.8]]),
     np.array([0], np.int32), crop_size=(1, 1), extrapolation_value=-1.0)
case("non_max_suppression_padded",
     np.array([[0, 0, 1, 1], [0, 0, 1.05, 1.05], [2, 2, 3, 3], [0, 0, 0.5, 0.5]]),
     np.array([0.9, 0.8, 0.7, 0.6]), max_output_size=3, iou_threshold=0.5)
case("non_max_suppression_padded", U(6, 4) * [1, 1, 2, 2] + [0, 0, 1, 1], U(6),
     max_output_size=8)

# ---- losses --------------------------------------------------------------------------
_lab = np.eye(4)[I(5, lo=0, hi=4)]
case("softmax_cross_entropy", _lab, N(5, 4))
case("sparse_softmax_cross_entropy", I(5, lo=0, hi=4), N(5, 4))
case("sigmoid_cross_entropy", U(5, 4), N(5, 4))
case("mean_squared_error", N(5, 4), N(5, 4, seed=1))
case("huber_loss", N(5, 4), N(5, 4, seed=1) * 2, delta=0.7)
case("log_loss", U(5, 4), U(5, 4, seed=1))
case("cosine_distance", N(5, 4), N(5, 4, seed=1))
case("cosine_distance", N(5, 4), N(5, 4, seed=1), axis=0)
case("hinge_loss", B(5, 4).astype(float), N(5, 4))
case("squared_hinge_loss", B(5, 4).astype(float), N(5, 4))
case("poisson_loss", U(5, 4) * 3, U(5, 4, seed=1) * 3)
case("kl_divergence", U(5, 4), U(5, 4, seed=1))
case("mean_pairwise_squared_error", N(3, 4), N(3, 4, seed=1))
case("weighted_cross_entropy_with_logits", B(5, 4).astype(float), N(5, 4), pos_weight=2.5)
case("absolute_difference_loss", N(5, 4), N(5, 4, seed=1))
for _red in ("none", "sum", "mean_by_weight"):
    case("absolute_difference_loss", N(5, 4), N(5, 4, seed=1), weights=U(5, 1), reduction=_red)
case("cosine_distance_loss", N(5, 4), N(5, 4, seed=1))
case("cosine_distance_loss", N(5, 4), N(5, 4, seed=1), weights=U(5, 1), reduction="sum")
case("log_poisson_loss", U(5, 4) * 3, N(5, 4))
case("log_poisson_loss", U(5, 4) * 3, N(5, 4), full=True)
case("ctc_loss", N(2, 10, 5), I(2, 4, lo=1, hi=5), np.array([10, 8], np.int32),
     np.array([4, 3], np.int32))
case("xw_plus_b", N(3, 4), N(4, 2), N(2))
case("relu_layer", N(3, 4), N(4, 2), N(2))
case("confusion_matrix", np.array([0, 1, 2, 1]), np.array([0, 2, 2, 1]), num_classes=3)
case("confusion_matrix", np.array([0, 1, 2, 1]), np.array([0, 2, 2, 1]), num_classes=4,
     weights=U(4))
_seq = [0, 1, 1, 0, 2, 2, 3, 0]
_lg = np.full((2, 8, 4), -5.0)
for _t, _s in enumerate(_seq):
    _lg[0, _t, _s] = 5.0
    _lg[1, _t, (_s + 1) % 4] = 5.0
case("ctc_greedy_decoder", _lg)
case("ctc_greedy_decoder", _lg, sequence_length=np.array([8, 5]), blank_index=1)

# ---- image -----------------------------------------------------------------------------
case("resize_nearest", N(1, 4, 6, 2), size=(8, 9))
case("resize_nearest", N(1, 2, 8, 6), size=(3, 4), data_format="NCHW")
case("resize_bilinear", N(1, 4, 6, 2), size=(7, 9))
case("resize_bilinear", N(1, 2, 8, 9), size=(3, 4), data_format="NCHW")
case("resize_bicubic", U(1, 4, 6, 2), size=(7, 9))
case("resize_bicubic", U(1, 9, 8, 2), size=(4, 3))
case("image_resize", U(1, 4, 6, 2), size=(7, 5))
for _m in ("nearest", "bicubic", "lanczos3", "lanczos5"):
    case("image_resize", U(1, 6, 9, 2), size=(4, 11), method=_m)
case("adjust_contrast", U(2, 4, 4, 3), factor=1.7)
case("rgb_to_hsv", U(5, 5, 3))
case("rgb_to_hsv", np.array([[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 0.2, 0.2]]))
case("hsv_to_rgb", U(5, 5, 3))
case("rgb_to_grs", U(4, 3))
case("rgb_to_yuv", U(4, 3))
case("rgb_to_yiq", U(4, 3))
case("yiq_to_rgb", U(4, 3))
case("yuv_to_rgb", U(4, 3))
case("adjust_saturation", U(4, 4, 3), factor=0.6)
case("adjust_hue", U(4, 4, 3), delta=0.3)
case("flip_left_right", N(2, 3, 4, 2))
case("flip_up_down", N(2, 3, 4, 2))
case("rot90", N(2, 3, 4, 2), k=1)
case("rot90", N(3, 4, 2), k=3)
case("central_crop", N(1, 6, 8, 3), fraction=0.5)
case("crop_to_bounding_box", N(1, 6, 8, 3), 1, 2, 4, 5)
case("pad_to_bounding_box", N(1, 6, 8, 3), 1, 1, 8, 10)
case("sobel_edges", N(1, 6, 7, 1))  # the JAX op's depthwise kernel holds one channel
case("image_gradients", N(2, 4, 5, 3))
case("total_variation", N(2, 4, 5, 3))
case("psnr", U(2, 8, 8, 1), U(2, 8, 8, 1, seed=1))
# the JAX op's Gaussian window is float32 and holds one channel
case("ssim", U(2, 16, 16, 1).astype(np.float32), U(2, 16, 16, 1, seed=1).astype(np.float32))
case("ssim", U(1, 12, 12, 1).astype(np.float32), U(1, 12, 12, 1, seed=1).astype(np.float32),
     filter_size=5, filter_sigma=1.0)

# ---- FFT / windows -----------------------------------------------------------------------
for _n in ("fft", "ifft", "rfft"):
    case(_n, N(3, 8))
    case(_n, N(3, 8), n=6, axis=0)
case("irfft", N(3, 5) + 1j * N(3, 5, seed=1))
case("irfft", N(3, 5) + 1j * N(3, 5, seed=1), n=10)
case("fft2", N(3, 4, 6))
case("ifft2", N(3, 4, 6) + 1j * N(3, 4, 6, seed=1))
case("fftshift", N(5, 6))
case("fftshift", N(5, 6), axis=1)
case("ifftshift", N(5, 6))
case("ifftshift", N(5, 6), axis=[0])
for _n in ("real", "imag", "conj", "angle", "abs"):
    case(_n, N(3, 4) + 1j * N(3, 4, seed=1))
case("real", N(3))
case("angle", N(3))
case("complex", N(3, 4), N(3, 4, seed=1))
for _n in ("hann_window", "hamming_window", "blackman_window", "bartlett_window"):
    case(_n, 16)
    case(_n, 9, periodic=False)
    case(_n, 1)
case("stft", N(300), frame_length=64, frame_step=32)
case("stft", N(2, 300), frame_length=50, frame_step=25, fft_length=64, window="none")

# ---- indexing / sorting / segments -------------------------------------------------------
case("sort", N(3, 5))
case("sort", N(3, 5), axis=0, descending=True)
case("argsort", N(3, 5))
case("argsort", N(3, 5), axis=0, descending=True)
case("top_k", N(4, 10), k=3)
case("in_top_k", N(4, 10), I(4, lo=0, hi=10), k=3)
case("unique_with_counts_padded", np.array([3, 1, 3, 2, 3]), size=6)
case("unique_with_counts_padded", np.array([[3, 1], [1, 2]]), size=2)
case("first_index", np.array([[3.0, 7.0, 7.0, 1.0], [1.0, 2.0, 3.0, 4.0]]), 7.0)
case("last_index", np.array([[3.0, 7.0, 7.0, 1.0], [1.0, 2.0, 3.0, 4.0]]), 7.0)
case("ismax", N(3, 4))
case("ismax", N(3, 4), axis=1)
case("nth_element", N(3, 5), 1)
case("nth_element", N(3, 5), 0, reverse=True)
case("choose", N(3, 4), condition="gt", value=0.2)
case("choose", N(8), condition="lte", value=0.0)
case("setdiff1d_padded", np.array([1, 2, 3, 4, 5]), np.array([2, 4, 9]))
case("digitize", N(6), np.array([-1.0, 0.0, 1.0]))
case("searchsorted", np.array([1.0, 2.0, 3.0]), np.array([2.0, 0.5, 3.5]))
case("searchsorted", np.array([1.0, 2.0, 3.0]), np.array([2.0, 0.5, 3.5]), side="right")
case("interp", N(8) * 2, np.array([-1.0, 0.0, 2.0]), np.array([3.0, -1.0, 5.0]))
for _n in ("segment_sum", "segment_prod", "segment_max", "segment_min", "segment_mean",
           "unsorted_segment_sum", "unsorted_segment_prod", "unsorted_segment_max",
           "unsorted_segment_min", "unsorted_segment_mean"):
    case(_n, N(6, 2), np.array([0, 0, 1, 3, 3, 3], np.int32), num_segments=5)
case("segment_sum", I(6, lo=-3, hi=3), np.array([0, 0, 1, 3, 3, 3], np.int32), num_segments=4)
case("segment_max", I(6, lo=-3, hi=3), np.array([0, 0, 1, 3, 3, 3], np.int32), num_segments=4)
case("histogram_fixed_width", N(50), value_range=[-1.0, 1.0], nbins=5)
case("bincount", I(20, lo=-1, hi=8), minlength=6)
case("bincount", np.array([[0, 1, 1], [2, 2, 2]], np.int32), minlength=4)
case("bincount", np.array([[0, 1, 1], [2, 2, 5]], np.int32), minlength=4, binary_output=True)
case("bincount", I(20, lo=0, hi=8), maxlength=5, weights=N(20))
case("bincount_weighted", np.array([[0, 1, 1], [2, 2, 2]], np.int32), U(2, 3), minlength=4)
case("bincount_weighted", I(10, lo=0, hi=5), U(10), minlength=5)
case("dynamic_stitch", [np.array([0, 2]), np.array([1, 3])], np.array([[10.0], [30.0]]),
     np.array([[20.0], [40.0]]))
case("dynamic_stitch", [np.array([0, 1]), np.array([0])], np.array([[1.0], [2.0]]),
     np.array([[9.0]]), size=2)
case("dynamic_stitch", [np.array([0, 2]), np.array([3])], np.array([[1.0], [3.0]]),
     np.array([[7.0]]))

# ---- clipping / scatter-nd / updaters / quantization --------------------------------------
case("clip_by_norm", N(3, 4), clip_norm=1.0)
case("clip_by_norm", N(3, 4), clip_norm=1.0, axis=1)
case("clip_by_avg_norm", N(3, 4), clip_norm=0.5)
case("clip_by_global_norm", N(3), N(2, 2), clip_norm=1.0)
case("clip_by_global_norm", N(3) * 0.01, clip_norm=1.0)
case("scatter_nd", np.array([[0], [2]]), N(2, 3), shape=(4, 3))
case("scatter_nd", np.array([[0, 1], [2, 0], [0, 1]]), N(3), shape=(3, 2))
case("scatter_nd_add", N(4, 2), np.array([[0], [2]]), N(2, 2))
case("scatter_nd_sub", N(4, 2), np.array([[0, 1], [3, 0]]), N(2))
case("scatter_nd_update", N(4, 2), np.array([[0], [2]]), N(2, 2))
case("tensor_scatter_max", N(4, 2), np.array([[0], [2], [0]]), N(3, 2, seed=1))
case("tensor_scatter_min", N(3, 3), np.array([[0, 1], [2, 2]]), N(2, seed=1))
case("sgd_updater", N(3), lr=0.1)
case("momentum_updater", N(3), N(3, seed=1), lr=0.1, momentum=0.8)
case("nesterovs_updater", N(3), N(3, seed=1))
case("adagrad_updater", N(3), U(3))
case("rmsprop_updater", N(3), U(3))
case("adadelta_updater", N(3), U(3), U(3, seed=1))
case("adam_updater", N(3), N(3, seed=1), U(3), 4)
case("adamax_updater", N(3), N(3, seed=1), U(3), 2)
case("amsgrad_updater", N(3), N(3, seed=1), U(3), U(3, seed=2), 3)
case("nadam_updater", N(3), N(3, seed=1), U(3), 0)
case("fake_quant_with_min_max_args", N(8) * 2, min=-1.0, max=1.0)
case("fake_quant_with_min_max_args", N(8) * 2, min=-3.0, max=2.0, num_bits=4)
case("fake_quant_with_min_max_vars", N(8) * 2, np.array(-1.0), np.array(1.5))
case("quantize", U(8) * 3, scale=0.1)
case("quantize", N(8), scale=0.05, zero_point=3, signed=True)
case("dequantize", I(8, lo=0, hi=255), scale=0.1, zero_point=5)

# ---- how outputs are compared --------------------------------------------------------------
TOL = {  # rtol (and atol) where the two libraries' algorithms differ; 1e-10 otherwise
    "betainc": 1e-8,      # continued fractions, summed differently
    "igamma": 1e-8, "igammac": 1e-8,  # series/continued fraction vs XLA's
    "zeta": 1e-8, "polygamma": 1e-8, "lgamma": 1e-10, "digamma": 1e-10,
    "erfinv": 1e-9, "ndtri": 1e-9,
    "bessel_i0": 1e-9, "bessel_i1": 1e-9, "bessel_i0e": 1e-9, "bessel_i1e": 1e-9,
    "pinv": 1e-8, "lstsq": 1e-8, "matrix_rank": 0.0,
    "ctc_loss": 1e-8,
    "image_resize": 1e-9,
    "stft": 1e-6,         # the Hann window is float32 in both, its cosines rounded differently
    "ssim": 1e-5,         # float32 inputs and window
}
#: output dtype set by a Python float: JAX with x64 gives float64, torch float32
DTYPE_FREE = {"fill", "linspace", "eye", "logspace", "geomspace", "tri", "histogram_fixed_width",
              "hann_window", "hamming_window", "blackman_window", "bartlett_window",
              "one_hot", "range", "confusion_matrix", "zero_fraction", "dequantize"}
#: ops that raise in both packages on these inputs (the same exception type)
RAISE_BOTH = {"unique_padded"}


def _j(a):
    if isinstance(a, list):
        return [_j(v) for v in a]
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _t(a):
    if isinstance(a, list):
        return [_t(v) for v in a]
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a


def _kw(kw, conv):
    return {k: conv(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _outs(x):
    if isinstance(x, (tuple, list)):
        return [v for o in x for v in _outs(o)]
    if isinstance(x, torch.Tensor):
        return [x.detach().cpu().numpy()]
    return [np.asarray(x)]


def _ids():
    out = []
    for name, cases in sorted(CASES.items()):
        out += [(name, i) for i in range(len(cases))]
    return out


@pytest.mark.parametrize("name,i", _ids(), ids=[f"{n}[{i}]" for n, i in _ids()])
def test_op_matches_jax(name, i):
    args, kw = CASES[name][i]
    jout = _outs(J_OPS[name](*_j(list(args)), **_kw(kw, jnp.asarray)))
    pout = _outs(P_OPS[name](*_t(list(args)), **_kw(kw, lambda a: torch.from_numpy(np.array(a)))))
    assert len(pout) == len(jout)
    tol = TOL.get(name, 1e-10)
    for k, (p, j) in enumerate(zip(pout, jout)):
        assert p.shape == j.shape, (k, p.shape, j.shape)
        if name not in DTYPE_FREE:
            assert p.dtype == j.dtype, (k, p.dtype, j.dtype)
        if j.dtype == object or j.dtype.kind in "biu":
            np.testing.assert_array_equal(p, j)
        else:
            if p.dtype != j.dtype:  # DTYPE_FREE: float32 against float64, held to float32
                tol = max(tol, 1e-6)
            np.testing.assert_allclose(p, j.astype(p.dtype), rtol=tol, atol=tol, equal_nan=True)


def test_every_deterministic_op_has_a_case():
    covered = set(CASES) | DECOMPOSITIONS | RANDOM_OPS | RAISE_BOTH
    assert sorted(set(J_OPS) - covered) == []


def test_unique_padded_raises_in_both():
    x = np.array([3, 1, 3])
    with pytest.raises(TypeError):
        J_OPS["unique_padded"](jnp.asarray(x))
    with pytest.raises(TypeError):
        P_OPS["unique_padded"](torch.from_numpy(x))


# ---- decompositions: by reconstruction -----------------------------------------------------
def test_decomposition_svd_qr_eigh_lu():
    a = N(5, 3)
    for full in (False, True):
        u, s, vh = (o.numpy() for o in P_OPS["svd"](torch.from_numpy(a), full_matrices=full))
        ju, js, jvh = (np.asarray(o) for o in J_OPS["svd"](jnp.asarray(a), full_matrices=full))
        assert (u.shape, s.shape, vh.shape) == (ju.shape, js.shape, jvh.shape)
        np.testing.assert_allclose(s, js, rtol=1e-10)
        k = len(s)
        np.testing.assert_allclose(u[:, :k] * s @ vh[:k], a, atol=1e-10)
        q, r = (o.numpy() for o in P_OPS["qr"](torch.from_numpy(a), full_matrices=full))
        jq, jr = (np.asarray(o) for o in J_OPS["qr"](jnp.asarray(a), full_matrices=full))
        assert (q.shape, r.shape) == (jq.shape, jr.shape)
        np.testing.assert_allclose(q @ r, a, atol=1e-10)
        np.testing.assert_allclose(np.abs(r), np.abs(jr), atol=1e-10)
    s = spd()
    w, v = (o.numpy() for o in P_OPS["self_adjoint_eig"](torch.from_numpy(s)))
    jw, _ = J_OPS["self_adjoint_eig"](jnp.asarray(s))
    np.testing.assert_allclose(w, np.asarray(jw), rtol=1e-10)
    np.testing.assert_allclose(v @ np.diag(w) @ v.T, s, atol=1e-10)
    b = N(4, 4)
    p, l, u = (o.numpy() for o in P_OPS["lu"](torch.from_numpy(b)))
    jp, jl, ju = (np.asarray(o) for o in J_OPS["lu"](jnp.asarray(b)))
    np.testing.assert_allclose(p @ l @ u, b, atol=1e-10)
    np.testing.assert_allclose(p, jp)  # partial pivoting picks the same rows
    np.testing.assert_allclose(l, jl, atol=1e-10)
    np.testing.assert_allclose(u, ju, atol=1e-10)


# ---- keyed random ops: by their law ------------------------------------------------------------
def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _draw(name, **kw):
    return P_OPS[name](rng=_gen(), **kw).double().numpy()


def test_random_normal_and_truncated_normal():
    x = _draw("random_normal", shape=(20000,), mean=1.5, stddev=2.0)
    assert abs(x.mean() - 1.5) < 0.05 and abs(x.std() - 2.0) < 0.05
    t = _draw("random_truncated_normal", shape=(20000,), mean=0.5, stddev=2.0)
    assert t.min() >= 0.5 - 4.0 and t.max() <= 0.5 + 4.0
    # a standard normal truncated to [-2, 2] has variance 0.7737
    assert abs(t.mean() - 0.5) < 0.05 and abs(t.var() / 4.0 - 0.7737) < 0.03


def test_random_uniform_bernoulli_binomial():
    u = _draw("random_uniform", shape=(20000,), minval=-1.0, maxval=3.0)
    assert u.min() >= -1.0 and u.max() < 3.0 and abs(u.mean() - 1.0) < 0.05
    b = _draw("random_bernoulli", shape=(20000,), p=0.3)
    assert set(np.unique(b)) <= {0.0, 1.0} and abs(b.mean() - 0.3) < 0.02
    n = _draw("random_binomial", shape=(5000,), n=10, p=0.3)
    assert abs(n.mean() - 3.0) < 0.1 and abs(n.var() - 2.1) < 0.2


def test_random_gamma_poisson_exponential():
    g = _draw("random_gamma", shape=(20000,), alpha=3.0, beta=2.0)
    assert abs(g.mean() - 1.5) < 0.05 and abs(g.var() - 0.75) < 0.06
    p = _draw("random_poisson", shape=(20000,), lam=4.0)
    assert np.all(p == np.round(p)) and abs(p.mean() - 4.0) < 0.1 and abs(p.var() - 4.0) < 0.25
    e = _draw("random_exponential", shape=(20000,), rate=2.0)
    assert e.min() >= 0 and abs(e.mean() - 0.5) < 0.02


def test_random_laplace_cauchy():
    lap = _draw("random_laplace", shape=(20000,), mu=1.0, beta=0.5)
    assert abs(np.median(lap) - 1.0) < 0.03 and abs(lap.var() - 0.5) < 0.05
    c = _draw("random_cauchy", shape=(20000,), loc=-1.0, scale=2.0)
    q1, q3 = np.percentile(c, [25, 75])  # quartiles of Cauchy: loc -+ scale
    assert abs(np.median(c) + 1.0) < 0.1 and abs(q1 + 3.0) < 0.15 and abs(q3 - 1.0) < 0.15


def test_random_shuffle_crop_multinomial():
    x = torch.arange(50).reshape(25, 2)
    s = P_OPS["random_shuffle"](x, rng=_gen())
    assert sorted(s[:, 0].tolist()) == list(range(0, 50, 2)) and not torch.equal(s, x)
    assert torch.equal(s[:, 1], s[:, 0] + 1)  # rows move whole
    img = torch.arange(60.0).reshape(6, 10)
    c = P_OPS["random_crop"](img, size=(3, 4), rng=_gen())
    r0, c0 = int(c[0, 0]) // 10, int(c[0, 0]) % 10
    assert c.shape == (3, 4) and torch.equal(c, img[r0:r0 + 3, c0:c0 + 4])
    logits = torch.log(torch.tensor([[0.05, 0.9, 0.05]] * 4, dtype=torch.float64))
    m = P_OPS["random_multinomial"](logits, num_samples=2000, rng=_gen())
    assert m.shape == (4, 2000) and abs(float((m == 1).double().mean()) - 0.9) < 0.02


def test_dropout_keep_rate_and_scale():
    x = torch.ones(20000, dtype=torch.float64)
    assert torch.equal(P_OPS["dropout"](x, rate=0.3), x)  # deterministic by default
    d = P_OPS["dropout"](x, rate=0.3, rng=_gen(), deterministic=False)
    kept = d != 0
    assert abs(float(kept.double().mean()) - 0.7) < 0.02
    np.testing.assert_allclose(d[kept].numpy(), 1 / 0.7)
    a = P_OPS["alpha_dropout"](torch.randn(20000, generator=_gen(1), dtype=torch.float64),
                               rate=0.2, rng=_gen(), deterministic=False)
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1.0) < 0.05  # SELU-preserving


def test_keyed_random_ops_repeat_for_one_seed():
    for name, kw in [("random_normal", {"shape": (5,)}), ("random_uniform", {"shape": (5,)}),
                     ("random_poisson", {"shape": (5,)}), ("random_gamma", {"shape": (5,)})]:
        assert np.array_equal(_draw(name, **kw), _draw(name, **kw)), name
