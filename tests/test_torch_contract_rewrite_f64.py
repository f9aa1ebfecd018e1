"""The port's graph-rewrite equivalence harness
(``deeplearning4j_tpu_torch/tools/check_rewrite_equivalence.py``) run on
the CPU on its graphs in float64: it passes there too, and each of its ten
matched rewrites (two graphs x five pass lists) gives outputs within 1e-10
of the JAX package's rewrite of the same fitted network (the port's model
zip read by the JAX package, rewritten by the JAX passes of the same names)
on the same input."""

import numpy as np
import pytest

from torch_contract_helpers import jax_copy, run_port


@pytest.fixture(scope="module")
def rewrite_f64():
    record = {}
    lines = run_port("check_rewrite_equivalence", model="tiny", dtype="float64", record=record)
    return lines, record


def test_port_rewrite_contract_passes_in_float64(rewrite_f64):
    assert rewrite_f64[0][-1] == "rewrite equivalence contract: all checks passed"
    assert len(rewrite_f64[1]["forward"]) == 10


@pytest.mark.parametrize("k", range(10))
def test_rewritten_outputs_match_jax_float64(rewrite_f64, tmp_path, k):
    from deeplearning4j_tpu.nn.rewrite import (BatchNormAffinePass, ConvBatchNormFoldPass,
                                               SpaceToDepthStemPass, rewrite_model)

    label, pname, net, x, out = rewrite_f64[1]["forward"][k]
    assert out.dtype == np.float64
    by_name = {p.name: p for p in (SpaceToDepthStemPass(), ConvBatchNormFoldPass(),
                                   BatchNormAffinePass())}
    jm = jax_copy(net, str(tmp_path))
    j2, applied = rewrite_model(jm, [by_name[n] for n in pname.split("+")],
                                context="inference")
    assert applied, (label, pname)
    want = np.asarray(j2.output(x))
    assert want.dtype == np.float64
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-10, err_msg=f"{label}/{pname}")
