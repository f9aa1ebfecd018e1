"""The port's eleven contract harnesses (``deeplearning4j_tpu_torch/tools/
check_*``) on the card, at the JAX harnesses' own sizes (``model="tiny"``):
each must pass every gate there, where its servables run on their own CUDA
streams, its decode steps replay CUDA graphs of B4 launches and its page-ins
copy weights to the device. A small LM served through ``/v1/serving`` and
``/v1/generate`` must launch B1 and B4. ``chip_smoke.py``'s phase "contract
harnesses" runs them at GPT-2 small's widths.

These tests need a CUDA device and skip without one. On the chip machine
(no JAX there for ``tests/conftest.py``)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_contract_cuda.py

There is no tolerance of its own here: each harness holds its gates (the
rewrite harness its ``TOL`` 2e-5 in float32)."""

import importlib

import pytest
import torch

pytestmark = pytest.mark.cuda

HARNESSES = ("check_serving_contract", "check_metrics_contract", "check_trace_contract",
             "check_pool_contract", "check_generate_contract", "check_registry_contract",
             "check_fabric_contract", "check_disagg_contract", "check_multiplex_contract",
             "check_input_pipeline_contract", "check_rewrite_equivalence")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


@pytest.mark.parametrize("name", HARNESSES)
def test_contract_harness_passes_on_the_card(cuda, name):
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.tools.{name}")
    lines = []
    assert mod.main(device=cuda, model="tiny", log=lines.append) == 0
    assert lines


def test_lm_behind_the_harnesses_launches_b1_and_b4(cuda):
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu_torch.model.zoo import TransformerLM
    from deeplearning4j_tpu_torch.tools import check_disagg_contract, check_serving_contract

    lm = TransformerLM(vocab_size=512, hidden=64, n_layers=2, n_heads=2, max_len=64).init()
    ops.reset_launch_counts()
    assert check_serving_contract.main(device=cuda, model=lm, log=lambda m: None) == 0
    assert ops.LAUNCH_COUNTS["flash_forward"] > 0
    ops.reset_launch_counts()
    assert check_disagg_contract.main(device=cuda, model=lm, log=lambda m: None) == 0
    assert ops.LAUNCH_COUNTS["flash_decode"] > 0
