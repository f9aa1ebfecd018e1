"""The port's data-parallel weight-update contract on the CPU: four gloo
ranks run every gate of ``deeplearning4j_tpu_torch/tools/
check_dp_update_contract.py`` (ZeRO-1 equivalence on the implicit path and
under top-k, ~1/N updater bytes, top-k conservation, layout-independent
``OrbaxCheckpointer`` restores and the mismatch error, ZeRO-1 x {Lars,
Lamb} x {bucketed, top-k}, the metrics in the exposition)."""

from deeplearning4j_tpu_torch.tools import check_dp_update_contract


def test_dp_update_contract_on_four_ranks():
    assert check_dp_update_contract.main(device="cpu", world=4, timeout=300.0) == 0
