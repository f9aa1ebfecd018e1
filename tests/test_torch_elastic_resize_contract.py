"""The port's elastic resize contract on the CPU
(``deeplearning4j_tpu_torch/tools/check_elastic_resize_contract.py``,
configuration ``"mlp"``): a ZeRO-1 run resized 2 -> 1 -> 2 ranks by two
SIGKILLs under ``elastic_fit(mesh_size_fn=)`` consumes the reference run's
batches exactly, restores its updater state onto both widths, lands within
the quality gate of the fixed-width run, and its last width-2 checkpoint
restores at width 1 bit for bit."""

from deeplearning4j_tpu_torch.tools import check_elastic_resize_contract


def test_elastic_resize_contract_two_one_two():
    out = check_elastic_resize_contract.run_legs(device="cpu", model="mlp", log=lambda m: None)
    assert out["resize"]["widths"] == [2, 1, 2]
    assert out["resize"]["committed"] == [4, 8]
