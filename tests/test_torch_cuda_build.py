"""The kernel build's cache key: each library's name carries a hash of its
source with the ``csrc/*.cuh`` headers it includes written out in place, so
that editing a shared header rebuilds every source that includes it. Runs
on the CPU: nothing is compiled."""

from deeplearning4j_tpu_torch.ops import cuda_build


def test_library_hash_covers_included_headers(tmp_path):
    src, header = tmp_path / "k.cu", tmp_path / "h.cuh"
    header.write_text("#pragma once\nconstexpr int kTile = 64;\n")
    src.write_text('#include <cuda_runtime.h>\n#include "h.cuh"\n#include "h.cuh"\nint f();\n')
    text = cuda_build.source_text(src)
    assert text.count("kTile = 64") == 1  # written out once, where it was first included
    assert "#include <cuda_runtime.h>" in text  # system headers stay as they are
    before = cuda_build._lib_path(src)
    header.write_text("#pragma once\nconstexpr int kTile = 32;\n")
    assert cuda_build._lib_path(src) != before
    assert cuda_build._lib_path(src).name.startswith("libk-")


def test_flash_kernels_share_the_tensor_core_helpers():
    for stem in ("flash_forward", "flash_backward"):
        text = cuda_build.source_text(cuda_build.CSRC / f"{stem}.cu")
        assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
        assert '#include "mma_tf32.cuh"' not in text
