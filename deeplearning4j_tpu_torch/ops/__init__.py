from .flash_attention import (
    LAUNCH_COUNTS,
    attention_impl,
    decode_attention,
    decode_attention_reference,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq_plain,
    flash_attention_plain,
    flash_decode_attention,
    flash_decode_attention_plain,
    mha_attention,
    mha_attention_reference,
    reset_launch_counts as _reset_attention_counts,
    set_attention_impl,
)
from .grouped_matmul import LAUNCH_COUNTS as GROUPED_MATMUL_LAUNCH_COUNTS
from .grouped_matmul import (
    grouped_matmul,
    grouped_matmul_impl,
    grouped_matmul_plain,
    reset_launch_counts as _reset_grouped_matmul_counts,
    set_grouped_matmul_impl,
)
from .paged_attention import (
    pack_row_blocks,
    paged_cache_write,
    paged_decode_attention,
    paged_gather,
)
from .moe_dispatch import (
    DispatchPlan,
    combine_rows,
    gather_dispatch,
    make_dispatch_plan,
    scatter_combine,
    top_k_routing,
)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0: the attention kernels'
    (:data:`LAUNCH_COUNTS`) and B5's (:data:`GROUPED_MATMUL_LAUNCH_COUNTS`)."""
    _reset_attention_counts()
    _reset_grouped_matmul_counts()


__all__ = [
    "DispatchPlan",
    "GROUPED_MATMUL_LAUNCH_COUNTS",
    "LAUNCH_COUNTS",
    "attention_impl",
    "combine_rows",
    "decode_attention",
    "decode_attention_reference",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkv_plain",
    "flash_attention_bwd_dq_plain",
    "flash_attention_plain",
    "flash_decode_attention",
    "flash_decode_attention_plain",
    "gather_dispatch",
    "grouped_matmul",
    "grouped_matmul_impl",
    "grouped_matmul_plain",
    "make_dispatch_plan",
    "mha_attention",
    "mha_attention_reference",
    "pack_row_blocks",
    "paged_cache_write",
    "paged_decode_attention",
    "paged_gather",
    "reset_launch_counts",
    "scatter_combine",
    "set_attention_impl",
    "set_grouped_matmul_impl",
    "top_k_routing",
]
