"""Names of the port's own CUDA kernels as the profiler reports them."""

OWN = ("igemm::", "small_edge::", "small_cin_kernel", "halo_row_kernel", "flash_kernel")
FUSED_BLOCK = ("igemm::conv_sm90<true", "igemm::reduce_partials", "small_edge::")


def own(name: str) -> bool:
    return any(tag in name for tag in OWN)


def fused_block(name: str) -> bool:
    return any(tag in name for tag in FUSED_BLOCK)
