// K6 backward's window kernel (attn_block_bwd.cuh) at wgmma widths 48 and 32.
#include "attn_block_bwd.cuh"

template cudaError_t k6_bwd::launch_window<48>(const CUtensorMap&, const k6_bwd::Window&,
                                                 const k6_bwd::Plan&, cudaStream_t);
template cudaError_t k6_bwd::launch_window<32>(const CUtensorMap&, const k6_bwd::Window&,
                                                 const k6_bwd::Plan&, cudaStream_t);
