// K2's launcher, shared by its own entry point (expand_dw.cu) and by K3
// (fused_mbconv.cu), whose first stage is K2's kernel unchanged.
#pragma once

#include <cuda_runtime.h>

namespace dfd {

// Enqueues K2 on `stream`: the expand + depthwise kernel (y, and per-tile
// pool partials into `partial` [B, tiles, Ce]), then pool_finalize (pool
// [B, Ce]). k is 3 or 5, CB 32 or 64; defined in expand_dw.cu.
cudaError_t launch_expand_dw_silu_pool(const void* x, const void* wexp, const void* bexp,
                                       const void* wdw, const void* bdw, void* y, void* partial,
                                       void* pool, int B, int H, int W, int Cin, int Ce, int k,
                                       int TH, int TW, int CB, cudaStream_t stream);

}  // namespace dfd
