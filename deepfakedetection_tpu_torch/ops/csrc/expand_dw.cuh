// K2's launcher, shared by its own entry point (expand_dw.cu) and by K3
// (fused_mbconv.cu), whose first stage is K2's kernel unchanged.
#pragma once

#include <cuda_runtime.h>

namespace dfd {

// Enqueues K2 on `stream`: wexp packed to bf16 pairs into `wpack`
// ([ceil(Ce/64)*64][ceil(Cin/16)*8] 32-bit words), then the persistent
// expand + depthwise kernel, which writes y and pool [B, Ce]. k is 3 or 5;
// CB (32 or 64) and RB are the launch plan (ops/expand_dw.py:plan). A null
// wexp skips the packing: wpack already holds the weights in that layout (K3
// packs them once per model). Defined in expand_dw.cu.
cudaError_t launch_expand_dw_silu_pool(const void* x, const void* wexp, const void* bexp,
                                       const void* wdw, const void* bdw, void* y, void* pool,
                                       void* wpack, int B, int H, int W, int Cin, int Ce, int k,
                                       int CB, int RB, cudaStream_t stream);

}  // namespace dfd
