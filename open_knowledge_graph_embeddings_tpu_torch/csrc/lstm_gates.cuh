// The CUDA-core building blocks of the port's LSTM kernels that do not run
// on a wgmma loop: the block constants, cp.async copies and the mma.sync
// bf16 product of the backward's dW launches (lstm_last_bwd.cu); the
// backward's cell arithmetic (bwd_cell), which every backward's gate launch
// runs; the accurate sigmoid, the f32 -> bf16 rounding, and the search for
// a step's active rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oket_lstm {

constexpr int BM = 128;  // rows per block
constexpr int BK = 32;   // K tile
constexpr int NT = 256;  // 8 warps

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
    uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ uint16_t f32_to_bf16(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
}

// One (row, unit) cell of an LSTM backward step, f32, in torch gate order:
// from the pre-activations pre = (i, f, g, o), c_t and c_{t-1} (bf16
// residuals, read as f32), the dh entering this step (carry plus cotangent)
// and the dc carry, writes the four dgates to d and returns the dc carry
// of step t-1 (dc * f).
__device__ __forceinline__ float bwd_cell(const float (&pre)[4], float c_t, float c_prev, float dh, float dc_in,
                                          float (&d)[4]) {
    const float gi = sigmoidf(pre[0]);
    const float gf = sigmoidf(pre[1]);
    const float gg = tanhf(pre[2]);
    const float go = sigmoidf(pre[3]);
    const float tc = tanhf(c_t);
    const float d_o = dh * tc;
    const float dc = dc_in + dh * go * (1.f - tc * tc);
    d[0] = dc * gg * gi * (1.f - gi);
    d[1] = dc * c_prev * gf * (1.f - gf);
    d[2] = dc * gi * (1.f - gg * gg);
    d[3] = d_o * go * (1.f - go);
    return dc * gf;
}

// Rows active at step t: lens is sorted descending, so they are the prefix
// of rows with max(len, 1) > t.
__device__ __forceinline__ int active_rows(const int* lens, long long B, int t) {
    long long lo = 0, hi = B;
    while (lo < hi) {
        const long long mid = (lo + hi) / 2;
        if (max(__ldg(lens + mid), 1) > t)
            lo = mid + 1;
        else
            hi = mid;
    }
    return (int)lo;
}

}  // namespace oket_lstm
