// The gate product of one LSTM recurrence step, shared by the forward and
// the backward of the recurrence-only LSTM (lstm_scan.cu, kernels 7 and 8),
// so the backward's gate recompute is the same code, and on the card the
// same numbers, as its forward's (the fused kernels 1, 2, 5 and 6 share
// lstm_bf16.cuh's wgmma loop instead):
//   acc = x_t . W_ih^T + bf16(h_{t-1}) . W_hh^T   (bf16 operands, f32 accumulation)
// for BM rows x the four gate columns {j, H+j, 2H+j, 3H+j} of BN hidden units.
// K runs over the x part (D) and then the h part (H, skipped at t == 0 where
// h_0 = 0); with D == 0 only the h part runs (the recurrence-only LSTM, whose
// input projection comes precomputed).  Tiles of A (x or h rows) and of the
// gate-major weights are staged through shared memory with cp.async, double
// buffered, and multiplied with mma.sync m16n8k16.  Rows with s_len[r] <= t
// are zero-filled.  D and H are multiples of 8, so every tile row is whole
// 16-byte copies.  Also here: the backward's cell arithmetic (bwd_cell),
// bf16 conversions, the mma.sync and cp.async helpers and the search for a
// step's active rows, which the fused backward's dW launch uses too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oket_lstm {

constexpr int BM = 128;      // rows per block
constexpr int BN = 32;       // hidden units per block (x4 gates = 128 weight rows)
constexpr int BK = 32;       // K tile
constexpr int NT = 256;      // 8 warps: 4 along rows x 2 along units
constexpr int LDS = BK + 8;  // smem row stride (80 B: 16-byte aligned, conflict-free fragments)
constexpr int WM = 32;       // rows per warp
constexpr int WN = 16;       // units per warp

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
    uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ uint16_t f32_to_bf16(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
}

struct GateArgs {
    const uint16_t* x;       // [B, D] this step's token embeddings
    const uint16_t* h_prev;  // [B, H] bf16(h_{t-1}); unread at t == 0
    const uint16_t* w_ih;    // [4H, D]
    const uint16_t* w_hh;    // [4H, H]
    long long B;
    int D, H, t;
};

typedef uint16_t TileA[BM][LDS];
typedef uint16_t TileW[4 * BN][LDS];

// Stage K tile `kt` (x part first, then h part) of A and of the weights.
__device__ __forceinline__ void load_gate_tile(const GateArgs& p, int kt, int nk0, long long row0, int j0,
                                               const int* s_len, TileA& As, TileW& Bs) {
    const bool hpart = kt >= nk0;
    const int k0 = (hpart ? kt - nk0 : kt) * BK;
    const int K = hpart ? p.H : p.D;
    const uint16_t* a = hpart ? p.h_prev : p.x;
    const uint16_t* w = hpart ? p.w_hh : p.w_ih;
    constexpr int CH = BK / 8;  // 16-byte chunks per tile row
    // Each source address is formed before the select: the kernel ran slower
    // on an H100 with the address arithmetic inside the select.

    for (int i = threadIdx.x; i < BM * CH; i += NT) {
        const int r = i / CH, kc = (i % CH) * 8, k = k0 + kc;
        const uint16_t* src = a + (size_t)(row0 + r) * K + k;
        const bool ok = s_len[r] > p.t && k < K;  // rows past B have s_len 0
        cp_async16(&As[r][kc], ok ? src : a, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < 4 * BN * CH; i += NT) {
        const int n = i / CH, kc = (i % CH) * 8, k = k0 + kc;
        const int g = n / BN, j = j0 + n % BN;
        const uint16_t* src = w + ((size_t)g * p.H + j) * K + k;
        const bool ok = j < p.H && k < K;
        cp_async16(&Bs[n][kc], ok ? src : w, ok ? 16 : 0);
    }
}

// acc[m16 tile][gate][n8 tile][fragment] = the gate pre-activations (without
// bias) of this block's cells.  The caller owns the shared tiles.
__device__ __forceinline__ void gate_product(const GateArgs& p, long long row0, int j0, const int* s_len,
                                             TileA* As, TileW* Bs, float (&acc)[2][4][2][4]) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][g][ni][e] = 0.f;

    const int nk0 = (p.D + BK - 1) / BK;
    const int nk = nk0 + (p.t > 0 ? (p.H + BK - 1) / BK : 0);  // h_0 = 0: no h part at t == 0

    if (nk > 0) load_gate_tile(p, 0, nk0, row0, j0, s_len, As[0], Bs[0]);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt & 1;
        if (kt + 1 < nk) load_gate_tile(p, kt + 1, nk0, row0, j0, s_len, As[s ^ 1], Bs[s ^ 1]);
        cp_async_commit();
        cp_async_wait_1();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[2][4], b[4][2][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int r = wm * WM + mi * 16 + gid;
                a[mi][0] = ld_pair(&As[s][r][kk + tig * 2]);
                a[mi][1] = ld_pair(&As[s][r + 8][kk + tig * 2]);
                a[mi][2] = ld_pair(&As[s][r][kk + tig * 2 + 8]);
                a[mi][3] = ld_pair(&As[s][r + 8][kk + tig * 2 + 8]);
            }
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
                for (int ni = 0; ni < 2; ++ni) {
                    const int n = g * BN + wn * WN + ni * 8 + gid;
                    b[g][ni][0] = ld_pair(&Bs[s][n][kk + tig * 2]);
                    b[g][ni][1] = ld_pair(&Bs[s][n][kk + tig * 2 + 8]);
                }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int g = 0; g < 4; ++g)
#pragma unroll
                    for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][g][ni], a[mi], b[g][ni]);
        }
        __syncthreads();
    }
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

// Each block loads its rows' lengths max(len, 1) (0 past B) and returns
// whether any of them is active at step t.
__device__ __forceinline__ bool load_lengths(const int* lens, long long B, long long row0, int t, int* s_len) {
    int any = 0;
    for (int r = threadIdx.x; r < BM; r += NT) {
        const long long row = row0 + r;
        const int len = row < B ? max(lens[row], 1) : 0;
        s_len[r] = len;
        any |= len > t;
    }
    return __syncthreads_or(any);
}

}  // namespace oket_lstm
