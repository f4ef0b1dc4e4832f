// The two products of the f32 LSTM kernels, in true f32 on the CUDA cores
// (FFMA, no TF32: the plain versions and the JAX reference take f32 products,
// and a TF32 product keeps 10 mantissa bits, which is another result):
//   * gate_product_f32, the gate product of one recurrence step, shared by the
//     f32 forwards (lstm_last_fwd_f32.cu, lstm_scan.cu) and the recurrence
//     backward's gate recompute (lstm_scan.cu; the fused backward of
//     lstm_last_bwd.cu takes 3xTF32 on the tensor cores instead):
//       acc = x_t . W_ih^T + h_{t-1} . W_hh^T   (f32 operands, f32 FFMA)
//     with the tile and accumulator contract of lstm_gates.cuh::gate_product:
//     a block of NT threads owns BM rows x the four gate columns {j, H+j,
//     2H+j, 3H+j} of BN hidden units, K runs over the x part (D) and then the
//     h part (H, skipped at t == 0 where h_0 = 0; D == 0 for the
//     recurrence-only LSTM), rows with s_len[r] <= t are zero-filled, and the
//     thread that holds a cell's accumulators holds all four of its gates;
//   * lstm_bwd_product_kernel_f32, the product launch of one step of the
//     recurrence backward (lstm_scan.cu; lstm_product.cuh's contract in f32):
//       [dh_carry | demb] = dg . [W_hh | W_ih]   over K = 4H.
// Tiles are staged through shared memory with cp.async in 16-byte chunks,
// double buffered, so D and H are multiples of 4; each thread keeps a
// register tile of 8 rows x 8 columns and reads its operands as float4.
// Bound on an H100: FP32 FFMA operations (132 SMs x 128 lanes x 2 FLOP per
// clock, ~67 TFLOP/s at 1.98 GHz), not device memory: a gate tile does
// 128 x 128 x 2 FLOP per 1 KiB of operands it stages per unit of K.

#pragma once

#include "lstm_product.cuh"

namespace oket_lstm {

constexpr int FBK = 16;       // K tile, in floats
constexpr int FLD = FBK + 4;  // smem row stride (80 B: 16-byte aligned; the 8 rows a quarter warp reads as
                              // float4 land in 8 distinct 16-byte bank groups)
constexpr int FRM = BM / 16;  // rows per thread: r = threadIdx.x / 16 + 16 i
constexpr int FUN = BN / 16;  // units per thread: j = j0 + threadIdx.x % 16 + 16 u

__device__ __forceinline__ int f32_row(int i) { return threadIdx.x / 16 + 16 * i; }
__device__ __forceinline__ int f32_unit(int u) { return threadIdx.x % 16 + 16 * u; }

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
}

struct GateArgsF32 {
    const float* x;       // [B, D] this step's token embeddings; unread when D == 0
    const float* h_prev;  // [B, H] h_{t-1}; unread at t == 0
    const float* w_ih;    // [4H, D]
    const float* w_hh;    // [4H, H]
    long long B;
    int D, H, t;
};

typedef float TileAF[BM][FLD];
typedef float TileWF[4 * BN][FLD];

// Stage K tile `kt` (x part first, then h part) of A and of the weights.
__device__ __forceinline__ void load_gate_tile_f32(const GateArgsF32& p, int kt, int nk0, long long row0, int j0,
                                                   const int* s_len, TileAF& As, TileWF& Bs) {
    const bool hpart = kt >= nk0;
    const int k0 = (hpart ? kt - nk0 : kt) * FBK;
    const int K = hpart ? p.H : p.D;
    const float* a = hpart ? p.h_prev : p.x;
    const float* w = hpart ? p.w_hh : p.w_ih;
    constexpr int CH = FBK / 4;  // 16-byte chunks per tile row
    for (int i = threadIdx.x; i < BM * CH; i += NT) {
        const int r = i / CH, kc = (i % CH) * 4, k = k0 + kc;
        const float* src = a + (size_t)(row0 + r) * K + k;
        const bool ok = s_len[r] > p.t && k < K;  // rows past B have s_len 0
        cp_async16(&As[r][kc], ok ? src : a, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < 4 * BN * CH; i += NT) {
        const int n = i / CH, kc = (i % CH) * 4, k = k0 + kc;
        const int g = n / BN, j = j0 + n % BN;
        const float* src = w + ((size_t)g * p.H + j) * K + k;
        const bool ok = j < p.H && k < K;
        cp_async16(&Bs[n][kc], ok ? src : w, ok ? 16 : 0);
    }
}

// acc[i][gate][u] = the gate pre-activations (without bias) of the cell
// (row f32_row(i), unit j0 + f32_unit(u)).  The caller owns the shared tiles.
__device__ __forceinline__ void gate_product_f32(const GateArgsF32& p, long long row0, int j0, const int* s_len,
                                                 TileAF* As, TileWF* Bs, float (&acc)[FRM][4][FUN]) {
#pragma unroll
    for (int i = 0; i < FRM; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int u = 0; u < FUN; ++u) acc[i][g][u] = 0.f;

    const int nk0 = (p.D + FBK - 1) / FBK;
    const int nk = nk0 + (p.t > 0 ? (p.H + FBK - 1) / FBK : 0);  // h_0 = 0: no h part at t == 0

    if (nk > 0) load_gate_tile_f32(p, 0, nk0, row0, j0, s_len, As[0], Bs[0]);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt & 1;
        if (kt + 1 < nk) load_gate_tile_f32(p, kt + 1, nk0, row0, j0, s_len, As[s ^ 1], Bs[s ^ 1]);
        cp_async_commit();
        cp_async_wait_1();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FBK; kk += 4) {
            float4 b[4][FUN];
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
                for (int u = 0; u < FUN; ++u)
                    b[g][u] = *reinterpret_cast<const float4*>(&Bs[s][g * BN + f32_unit(u)][kk]);
#pragma unroll
            for (int i = 0; i < FRM; ++i) {
                const float4 a = *reinterpret_cast<const float4*>(&As[s][f32_row(i)][kk]);
#pragma unroll
                for (int g = 0; g < 4; ++g)
#pragma unroll
                    for (int u = 0; u < FUN; ++u) fma4(acc[i][g][u], a, b[g][u]);
            }
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------- dh / demb

constexpr int FPLD = PBN + 4;  // smem row stride of the k-major weight tile

struct ProdArgsF32 {
    const float* dg;    // [B, 4H] step t
    const float* w_hh;  // [4H, H]
    const float* w_ih;  // [4H, D]; unread when D == 0
    const int* lens;    // [B], sorted descending; null: every row active
    float* dh;          // [B, H] out: dg . W_hh (t > 0)
    float* demb;        // [B, D] out: dg . W_ih, step t; unused when D == 0
    long long B;
    int D, H, t;
};

__device__ __forceinline__ void load_product_tile_f32(const ProdArgsF32& p, int kt, long long row0, int n0,
                                                      long long nrows, float (*As)[FLD], float (*Bs)[FPLD]) {
    const int K = 4 * p.H, k0 = kt * FBK;
    constexpr int CH = FBK / 4;
    for (int i = threadIdx.x; i < BM * CH; i += NT) {
        const int r = i / CH, kc = (i % CH) * 4, k = k0 + kc;
        const float* src = p.dg + (size_t)(row0 + r) * K + k;
        const bool ok = row0 + r < nrows && k < K;
        cp_async16(&As[r][kc], ok ? src : p.dg, ok ? 16 : 0);
    }
    // weight rows k of the output columns [n0, n0 + PBN): columns [0, H) are
    // dh (W_hh), then demb (W_ih); H % 4 == 0, so no copy straddles the two
    constexpr int CN = PBN / 4;
    for (int i = threadIdx.x; i < FBK * CN; i += NT) {
        const int kr = i / CN, c = (i % CN) * 4, k = k0 + kr, n = n0 + c;
        const bool hpart = n < p.H;
        const float* src = hpart ? p.w_hh + (size_t)k * p.H + n : p.w_ih + (size_t)k * p.D + (n - p.H);
        const bool ok = n < p.H + p.D && k < K;
        cp_async16(&Bs[kr][c], ok ? src : p.w_hh, ok ? 16 : 0);
    }
}

// Thread (r = threadIdx.x / 16 + 16 i, columns n0 + 4 (threadIdx.x % 16) +
// 64 v + e): rows broadcast within a quarter warp, columns read as float4.
__global__ void __launch_bounds__(NT) lstm_bwd_product_kernel_f32(const ProdArgsF32 p) {
    __shared__ __align__(16) float As[2][BM][FLD];
    __shared__ __align__(16) float Bs[2][FBK][FPLD];

    const long long nrows = p.lens ? active_rows(p.lens, p.B, p.t) : p.B;
    const long long row0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * PBN;
    if (row0 >= nrows) return;
    if (p.t == 0 && n0 + PBN <= p.H) return;  // dh of step 0 is never read

    const int tc = threadIdx.x % 16;
    float acc[FRM][2][4];
#pragma unroll
    for (int i = 0; i < FRM; ++i)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][v][e] = 0.f;

    const int nk = (4 * p.H + FBK - 1) / FBK;
    load_product_tile_f32(p, 0, row0, n0, nrows, As[0], Bs[0]);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt & 1;
        if (kt + 1 < nk) load_product_tile_f32(p, kt + 1, row0, n0, nrows, As[s ^ 1], Bs[s ^ 1]);
        cp_async_commit();
        cp_async_wait_1();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FBK; kk += 4) {
            float4 b[4][2];
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int v = 0; v < 2; ++v) b[q][v] = *reinterpret_cast<const float4*>(&Bs[s][kk + q][tc * 4 + 64 * v]);
#pragma unroll
            for (int i = 0; i < FRM; ++i) {
                const float4 a = *reinterpret_cast<const float4*>(&As[s][f32_row(i)][kk]);
                const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int v = 0; v < 2; ++v) {
                        acc[i][v][0] = fmaf(av[q], b[q][v].x, acc[i][v][0]);
                        acc[i][v][1] = fmaf(av[q], b[q][v].y, acc[i][v][1]);
                        acc[i][v][2] = fmaf(av[q], b[q][v].z, acc[i][v][2]);
                        acc[i][v][3] = fmaf(av[q], b[q][v].w, acc[i][v][3]);
                    }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < FRM; ++i) {
        const long long row = row0 + f32_row(i);
        if (row >= nrows) continue;
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = n0 + tc * 4 + 64 * v + e;
                if (n >= p.H + p.D) continue;
                if (n < p.H) {
                    if (p.t > 0) p.dh[(size_t)row * p.H + n] = acc[i][v][e];
                } else {
                    p.demb[(size_t)row * p.D + (n - p.H)] = acc[i][v][e];
                }
            }
    }
}

// Launch the f32 product of step t on `stream`; returns the cudaError_t.
inline int launch_bwd_product_f32(const ProdArgsF32& p, void* stream) {
    const dim3 grid((unsigned)((p.B + BM - 1) / BM), (unsigned)((p.H + p.D + PBN - 1) / PBN));
    lstm_bwd_product_kernel_f32<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace oket_lstm
