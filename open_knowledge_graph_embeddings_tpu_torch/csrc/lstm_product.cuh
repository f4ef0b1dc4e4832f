// The product launch of one step of the recurrence-only LSTM backward
// (lstm_scan.cu, kernel 8; the fused backward's is lstm_last_bwd.cu's own,
// on wgmma):
//   [dh_carry | demb] = dg . [W_hh | W_ih]     (bf16 operands, f32 accumulation)
// over K = 4H, for the rows active at step t.  dg is the step's bf16 dgates
// [B, 4H]; the gate-major weights ([4H, H] and [4H, D]: K rows of contiguous
// output columns) are read as they are with ldmatrix.trans.  With D == 0
// there is no demb part (the recurrence-only backward); with lens == null
// every row of [0, B) is active.

#pragma once

#include "lstm_gates.cuh"

namespace oket_lstm {

// Four 8x8 bf16 tiles from shared memory, transposed: with rows k and
// contiguous columns n, each thread gets the (k = 2*tig, 2*tig+1; n = gid)
// pairs of an mma B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const uint16_t* smem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

constexpr int PBN = 128;        // output columns per product block
constexpr int PLD = PBN + 8;    // smem row stride of the weight tile (272 B: conflict-free ldmatrix)

struct ProdArgs {
    const uint16_t* dg;    // [B, 4H] step t
    const uint16_t* w_hh;  // [4H, H]
    const uint16_t* w_ih;  // [4H, D]; unread when D == 0
    const int* lens;       // [B], sorted descending; null: every row active
    float* dh;             // [B, H] out: dg . W_hh (t > 0)
    uint16_t* demb;        // [B, D] out: bf16(dg . W_ih), step t; unused when D == 0
    long long B;
    int D, H, t;
};

__device__ __forceinline__ void load_product_tile(const ProdArgs& p, int kt, long long row0, int n0,
                                                  long long nrows, uint16_t (*As)[LDS], uint16_t (*Bs)[PLD]) {
    const int K = 4 * p.H, k0 = kt * BK;
    constexpr int CH = BK / 8;
    for (int i = threadIdx.x; i < BM * CH; i += NT) {
        const int r = i / CH, kc = (i % CH) * 8, k = k0 + kc;
        const uint16_t* src = p.dg + (size_t)(row0 + r) * K + k;
        const bool ok = row0 + r < nrows && k < K;
        cp_async16(&As[r][kc], ok ? src : p.dg, ok ? 16 : 0);
    }
    // weight rows k of the output columns [n0, n0 + PBN): columns [0, H) are
    // dh (W_hh), then demb (W_ih); H % 8 == 0, so no copy straddles the two
    constexpr int CN = PBN / 8;
    for (int i = threadIdx.x; i < BK * CN; i += NT) {
        const int kr = i / CN, c = (i % CN) * 8, k = k0 + kr, n = n0 + c;
        const bool hpart = n < p.H;
        const uint16_t* src = hpart ? p.w_hh + (size_t)k * p.H + n : p.w_ih + (size_t)k * p.D + (n - p.H);
        const bool ok = n < p.H + p.D && k < K;
        cp_async16(&Bs[kr][c], ok ? src : p.w_hh, ok ? 16 : 0);
    }
}

__global__ void __launch_bounds__(NT) lstm_bwd_product_kernel(const ProdArgs p) {
    __shared__ __align__(16) uint16_t As[2][BM][LDS];
    __shared__ __align__(16) uint16_t Bs[2][BK][PLD];

    const long long nrows = p.lens ? active_rows(p.lens, p.B, p.t) : p.B;
    const long long row0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * PBN;
    if (row0 >= nrows) return;
    if (p.t == 0 && n0 + PBN <= p.H) return;  // dh of step 0 is never read

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;  // 4 x 32 rows, 2 x 64 columns
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    const int nk = (4 * p.H + BK - 1) / BK;
    load_product_tile(p, 0, row0, n0, nrows, As[0], Bs[0]);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt & 1;
        if (kt + 1 < nk) load_product_tile(p, kt + 1, row0, n0, nrows, As[s ^ 1], Bs[s ^ 1]);
        cp_async_commit();
        cp_async_wait_1();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[2][4], b[8][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int r = wm * 32 + mi * 16 + gid;
                a[mi][0] = ld_pair(&As[s][r][kk + tig * 2]);
                a[mi][1] = ld_pair(&As[s][r + 8][kk + tig * 2]);
                a[mi][2] = ld_pair(&As[s][r][kk + tig * 2 + 8]);
                a[mi][3] = ld_pair(&As[s][r + 8][kk + tig * 2 + 8]);
            }
            // lanes 0-7 / 8-15 address k rows 0-7 / 8-15 of an n8 tile, lanes
            // 16-31 the same rows of the next n8 tile
            const int kr = kk + (lane & 15);
#pragma unroll
            for (int nj = 0; nj < 4; ++nj)
                ldmatrix_x4_trans(&b[2 * nj][0], &Bs[s][kr][wn * 64 + nj * 16 + (lane >> 4) * 8]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const long long row = row0 + wm * 32 + mi * 16 + gid + ((e >> 1) << 3);
                const int n = n0 + wn * 64 + ni * 8 + tig * 2 + (e & 1);
                if (row >= nrows || n >= p.H + p.D) continue;
                if (n < p.H) {
                    if (p.t > 0) p.dh[(size_t)row * p.H + n] = acc[mi][ni][e];
                } else {
                    p.demb[(size_t)row * p.D + (n - p.H)] = f32_to_bf16(acc[mi][ni][e]);
                }
            }
}

// Launch the product of step t on `stream`; returns the cudaError_t.
inline int launch_bwd_product(const ProdArgs& p, void* stream) {
    const dim3 grid((unsigned)((p.B + BM - 1) / BM), (unsigned)((p.H + p.D + PBN - 1) / PBN));
    lstm_bwd_product_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace oket_lstm
