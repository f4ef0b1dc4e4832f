// The 3xTF32 gate loop of the f32 LSTM kernels on Hopper's tensor cores,
// shared by the f32 forward (lstm_last_fwd_f32.cu, kernels 1 and 5), the
// f32 backward (the tf32:: kernels of lstm_last_bwd.cu, kernels 2 and 6) and
// the f32 recurrence over a precomputed input projection (the tf32:: kernels
// of lstm_scan.cu, kernels 7 and 8): one ring, split, fragment load and
// product loop, so a backward's gate launch recomputes its forward's
// pre-activations in the same sum order, and one product launch
// (product_tiles) for the backwards' dh/demb.
//
// 3xTF32: each f32 operand x is split into hi = tf32(x) and lo = tf32(x -
// hi) (lstm_sm90.cuh::tf32_split; 10 + 10 mantissa bits, so x is kept to
// ~2^-22), and a product sums lo.hi' + hi.lo' + hi.hi' in f32: as accurate
// as an f32 product, where one TF32 product (hi.hi' alone, the X1 variant)
// is not.  Bound on an H100: the 3xTF32 rate, a third of the TF32 rate.
//
// The shape is kernel 1's (lstm_last_fwd.cu): a persistent block of 384
// threads; warpgroup 2 gives its registers away and one of its threads
// loads each K stage of the block's tiles by TMA into a ring of STAGES slots
// (A: 128 rows x 32 f32 of x_t, h_{t-1} or dg; W_hi and W_lo: 128 weight
// rows x 32, 128-byte swizzled), guarded by a full and an empty mbarrier
// each; warpgroups 0 and 1 share every tile, 64 rows each, and multiply
// their halves by the same weight slots with wgmma m64n128k8 TF32, A read
// from the swizzled slot into registers and split there, B the split
// weights from shared memory (tile_products: the tensor cores' sums are
// folded into an f32 sum every 32 of K, see there why).  The split launch
// (once per call) writes the hi and lo parts of the weights: gate-major for
// the gate loops (TF32 wgmma reads only K-major operands, and [4H, K] is
// K-major), and for the backward's dh/demb product also [W_hh | W_ih]^T.

#pragma once

#include "lstm_sm90.cuh"

namespace oket_tf32 {

using namespace oket_sm90;

constexpr int TM = 128;     // rows per tile
constexpr int TU = 32;      // hidden units per gate tile: 4 gate slabs of TU weight rows
constexpr int TN = 128;     // columns per tile (gate: 4 x TU; product: 128 of [dh | demb])
constexpr int NB = TU / 8;  // 8-unit column blocks per gate slab
constexpr int TK = 32;      // K per stage: 128 bytes of f32, one swizzle row
constexpr int STAGES = 4;
constexpr int A_BYTES = TM * TK * 4;  // 16 KB
constexpr int W_BYTES = TN * TK * 4;  // 16 KB, once for hi and once for lo
constexpr int STAGE_BYTES = A_BYTES + 2 * W_BYTES;
// the ring, its barriers, and slack to align the ring to 1024 bytes
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces

// What the gate loop computes: the kernel (3xTF32), hi.hi' alone (1xTF32),
// planted by chip_smoke.py to show that the f32 rule sees the correction
// products, or, for measuring the forward, no products at all (the ring's
// slots are taken and given back unread).
enum Variant { X3 = 0, X1 = 1, NO_PRODUCTS = 2 };

// The ring of STAGES slots (A, W_hi, W_lo), a full and an empty mbarrier
// each; a slot is empty again when the eight consumer warps have read it.
struct Ring {
    uint8_t* slots;
    uint64_t* full;
    uint64_t* empty;
};

__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw) {
    Ring r;
    r.slots = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    r.full = reinterpret_cast<uint64_t*>(r.slots + STAGES * STAGE_BYTES);
    r.empty = r.full + STAGES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&r.full[s], 1);
            mbar_init(&r.empty[s], 8);
        }
        mbar_fence_init();
    }
    return r;
}

// The producer thread: stage kt of each of the block's tiles, in order,
// loaded by load(tile, kt, a, w_hi, w_lo, bar) into the next slot.
template <typename Load>
__device__ __forceinline__ void produce(const Ring& r, int tiles, int nk, Load load) {
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(&r.empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(&r.full[s], STAGE_BYTES);
            uint8_t* a = r.slots + s * STAGE_BYTES;
            load(tile, kt, a, a + A_BYTES, a + A_BYTES + W_BYTES, &r.full[s]);
        }
}

// Element (row, k) of an A slot: 128-byte rows, the 16-byte chunk c of row
// r stored at chunk c ^ (r % 8) (TMA's 128-byte swizzle).
__device__ __forceinline__ float slot_elem(const uint8_t* a, int row, int k) {
    return *reinterpret_cast<const float*>(a + row * 128 + (((k >> 2) ^ (row & 7)) << 4) + (k & 3) * 4);
}

// sum += A[64 wg .. 64 wg + 63, :] . W^T over the nk stages of the block's
// tile q, in 3xTF32, for the 64-row half `wg` of the tile (the two consumer
// warpgroups share every tile, each multiplying its half by the same weight
// slots): per k8 step, A's fragments are read from the swizzled slot into
// registers and split there, then lo.W_hi and hi.W_lo are accumulated
// before hi.W_hi (the correction products first, as CUTLASS's fast-f32
// product does).  One k8 step's products stay in flight while the next
// step's fragments are split (two sets of fragment registers, by step
// parity).  The tensor cores' sums are folded into the f32 `sum` in
// registers every 32 of K.  Why: the tensor cores add a wgmma's products
// into its f32 accumulator at their own precision, not rounded as an f32
// add (one accumulator over an output's 384 wgmma reads ~1e-5 of max|want|
// against f32 products at the initial weights), and the recurrence on
// trained weights amplifies that error into the outputs: a trained f32
// flagship's cache rows read 3.3e-4 of max|want| against the plain encode
// on an H100 with one accumulator.  So each K chunk of 32 (4 k8 steps, 12
// wgmma) accumulates apart, from zero (scale_d = 0), and is added to `sum`
// (which holds the bias, or 0) by f32 adds: the accumulator sees 12 adds,
// relative to one chunk's magnitude.  The two warpgroups fold half a stage apart, so while one
// waits for its chunk to finish, the other's products keep the tensor
// cores busy.  FOLD = false keeps one chunk over all of K (for measuring
// what the fold buys).
template <int V, bool FOLD = true>
__device__ __forceinline__ void tile_products(const Ring& r, int q, int nk, int wg, int warp, int lane,
                                              float (&sum)[TN / 2]) {
    if constexpr (V == NO_PRODUCTS) {
        for (int kt = 0; kt < nk; ++kt) {
            const int it = q * nk + kt, s = it % STAGES;
            mbar_wait(&r.full[s], (it / STAGES) & 1);
            if (lane == 0) mbar_arrive(&r.empty[s]);
        }
        return;
    }
    float st[TN / 2];  // the chunk's tensor-core sum
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) st[i] = 0.f;
    uint32_t hi[2][4], lo[2][4];  // [k8 step parity][fragment register]
    const int off = 2 * wg;  // the k8 step (mod 4) at which this warpgroup's chunks start
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
        const int it = q * nk + kt, s = it % STAGES;
        mbar_wait(&r.full[s], (it / STAGES) & 1);
        const uint8_t* a = r.slots + s * STAGE_BYTES;
        const uint8_t* w_hi = a + A_BYTES;
        const uint8_t* w_lo = w_hi + W_BYTES;
#pragma unroll
        for (int kk = 0; kk < TK / 8; ++kk) {
            const int b = kk & 1;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                // register i: row 64 wg + 16 warp + lane / 4 + 8 (i % 2), k = lane % 4 + 4 (i / 2)
                const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * (i & 1);
                tf32_split(slot_elem(a, row, kk * 8 + (lane & 3) + 4 * (i >> 1)), hi[b][i], lo[b][i]);
            }
            const bool first = kt == 0 && kk == 0;
            const bool start = first || (FOLD && ((kk + off) & 3) == 0);
            if (start && !first) {  // the finished chunk goes into sum
                wgmma_wait<0>();
                wgmma_fence_regs(st);
#pragma unroll
                for (int i = 0; i < TN / 2; ++i) sum[i] += st[i];
            }
            wgmma_fence_regs(st);
            wgmma_fence();
            const uint64_t d_hi = wgmma_desc(w_hi + kk * 32), d_lo = wgmma_desc(w_lo + kk * 32);
            const int keep = start ? 0 : 1;
            if (V == X3) {
                wgmma_m64n128k8_tf32(st, lo[b], d_hi, keep);
                wgmma_m64n128k8_tf32(st, hi[b], d_lo);
                wgmma_m64n128k8_tf32(st, hi[b], d_hi);
            } else {
                wgmma_m64n128k8_tf32(st, hi[b], d_hi, keep);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the previous k8 step's products are done
            wgmma_fence_regs(st);
            // so at the first k8 step of a stage, the previous stage is read
            if (kk == 0 && kt > 0 && lane == 0) mbar_arrive(&r.empty[prev]);
        }
        prev = s;
    }
    wgmma_wait<0>();
    wgmma_fence_regs(st);
    if (nk > 0) {
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) sum[i] += st[i];
        if (lane == 0) mbar_arrive(&r.empty[prev]);
    }
}

// The bias of the 4 x NB x 2 gate columns this thread holds in a gate tile
// at unit u0 seeds acc (acc[4 (g NB + n8) + e] is gate g of unit u0 + 8 n8
// + 2 (lane%4) + e%2, as tile_products leaves it); units past H get 0.  H
// is even and the bias 8-byte aligned.
__device__ __forceinline__ void seed_bias(const float* bias, int H, int u0, int lane, float (&acc)[TN / 2]) {
#pragma unroll
    for (int n8 = 0; n8 < NB; ++n8) {
        const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            const float2 b = u < H ? __ldg(reinterpret_cast<const float2*>(bias + g * H + u)) : make_float2(0.f, 0.f);
            acc[(g * NB + n8) * 4] = acc[(g * NB + n8) * 4 + 2] = b.x;
            acc[(g * NB + n8) * 4 + 1] = acc[(g * NB + n8) * 4 + 3] = b.y;
        }
    }
}

// Split launch, once per call: the hi and lo parts of W_ih and W_hh in
// their gate-major layout (the gate loop's B), and with TRANSPOSED also of
// [W_hh | W_ih]^T (the backward's product launch), through a 32 x 32 shared
// tile.  w_split holds w_ih_hi [4H, D], w_ih_lo, w_hh_hi [4H, H], w_hh_lo,
// and with TRANSPOSED then wt_hi [H + D, 4H], wt_lo, in that order.
template <bool TRANSPOSED>
__global__ void __launch_bounds__(256) lstm_split_kernel_tf32(const float* w_ih, const float* w_hh, float* w_split,
                                                               int D, int H) {
    __shared__ float t_hi[TRANSPOSED ? 32 : 1][33], t_lo[TRANSPOSED ? 32 : 1][33];
    const int H4 = 4 * H, N = H + D;
    float* wih_hi = w_split;
    float* wih_lo = wih_hi + (size_t)H4 * D;
    float* whh_hi = wih_lo + (size_t)H4 * D;
    float* whh_lo = whh_hi + (size_t)H4 * H;
    float* wt_hi = whh_lo + (size_t)H4 * H;
    float* wt_lo = wt_hi + (size_t)N * H4;
    const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32, tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    for (int i = ty; i < 32; i += 8) {
        const int k = k0 + i, n = n0 + tx;  // [W_hh | W_ih] row k (a gate column), column n
        if (k < H4 && n < N) {
            const size_t o = n < H ? (size_t)k * H + n : (size_t)k * D + (n - H);
            uint32_t hi, lo;
            tf32_split(n < H ? w_hh[o] : w_ih[o], hi, lo);
            (n < H ? whh_hi : wih_hi)[o] = __uint_as_float(hi);
            (n < H ? whh_lo : wih_lo)[o] = __uint_as_float(lo);
            if constexpr (TRANSPOSED) {
                t_hi[i][tx] = __uint_as_float(hi);
                t_lo[i][tx] = __uint_as_float(lo);
            }
        }
    }
    if constexpr (TRANSPOSED) {
        __syncthreads();
        for (int i = ty; i < 32; i += 8) {
            const int n = n0 + i, k = k0 + tx;
            if (k < H4 && n < N) {
                wt_hi[(size_t)n * H4 + k] = t_hi[tx][i];
                wt_lo[(size_t)n * H4 + k] = t_lo[tx][i];
            }
        }
    }
}

// Launches the split of w_ih [4H, D] and w_hh [4H, H] into w_split (4 (H +
// D) 4H floats with TRANSPOSED, half that without).  Returns the
// cudaError_t of the launch.
template <bool TRANSPOSED>
int launch_split(const void* w_ih, const void* w_hh, void* w_split, int D, int H, void* stream) {
    const dim3 grid((unsigned)((4 * H + 31) / 32), (unsigned)((H + D + 31) / 32));
    lstm_split_kernel_tf32<TRANSPOSED><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w_ih), static_cast<const float*>(w_hh), static_cast<float*>(w_split), D, H);
    return static_cast<int>(cudaGetLastError());
}

// The parts of w_split (see lstm_split_kernel_tf32); wt_* only with
// TRANSPOSED.
struct SplitWeights {
    const float *wih_hi, *wih_lo, *whh_hi, *whh_lo, *wt_hi, *wt_lo;
};

inline SplitWeights split_parts(const void* w_split, int D, int H) {
    const float* base = static_cast<const float*>(w_split);
    const size_t ih = (size_t)4 * H * D, hh = (size_t)4 * H * H, t = (size_t)(H + D) * 4 * H;
    return {base, base + ih, base + 2 * ih, base + 2 * ih + hh, base + 2 * ih + 2 * hh, base + 2 * ih + 2 * hh + t};
}

// What the product launch writes; dg comes by its tensor map.
struct ProductArgs {
    float* dh;    // [B, H] out: dg . W_hh (t > 0)
    float* demb;  // [B, D] out: dg . W_ih, step t; none when D == 0
    int B, D, H, t;
};

// The backward's product launch of step t: [dh | demb[t]] = dg[t] . [W_hh |
// W_ih] over K = 4H in 3xTF32, a tile of 128 rows x 128 output columns; B
// is the split copy of [W_hh | W_ih]^T ([H + D, 4H], K-major, map_wt_hi and
// map_wt_lo), as TF32 wgmma reads only K-major operands.  Rows past the
// active prefix [0, n_act_all) (the caller's; read from thread 0) are
// computed and not written; at t == 0 only the tiles holding demb columns
// run (dh of step 0 is never read).  With D = 0 (kernel 8: dh alone) there
// are no demb columns.  The products are the gate loop's (tile_products,
// the sum from 0).
template <int V, bool FOLD = true>
__device__ __forceinline__ void product_tiles(uint8_t* smem_raw, const CUtensorMap* map_dg,
                                              const CUtensorMap* map_wt_hi, const CUtensorMap* map_wt_lo,
                                              const ProductArgs& p, int n_act_all) {
    const Ring r = make_ring(smem_raw);
    __syncthreads();
    // block-uniform values made warp-uniform for the compiler (a wgmma on
    // what it takes for a divergent path is serialised)
    const int n_act = __shfl_sync(0xffffffff, n_act_all, 0);
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    const int N = p.H + p.D;
    const int n_first = p.t > 0 ? 0 : p.H / TN;  // the first column tile that holds a demb column
    const int col_tiles = (N + TN - 1) / TN - n_first;
    const int tiles = (n_act + TM - 1) / TM * col_tiles;
    if ((int)blockIdx.x >= tiles) return;
    const int nk = (4 * p.H + TK - 1) / TK;

    if (wg == 2) {
        setmaxnreg_dec<40>();
        if (threadIdx.x == 256) {
            tma_prefetch_map(map_dg);
            tma_prefetch_map(map_wt_hi);
            tma_prefetch_map(map_wt_lo);
            produce(r, tiles, nk, [&](int tile, int kt, uint8_t* a, uint8_t* w_hi, uint8_t* w_lo, uint64_t* bar) {
                const int row0 = tile / col_tiles * TM, n0 = (tile % col_tiles + n_first) * TN;
                tma_load_3d(a, map_dg, bar, kt * TK, row0, p.t);
                tma_load_3d(w_hi, map_wt_hi, bar, kt * TK, n0, 0);
                tma_load_3d(w_lo, map_wt_lo, bar, kt * TK, n0, 0);
            });
        }
    } else {
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        // acc[4 n8 + e] holds row r0 + 8 (e/2), column n0 + 8 n8 + 2
        // (lane%4) + e%2, for r0 = row0 + 64 wg + 16 warp + lane/4
        float acc[TN / 2];
        for (int q = 0;; ++q) {
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / col_tiles * TM, n0 = (tile % col_tiles + n_first) * TN;
            const int r0 = row0 + 64 * wg + warp * 16 + (lane >> 2);
#pragma unroll
            for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
            tile_products<V, FOLD>(r, q, nk, wg, warp, lane, acc);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = r0 + 8 * hr;
                if (row >= n_act) continue;
#pragma unroll
                for (int n8 = 0; n8 < TN / 8; ++n8) {
                    const int n = n0 + n8 * 8 + (lane & 3) * 2;  // and n + 1: H and N are even
                    const float2 v = make_float2(acc[n8 * 4 + 2 * hr], acc[n8 * 4 + 2 * hr + 1]);
                    if (n >= N) continue;
                    if (n < p.H) {
                        if (p.t > 0) *reinterpret_cast<float2*>(p.dh + (size_t)row * p.H + n) = v;
                    } else {
                        *reinterpret_cast<float2*>(p.demb + (size_t)row * p.D + (n - p.H)) = v;
                    }
                }
            }
        }
    }
}

}  // namespace oket_tf32
