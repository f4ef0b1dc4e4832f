// The bf16 gate loop of the LSTM kernels on Hopper's tensor cores, shared
// by kernel 1 (lstm_last_fwd.cu: the forward, last-state and every-state),
// by the bf16 backward's gate and product launches (lstm_last_bwd.cu,
// kernels 2 and 6) and by the recurrence over a precomputed input
// projection (lstm_scan.cu, kernels 7 and 8): one ring, producer, seed and
// product loop, so a backward's gate launch recomputes its forward's
// pre-activations in the same sum order (bitwise the same on the card), and
// one product launch (product_tiles) for the backwards' dh/demb.
//
// The shape is kernel 1's: a persistent block of 384 threads; warpgroup 2
// gives its registers away (setmaxnreg 40; the consumers take 232) and one
// of its threads loads each K stage of the block's tiles by TMA, in order,
// into a ring of STAGES slots (A: 128 rows x 64 bf16; W: 128 weight rows
// x 64, or for an MN-major B two boxes of 64 k-rows x 64 columns; 16 KB
// each, 128-byte swizzled), guarded by a full and an empty mbarrier each;
// for the gate tiles, warpgroups 0 and 1 take the block's tiles in turns
// (ping-pong: a turn mbarrier starts one's products when the other's are
// done, so one warpgroup's epilogue runs while the other's products keep
// the tensor cores busy) and multiply a whole 128-row tile with wgmma
// m64n128k16 (two 64-row halves, one group of products kept in flight,
// tile_products); for the backward's product tiles they share each tile, 64
// rows each, and fold every K stage into an f32 sum (tile_products_folded,
// product_tiles).
// The block walks the tiles blockIdx.x, + gridDim.x, ...; tile q of that
// walk takes ring positions q nk .. q nk + nk - 1.
//
// The gate tile (kernels 1 and 7, the backward's gate launches): 128 rows x
// 32 hidden units x the four gates, weight rows {g H + u0 + j}, so the 128
// product columns are four gate slabs of 32 units and the thread that holds
// column j of slab 0 holds column j of slabs 1-3 too.  The accumulators
// start from the bias (seed_bias; kernels 7 and 8 start from zero and add
// the rows' precomputed input projection after the products, add_rows),
// then take the x stages (K = D) and the h stages (K = H, none at t = 0,
// h_0 = 0), 64 of K each.  The tensor maps are 3-D: x over [L, B, D] at
// (t, row0), h over its [slots, B, H] buffer at (slot of t - 1, row0), so
// rows past B read as zero and never as the next step's rows; each weight
// as [4][H][K], one box holding the four gate slabs, so units past H read
// as zero instead of the next gate's rows; K tails read as zero too
// (lstm_sm90.cuh::bf16_map).  With D = 0 there are no x stages, and no x
// or W_ih map: TMA refuses a zero extent, so the callers pass none and the
// producer touches none.

#pragma once

#include "lstm_gates.cuh"
#include "lstm_sm90.cuh"

namespace oket_bf16 {

using namespace oket_sm90;

constexpr int TM = 128;     // rows per tile
constexpr int TU = 32;      // hidden units per gate tile
constexpr int TN = 4 * TU;  // columns per tile: four gate slabs of TU units, or 128 output columns
constexpr int NB = TU / 8;  // 8-unit column blocks per gate slab
constexpr int TK = 64;      // K per stage: 128 bytes of bf16, one swizzle row
constexpr int STAGES = 6;
constexpr int A_BYTES = TM * TK * 2;  // 16 KB
constexpr int W_BYTES = TN * TK * 2;  // 16 KB
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
// the ring, its barriers, and slack to align the ring to 1024 bytes
constexpr int SMEM = STAGES * STAGE_BYTES + (2 * STAGES + 2) * 8 + 1024;
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces

// The sigmoid from the hardware exponential and reciprocal (ex2.approx,
// rcp.approx: a few f32 ulps of error, far below the bf16 rounding of h and
// cs; the IEEE division of 1 / (1 + e) made kernel 1 slower).  tanh stays
// the library's: 2 sigmoid(2x) - 1 loses the relative accuracy of small
// values and raised the share of kernel 1's bf16 outputs unequal to the
// plain version's by half.
__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// Two bf16 values packed low-first, as f32.
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
}

__device__ __forceinline__ uint32_t f32x2_to_bf16x2(float lo, float hi) {
    return (uint32_t)oket_lstm::f32_to_bf16(lo) | ((uint32_t)oket_lstm::f32_to_bf16(hi) << 16);
}

// The ring of STAGES slots (A, W), a full and an empty mbarrier each (a slot
// is empty again when the `readers` warps that read it are done: the four of
// one warpgroup in turns, or the eight of both on a shared tile), and
// turn[w]: the other warpgroup finished a tile's products.  Thread 0
// initialises the barriers; the caller then synchronises the block.
struct Ring {
    uint8_t* slots;
    uint64_t* full;
    uint64_t* empty;
    uint64_t* turn;
};

__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw, int readers = 4) {
    Ring r;
    r.slots = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    r.full = reinterpret_cast<uint64_t*>(r.slots + STAGES * STAGE_BYTES);
    r.empty = r.full + STAGES;
    r.turn = r.empty + STAGES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&r.full[s], 1);
            mbar_init(&r.empty[s], readers);
        }
        mbar_init(&r.turn[0], 4);
        mbar_init(&r.turn[1], 4);
        mbar_fence_init();
    }
    return r;
}

// The producer of the gate tiles of step t: nkx x stages (x_t at (t, row0),
// W_ih) and then the h stages (h_{t-1} at (h_slot, row0) of the h map, W_hh)
// of each tile, the unit tile fastest (so the blocks in flight share their
// A rows in L2).  The tile's coordinates are worked out once per tile (once
// per stage, they slowed kernel 1 at the training shapes on an H100).  With
// nkx = 0 (D = 0) map_x and map_wih are never read and may be null.
__device__ __forceinline__ void produce_gate_tiles(const Ring& r, int tiles, int unit_tiles, int nkx, int nk,
                                                   const CUtensorMap* map_x, const CUtensorMap* map_h,
                                                   const CUtensorMap* map_wih, const CUtensorMap* map_whh, int t,
                                                   int h_slot) {
    if (nkx > 0) {
        tma_prefetch_map(map_x);
        tma_prefetch_map(map_wih);
    }
    if (nk > nkx) {
        tma_prefetch_map(map_h);
        tma_prefetch_map(map_whh);
    }
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
        for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(&r.empty[s], ((it / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(&r.full[s], STAGE_BYTES);
            uint8_t* a = r.slots + s * STAGE_BYTES;
            uint8_t* w = a + A_BYTES;
            if (kt < nkx) {
                tma_load_3d(a, map_x, &r.full[s], kt * TK, row0, t);
                tma_load_3d(w, map_wih, &r.full[s], kt * TK, u0, 0);
            } else {
                tma_load_3d(a, map_h, &r.full[s], (kt - nkx) * TK, row0, h_slot);
                tma_load_3d(w, map_whh, &r.full[s], (kt - nkx) * TK, u0, 0);
            }
        }
    }
}

// The bias of the gate columns this thread holds in the gate tile at unit
// u0 seeds acc: acc[m][4 (g NB + n8) + e] is gate g of row r0 + 64 m + 8
// (e/2), unit u0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 16 warp +
// lane/4 (the wgmma layout of the two 64-row halves); units past H get 0.
// H is even and the bias 8-byte aligned.  also(n8, u) runs in the same loop
// after the bias of 8-unit block n8 (first unit u) is loaded: kernel 1
// issues its cells' c_{t-1} loads there, so that all its loads go out
// before the products (in a loop of their own after the seed, kernel 1 ran
// slower at the training shapes on an H100).  `also` must do no arithmetic
// on acc: the backward's gate launch passes an empty one, and the gates are
// bitwise kernel 1's only while the seed and the products are the same.
template <typename Also>
__device__ __forceinline__ void seed_bias(const float* bias, int H, int u0, int lane, float (&acc)[2][TN / 2],
                                          Also also) {
#pragma unroll
    for (int n8 = 0; n8 < NB; ++n8) {
        const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            const float2 b = u < H ? __ldg(reinterpret_cast<const float2*>(bias + g * H + u)) : make_float2(0.f, 0.f);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                acc[m][(g * NB + n8) * 4] = acc[m][(g * NB + n8) * 4 + 2] = b.x;
                acc[m][(g * NB + n8) * 4 + 1] = acc[m][(g * NB + n8) * 4 + 3] = b.y;
            }
        }
        also(n8, u);
    }
}

// acc += the gate columns this thread holds in 8-unit block n8 of the gate
// tile (r0's rows, unit u0) of a precomputed input projection xp [B, 4H]
// (bf16, gate g of unit u at g H + u), in seed_bias's layout:
// acc[m][4 (g NB + n8) + e] is gate g of row r0 + 64 m + 8 (e/2), unit
// u0 + 8 n8 + 2 (lane%4) + e%2.  Rows past B and units past H add 0.  H
// is even and xp 4-byte aligned, so a unit pair is one load.  Kernels 7 and
// 8 add x_proj after the products, as the plain version and the TPU kernel
// order the sum: seeded into the accumulators (as kernel 1 seeds its small
// bias) it left the tensor cores' own accumulation more to round, and on an
// H100 one row at H = 520 read 3.654 % of hs unequal to the plain version
// (the bf16 rule allows 2 %).  Added one block at a time, in the epilogue:
// all 64 values at once spilled registers.
__device__ __forceinline__ void add_rows(const uint16_t* xp, int B, int H, int r0, int u0, int lane, int n8,
                                         float (&acc)[2][TN / 2]) {
    const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = r0 + 64 * m + 8 * hr;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                const uint32_t* src = reinterpret_cast<const uint32_t*>(xp + (size_t)row * 4 * H + g * H + u);
                const float2 v = row < B && u < H ? bf16x2_to_f32(__ldg(src)) : make_float2(0.f, 0.f);
                acc[m][(g * NB + n8) * 4 + 2 * hr] += v.x;
                acc[m][(g * NB + n8) * 4 + 2 * hr + 1] += v.y;
            }
        }
}

// acc[m] += A[64 m .. 64 m + 63] . W over the nk stages of the block's tile
// q, for the warpgroup `wg` whose turn it is.  The products of tile q start
// when the other warpgroup's of tile q - 1 are done, so the two main loops
// take turns on the tensor cores, and a warpgroup never waits on a ring slot
// more than one phase ahead of it (a wait on a later phase would pass at
// once).  W is the gate tile's weight rows, K-major.  Without PRODUCTS (a
// measuring variant) the slots are taken and given back unread.
template <bool PRODUCTS>
__device__ __forceinline__ void tile_products(const Ring& r, int q, int nk, int wg, int lane,
                                              float (&acc)[2][TN / 2]) {
    if (q > 0) mbar_wait(&r.turn[wg], ((q - 1) / 2) & 1);
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
        const int it = q * nk + kt, s = it % STAGES;
        mbar_wait(&r.full[s], (it / STAGES) & 1);
        if (PRODUCTS) {
            const uint8_t* a = r.slots + s * STAGE_BYTES;
            const uint8_t* w = a + A_BYTES;
            wgmma_fence_regs(acc[0]);
            wgmma_fence_regs(acc[1]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < TK / 16; ++kk) {
                const uint64_t dw = wgmma_desc(w + kk * 32);
                wgmma_m64n128k16(acc[0], wgmma_desc(a + kk * 32), dw);
                wgmma_m64n128k16(acc[1], wgmma_desc(a + 64 * TK * 2 + kk * 32), dw);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the previous stage's products are done
            wgmma_fence_regs(acc[0]);
            wgmma_fence_regs(acc[1]);
        }
        if (kt > 0 && lane == 0) mbar_arrive(&r.empty[prev]);
        prev = s;
    }
    if (PRODUCTS) {
        wgmma_wait<0>();
        wgmma_fence_regs(acc[0]);
        wgmma_fence_regs(acc[1]);
    }
    if (lane == 0) {
        if (nk > 0) mbar_arrive(&r.empty[prev]);
        mbar_arrive(&r.turn[1 - wg]);
    }
}

// sum += A[64 wg .. 64 wg + 63] . W over the nk stages of the block's tile
// q, where both consumer warpgroups share every tile, 64 rows each, and
// multiply their halves by the same W slots, here MN-major (the backward's
// dh/demb product: two boxes of 64 k-rows x 64 columns, 8 KB apart, read by
// wgmma's transposed-B form; the ring's slots have eight readers).  Each
// 64-wide K stage accumulates in the tensor cores apart, from zero
// (scale_d = 0), and is added to `sum` by f32 adds.  Why: the tensor cores
// add a wgmma's products into their f32 accumulator at their own precision,
// not as an f32 add, and over K = 4H = 2048 of the backward's dh/demb
// product one accumulator drifted far enough to flip the bf16 rounding of
// 10.1 % of demb's elements against the plain version at B = 37, D = 40,
// H = 512 on an H100 (tests/test_torch_cuda.py's tile-edge test; the rule
// allows 10 %).  A warpgroup folds while the other's products of the stage
// run.  (Two chunk
// accumulators in turn, to keep a stage in flight during the fold, took 192
// registers and spilled.)
__device__ __forceinline__ void tile_products_folded(const Ring& r, int q, int nk, int wg, int lane,
                                                     float (&sum)[TN / 2]) {
    float st[TN / 2];  // the stage's tensor-core sum
    for (int kt = 0; kt < nk; ++kt) {
        const int it = q * nk + kt, s = it % STAGES;
        mbar_wait(&r.full[s], (it / STAGES) & 1);
        const uint8_t* a = r.slots + s * STAGE_BYTES + wg * (TM / 2) * TK * 2;
        const uint8_t* w = r.slots + s * STAGE_BYTES + A_BYTES;
        wgmma_fence_regs(st);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
            wgmma_m64n128k16<1>(st, wgmma_desc(a + kk * 32), wgmma_desc_mn(w + kk * 2048, W_BYTES / 2), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_regs(st);
        if (lane == 0) mbar_arrive(&r.empty[s]);
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) sum[i] += st[i];
    }
}

// A measuring store: the f32 pre-activation gates of the gate tile
// (row0, u0) that this thread holds, for the rows < n_act, into gates
// [B, 4H] (gate g of unit u at g H + u), as seeded and summed by
// tile_products.  Kernel 1 and the backward's gate launch both call it, so
// the card can show that their gates are bitwise the same (kernels 7 and 8
// store one 8-unit block at a time, store_gate_block).  It reads acc
// after the products in the STORE_GATES builds only; the builds that train
// share the seed and the products with them, so put no arithmetic on acc
// between those and this call in one kernel and not in the other.
__device__ __forceinline__ void store_gate_block(float* gates, int H, int n_act, int r0, int u0, int lane, int n8,
                                                 const float (&acc)[2][TN / 2]) {
    const int u = u0 + n8 * 8 + (lane & 3) * 2;
    if (u >= H) return;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int row = r0 + 64 * m + 8 * hr;
            if (row >= n_act) continue;
#pragma unroll
            for (int g = 0; g < 4; ++g)
                *reinterpret_cast<float2*>(gates + (size_t)row * 4 * H + g * H + u) =
                    make_float2(acc[m][(g * NB + n8) * 4 + 2 * hr], acc[m][(g * NB + n8) * 4 + 2 * hr + 1]);
        }
}

__device__ __forceinline__ void store_gate_tile(float* gates, int H, int n_act, int r0, int u0, int lane,
                                                const float (&acc)[2][TN / 2]) {
#pragma unroll
    for (int n8 = 0; n8 < NB; ++n8) store_gate_block(gates, H, n_act, r0, u0, lane, n8, acc);
}

// What the product launch writes; dg comes by its tensor map.
struct ProductArgs {
    float* dh;       // [B, H] out: dg . W_hh (t > 0)
    uint16_t* demb;  // [B, D] out: bf16(dg . W_ih), step t; none when D == 0
    int B, D, H, t;
};

// The backward's product launch of step t: [dh | demb[t]] = dg[t] . [W_hh |
// W_ih] over K = 4H, on kernel 1's ring, 128 rows x 128 output columns a
// tile, both consumer warpgroups on each tile (64 rows each), every 64-wide
// K stage folded into an f32 sum (tile_products_folded, see there why).  A
// is dg[t] (K-major); B is the gate-major weights as they are,
// [4H, H] and [4H, D]: K rows of contiguous output columns, MN-major, read
// by wgmma's transposed-B form from two TMA boxes of 64 k-rows x 64 columns
// per stage (no transposed copy).  The column tiles of dh (ceil(H / 128),
// from W_hh) and of demb (ceil(D / 128), from W_ih) are counted apart, so no
// tile straddles the two weights; columns past H or D read as zero (a box
// wholly past them is not loaded) and are not written.  Rows past the
// active prefix [0, n_act_all) (the caller's; read from thread 0) are
// computed and not written; at t == 0 only the demb tiles run (dh of step 0
// is never read).  With D = 0 (kernel 8: dh alone) there are no demb tiles
// and map_wih is never read and may be null.
__device__ __forceinline__ void product_tiles(uint8_t* smem_raw, const CUtensorMap* map_dg,
                                              const CUtensorMap* map_whh, const CUtensorMap* map_wih,
                                              const ProductArgs& p, int n_act_all) {
    const Ring r = make_ring(smem_raw, 8);
    __syncthreads();
    const int n_act = __shfl_sync(0xffffffff, n_act_all, 0);
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    const int h_tiles = (p.H + TN - 1) / TN;
    const int n_first = p.t > 0 ? 0 : h_tiles;  // the first column tile that runs
    const int col_tiles = h_tiles + (p.D + TN - 1) / TN - n_first;
    const int tiles = (n_act + TM - 1) / TM * col_tiles;
    if ((int)blockIdx.x >= tiles) return;
    const int nk = (4 * p.H + TK - 1) / TK;

    if (wg == 2) {
        setmaxnreg_dec<40>();
        if (threadIdx.x == 256) {
            tma_prefetch_map(map_dg);
            if (p.D > 0) tma_prefetch_map(map_wih);
            if (p.t > 0) tma_prefetch_map(map_whh);
            int it = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int row0 = tile / col_tiles * TM, j = tile % col_tiles + n_first;
                const bool hpart = j < h_tiles;
                const int n0 = (hpart ? j : j - h_tiles) * TN, width = hpart ? p.H : p.D;
                const CUtensorMap* map = hpart ? map_whh : map_wih;
                const bool second = n0 + TN / 2 < width;  // the second 64-column box holds a column
                for (int kt = 0; kt < nk; ++kt, ++it) {
                    const int s = it % STAGES;
                    mbar_wait(&r.empty[s], ((it / STAGES) & 1) ^ 1);
                    mbar_arrive_expect_tx(&r.full[s], A_BYTES + (second ? W_BYTES : W_BYTES / 2));
                    uint8_t* a = r.slots + s * STAGE_BYTES;
                    uint8_t* w = a + A_BYTES;
                    tma_load_3d(a, map_dg, &r.full[s], kt * TK, row0, p.t);
                    tma_load_3d(w, map, &r.full[s], n0, kt * TK, 0);
                    if (second) tma_load_3d(w + W_BYTES / 2, map, &r.full[s], n0 + TN / 2, kt * TK, 0);
                }
            }
        }
    } else {
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        // acc[4 n8 + e] holds row r0 + 8 (e/2), column n0 + 8 n8 + 2
        // (lane%4) + e%2, for r0 = row0 + 64 wg + 16 warp + lane/4
        float acc[TN / 2];
        for (int q = 0;; ++q) {  // q: the tile's place in the block's sequence
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / col_tiles * TM, j = tile % col_tiles + n_first;
            const bool hpart = j < h_tiles;
            const int n0 = (hpart ? j : j - h_tiles) * TN, width = hpart ? p.H : p.D;
            const int r0 = row0 + 64 * wg + warp * 16 + (lane >> 2);
#pragma unroll
            for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
            tile_products_folded(r, q, nk, wg, lane, acc);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = r0 + 8 * hr;
                if (row >= n_act) continue;
#pragma unroll
                for (int n8 = 0; n8 < TN / 8; ++n8) {
                    const int n = n0 + n8 * 8 + (lane & 3) * 2;  // and n + 1: H and D are even
                    if (n >= width) continue;
                    const float v0 = acc[n8 * 4 + 2 * hr], v1 = acc[n8 * 4 + 2 * hr + 1];
                    if (hpart)
                        *reinterpret_cast<float2*>(p.dh + (size_t)row * p.H + n) = make_float2(v0, v1);
                    else
                        *reinterpret_cast<uint32_t*>(p.demb + (size_t)row * p.D + n) = f32x2_to_bf16x2(v0, v1);
                }
            }
        }
    }
}

}  // namespace oket_bf16
