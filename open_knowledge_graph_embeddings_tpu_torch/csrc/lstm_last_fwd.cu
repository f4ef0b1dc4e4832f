// Length-aware fused LSTM forward, one time step per launch, bf16 in / f32 state.
//
// Replaces the TPU kernels
// open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::_fused_fwd_last
// (kernel body _fused_fwd_last_kernel :479-522) and ::_fused_fwd (kernel body
// _fused_fwd_kernel :272-302): torch gate order (i, f, g, o),
//   gates = x_t . W_ih^T + bias + bf16(h_{t-1}) . W_hh^T   (f32 accumulation)
//   c_t = f * c_{t-1} + i * g,  h_t = o * tanh(c_t)        (f32)
// and each row's output is bf16(h) at its step max(len, 1) (last-state mode,
// `last` given) or bf16(h) and bf16(c) at every step it reaches (every-state
// mode: `last` null, hs[t] and cs[t] written; the positions a row never
// reaches hold unread garbage, as on the TPU, :266-269).
//
// Bound on an H100: both products are in the kernel, 2 * (D + H) * 4H
// operations per active (row, step); at D = H = 512 that is ~4 MFLOP against
// 1 KiB of token embedding read, far above the card's ~295 FLOP/byte ridge,
// so the kernel is bound by tensor-core operations (989 TFLOP/s bf16): the
// flagship's cache chunk (B = 32768, L = 10, the synthetic set's lengths)
// needs 0.5636 ms.
//
// Design (Hopper: TMA, an mbarrier ring, wgmma, warp specialisation).  The
// TPU kernel keeps both weight matrices resident in VMEM for the whole
// recurrence; at H = 512 they are 4 MiB in bf16, far above the 227 KB of
// shared memory a block has.  So the recurrence is one launch per step
// (stream order is the grid-wide barrier between steps) and the weights
// stream from L2, where they stay:
//   * a tile is 128 rows x 32 hidden units x the four gates: its weight
//     rows are {g H + u0 + j}, so the product's 128 columns are four gate
//     slabs of 32 units, and in wgmma's accumulator layout the thread that
//     holds column j of slab 0 holds column j of slabs 1-3 too.  The gate
//     math, the cell update, the h / cs stores and the last-state select stay
//     in the registers of one thread;
//   * warpgroup 2 gives its registers away (setmaxnreg 40; the consumers
//     take 232) and one of its threads issues the TMA loads
//     (cp.async.bulk.tensor) of each K stage of the block's tiles, in order,
//     into a ring of 6 slots guarded by a full and an empty mbarrier each.
//     A stage is 128 x 64 of A (x_t or h_{t-1}) and 128 x 64 of weights,
//     16 KB each, 128-byte swizzled;
//   * warpgroups 0 and 1 take the block's tiles in turn (ping-pong): each
//     multiplies a whole tile with wgmma.mma_async m64n128k16 (bf16 from
//     shared memory, f32 in registers, two 64-row halves, one group of
//     products kept in flight), and a turn mbarrier starts one's products
//     when the other's are done, so one warpgroup's epilogue runs while the
//     other's products keep the tensor cores busy;
//   * the tensor maps are 3-D: x over [L, B, D] read at (t, row0), h over
//     its [slots, B, H] buffer (hs in training, two slots in turns when
//     serving) at (slot of t - 1, row0), so rows past B read as zero and
//     never as the next step's rows; each weight as [4][H][K], so one box
//     holds the four gate slabs and units past H read as zero instead of the
//     next gate's rows; K tails (D = 40) read as zero too.  They are encoded
//     on the host and kept from step to step (lstm_sm90.cuh::bf16_map);
//   * the block is persistent: the grid is at most one block per SM
//     (ops/lstm_kernel.py::forward_grid) and each block walks the tiles
//     blockIdx.x, + gridDim.x, ... (the unit tile fastest, so the blocks in
//     flight share their A rows in L2);
//   * rows are sorted by descending length, so the rows active at step t are
//     a prefix [0, n_act), found by a search over the lengths that all the
//     block's threads take part in: only its row tiles are walked, and the
//     finished rows inside an active tile are computed and not written
//     (GEMM rows are independent).  At t = 0 the h half of K is skipped
//     (h_0 = 0);
//   * the bias seeds the accumulators, and c_{t-1} and the lengths are
//     loaded before the products, so their latency hides under them;
//   * h is written as bf16 (the value the next step's product consumes is
//     exactly bf16(h)), c is f32 and updated in place (a (row, unit) cell has
//     one owner per step);
//   * for training and the every-state mode, the caller passes h_next = hs[t]
//     and cs_out = cs[t]: the hs / cs residuals of the TPU forward
//     (:510-511), in bf16, which the backward (lstm_last_bwd.cu) reads.
//     Serving passes a two-slot h buffer, used in turns, and no cs_out.
// On an H100 (chip_smoke.py; numbers in PERF.md) the kernel reaches half of
// its bound at B = 32768, under half of cuDNN's packed LSTM.  Two
// warpgroups sharing one 128 x 256 tile (64 units) left the tensor cores
// idle through their epilogue; the ping-pong hides most of it.  What holds
// the kernel now: the products with the stream of tiles from L2 (32 KB per
// 2.1 MFLOP; the "no epilogue" variant), and one warpgroup's epilogue
// (the loads of c, the cell math and the h, c, cs stores of 4096 cells) runs
// a little longer than the other's products (the "no products" variant
// takes longer than "no epilogue").  Larger row tiles cut the stream but
// lengthen the epilogue; a cluster multicast of the weight tiles was slower.
// Any B; D and H multiples of 8 (TMA strides are multiples of 16 bytes; the
// wrapper checks this and the 16-byte alignment of each base pointer).

#include <cuda_bf16.h>

#include "lstm_gates.cuh"
#include "lstm_sm90.cuh"

namespace {

using namespace oket_sm90;
using oket_lstm::f32_to_bf16;

// The sigmoid from the hardware exponential and reciprocal (ex2.approx,
// rcp.approx: a few f32 ulps of error, far below the bf16 rounding of h and
// cs; the IEEE division of 1 / (1 + e) made the kernel slower).  tanh stays
// the library's: 2 sigmoid(2x) - 1 loses the relative accuracy of small
// values and raised the share of bf16 outputs unequal to the plain
// version's by half.
__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

constexpr int TM = 128;  // rows per tile
constexpr int TU = 32;   // hidden units per tile
constexpr int TN = 4 * TU;  // weight rows per tile: four gate slabs of TU units
constexpr int NB = TU / 8;  // 8-unit column blocks per gate slab
constexpr int TK = 64;   // K per stage: 128 bytes of bf16, one swizzle row
constexpr int STAGES = 6;
constexpr int A_BYTES = TM * TK * 2;  // 16 KB
constexpr int W_BYTES = TN * TK * 2;  // 16 KB
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
// the ring, its barriers, and slack to align the ring to 1024 bytes
constexpr int SMEM = STAGES * STAGE_BYTES + (2 * STAGES + 2) * 8 + 1024;
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces

// What a launch runs: the kernel, or for measuring it, the kernel without
// its epilogue (no loads of c or stores) or without its products.
enum Variant { FULL = 0, NO_EPILOGUE = 1, NO_PRODUCTS = 2 };

struct StepArgs {
    const float* bias;  // [4H]
    const int* lens;    // [B], sorted descending
    float* c;           // [B, H]
    uint16_t* h_next;   // [B, H]
    uint16_t* cs_out;   // [B, H] bf16(c_t), or null
    uint16_t* last;     // [B, H], or null (every-state mode)
    int B, D, H, t;
    int h_prev_slot;  // h_{t-1} is slot h_prev_slot of the h buffer
};

// Rows active at step t (max(len, 1) > t): a prefix [0, n), the lengths
// being sorted.  Every thread of the block takes part: each round probes
// THREADS evenly spaced rows of the interval still in doubt at once, so
// B = 32768 takes two rounds of one load per thread.
__device__ int active_rows(const int* lens, int B, int t) {
    if (t == 0) return B;
    int lo = 0, n = B;  // rows < lo are active, the first inactive row is in [lo, lo + n]
    while (n > 0) {
        const int stride = (n + THREADS - 1) / THREADS;
        const int off = threadIdx.x * stride;
        const int hits = __syncthreads_count(off < n && lens[lo + off] > t);
        if (hits == 0) break;
        lo += (hits - 1) * stride + 1;
        n = min(stride - 1, n - (hits - 1) * stride - 1);
    }
    return lo;
}

template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_last_step_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_h,
                          const __grid_constant__ CUtensorMap map_wih, const __grid_constant__ CUtensorMap map_whh,
                          const StepArgs p) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    uint64_t* turn = empty + STAGES;  // turn[w]: the other warpgroup finished a tile's products

    const int n_act_all = active_rows(p.lens, p.B, p.t);
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4);  // the four warps of the warpgroup that read the slot
        }
        mbar_init(&turn[0], 4);
        mbar_init(&turn[1], 4);
        mbar_fence_init();
    }
    __syncthreads();
    // block-uniform values made warp-uniform for the compiler (a wgmma on
    // what it takes for a divergent path is serialised)
    const int n_act = __shfl_sync(0xffffffff, n_act_all, 0);
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    const int unit_tiles = (p.H + TU - 1) / TU;
    const int tiles = (n_act + TM - 1) / TM * unit_tiles;
    if ((int)blockIdx.x >= tiles) return;
    const int nkx = (p.D + TK - 1) / TK;
    const int nk = nkx + (p.t > 0 ? (p.H + TK - 1) / TK : 0);  // h_0 = 0: no h part at t == 0

    if (wg == 2) {
        // ---- producer: one thread loads the block's tiles, in order, into the ring
        setmaxnreg_dec<40>();
        if (threadIdx.x == 256) {
            tma_prefetch_map(&map_x);
            tma_prefetch_map(&map_wih);
            if (nk > nkx) {
                tma_prefetch_map(&map_h);
                tma_prefetch_map(&map_whh);
            }
            int it = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
                for (int kt = 0; kt < nk; ++kt, ++it) {
                    const int s = it % STAGES;
                    mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                    mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
                    uint8_t* a = ring + s * STAGE_BYTES;
                    uint8_t* w = a + A_BYTES;
                    if (kt < nkx) {
                        tma_load_3d(a, &map_x, &full[s], kt * TK, row0, p.t);
                        tma_load_3d(w, &map_wih, &full[s], kt * TK, u0, 0);
                    } else {
                        tma_load_3d(a, &map_h, &full[s], (kt - nkx) * TK, row0, p.h_prev_slot);
                        tma_load_3d(w, &map_whh, &full[s], (kt - nkx) * TK, u0, 0);
                    }
                }
            }
        }
    } else {
        // ---- consumers: the block's tiles alternate between warpgroups 0 and
        // 1, so one's epilogue runs while the other's products keep the
        // tensor cores busy
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int H = p.H, t = p.t;
        // acc[m][4 (g NB + n8) + e] holds gate g of row r0 + 64 m + 8 (e/2),
        // unit u0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 16 warp + lane/4
        float acc[2][TN / 2];
        float2 c_prev[2][2][NB];
        int len[2][2];
        for (int q = wg;; q += 2) {  // q: the tile's place in the block's sequence
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
            const int r0 = row0 + warp * 16 + (lane >> 2);
            // the bias seeds the accumulators, and the cells' c_{t-1} and the
            // rows' lengths are loaded before the products, so their latency
            // hides under the main loop
#pragma unroll
            for (int n8 = 0; n8 < NB; ++n8) {
                const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1; H is even
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    const float2 b =
                        u < H ? __ldg(reinterpret_cast<const float2*>(p.bias + g * H + u)) : make_float2(0.f, 0.f);
#pragma unroll
                    for (int m = 0; m < 2; ++m) {
                        acc[m][(g * NB + n8) * 4] = acc[m][(g * NB + n8) * 4 + 2] = b.x;
                        acc[m][(g * NB + n8) * 4 + 1] = acc[m][(g * NB + n8) * 4 + 3] = b.y;
                    }
                }
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int hr = 0; hr < 2; ++hr) {
                        const int row = r0 + 64 * m + 8 * hr;
                        c_prev[m][hr][n8] = V != NO_EPILOGUE && t > 0 && row < n_act && u < H
                                                ? *reinterpret_cast<const float2*>(p.c + (size_t)row * H + u)
                                                : make_float2(0.f, 0.f);
                    }
            }
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int row = r0 + 64 * m + 8 * hr;
                    len[m][hr] = row < n_act ? max(p.lens[row], 1) : 0;
                }

            // The products of tile q start when the other warpgroup's of tile
            // q - 1 are done.  So the two main loops take turns on the tensor
            // cores, and a warpgroup never waits on a ring slot more than one
            // phase ahead of it (a wait on a later phase would pass at once).
            if (q > 0) mbar_wait(&turn[wg], ((q - 1) / 2) & 1);
            // the finished rows of an active tile are multiplied all the same
            int prev = 0;
            for (int kt = 0; kt < nk; ++kt) {
                const int it = q * nk + kt, s = it % STAGES;
                mbar_wait(&full[s], (it / STAGES) & 1);
                if (V != NO_PRODUCTS) {
                    const uint8_t* a = ring + s * STAGE_BYTES;
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
                if (kt > 0 && lane == 0) mbar_arrive(&empty[prev]);
                prev = s;
            }
            if (V != NO_PRODUCTS) {
                wgmma_wait<0>();
                wgmma_fence_regs(acc[0]);
                wgmma_fence_regs(acc[1]);
            }
            if (lane == 0) {
                if (nk > 0) mbar_arrive(&empty[prev]);
                mbar_arrive(&turn[1 - wg]);
            }
            if constexpr (V != NO_EPILOGUE) {
                // epilogue: the cell update of each (row, unit) this thread holds
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int hr = 0; hr < 2; ++hr) {
                        if (len[m][hr] <= t) continue;  // finished, or past B
                        const size_t ro = (size_t)(r0 + 64 * m + 8 * hr) * H;
                        const bool at_last = p.last && len[m][hr] == t + 1;
#pragma unroll
                        for (int n8 = 0; n8 < NB; ++n8) {
                            const int u = u0 + n8 * 8 + (lane & 3) * 2;
                            if (u >= H) continue;
                            float c_new[2];
                            uint32_t h2 = 0, cs2 = 0;
#pragma unroll
                            for (int x = 0; x < 2; ++x) {
                                const int e = 2 * hr + x;
                                const float gi = fast_sigmoid(acc[m][n8 * 4 + e]);
                                const float gf = fast_sigmoid(acc[m][(NB + n8) * 4 + e]);
                                const float gg = tanhf(acc[m][(2 * NB + n8) * 4 + e]);
                                const float go = fast_sigmoid(acc[m][(3 * NB + n8) * 4 + e]);
                                c_new[x] = gf * (x ? c_prev[m][hr][n8].y : c_prev[m][hr][n8].x) + gi * gg;
                                h2 |= (uint32_t)f32_to_bf16(go * tanhf(c_new[x])) << (16 * x);
                                cs2 |= (uint32_t)f32_to_bf16(c_new[x]) << (16 * x);
                            }
                            *reinterpret_cast<float2*>(p.c + ro + u) = make_float2(c_new[0], c_new[1]);
                            *reinterpret_cast<uint32_t*>(p.h_next + ro + u) = h2;
                            if (p.cs_out) *reinterpret_cast<uint32_t*>(p.cs_out + ro + u) = cs2;
                            if (at_last) *reinterpret_cast<uint32_t*>(p.last + ro + u) = h2;
                        }
                    }
            }
        }
    }
}

template <int V>
int launch(const CUtensorMap* const (&maps)[4], const StepArgs& p, int grid, cudaStream_t stream) {
    static bool smem_set[64] = {};  // by device: the launch's shared memory above 48 KB
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!smem_set[dev]) {
        const cudaError_t e =
            cudaFuncSetAttribute(lstm_last_step_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set[dev] = true;
    }
    lstm_last_step_kernel<V><<<grid, THREADS, SMEM, stream>>>(*maps[0], *maps[1], *maps[2], *maps[3], p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One recurrence step t over rows [0, B), lengths sorted descending.  emb is
// the [L, B, D] input, h_buf an [h_slots, B, H] buffer whose slot
// h_prev_slot holds bf16(h_{t-1}); h_next (a slot of it), c, cs_out and last
// are [B, H].  Pointers are 16-byte aligned device pointers, D % 8 == H % 8
// == 0; cs_out and last may be null; grid is the number of persistent
// blocks; variant is 0 (the kernel) or, for measuring, 1 (no epilogue) or 2
// (no products); the stream is a cudaStream_t.  Returns the cudaError_t of
// the launch, or -1 if the driver could not encode the tensor maps.
extern "C" int oket_lstm_last_step_bf16(const void* emb, const void* h_buf, const void* w_ih, const void* w_hh,
                                        const void* bias, const void* lens, void* c, void* h_next, void* cs_out,
                                        void* last, int L, int B, int D, int H, int h_slots, int h_prev_slot, int t,
                                        int grid, int variant, void* stream) {
    StepArgs p;
    p.bias = static_cast<const float*>(bias);
    p.lens = static_cast<const int*>(lens);
    p.c = static_cast<float*>(c);
    p.h_next = static_cast<uint16_t*>(h_next);
    p.cs_out = static_cast<uint16_t*>(cs_out);
    p.last = static_cast<uint16_t*>(last);
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    p.h_prev_slot = h_prev_slot;
    // x_t at (t, row0) of emb and h_{t-1} at (h_prev_slot, row0) of h_buf, in
    // 128 x 64 boxes (rows past B read as zero); each weight as [4][H][K],
    // one box holding the four gate slabs of 32 units (units past H and K
    // tails read as zero)
    static thread_local CachedMap cache[4];
    const uint64_t b = B, d = D, h = H;
    const uint32_t box_a[3] = {TK, TM, 1}, box_w[3] = {TK, TU, 4};
    const CUtensorMap* const maps[4] = {
        bf16_map(cache[0], emb, {d, b, (uint64_t)L}, box_a), bf16_map(cache[1], h_buf, {h, b, (uint64_t)h_slots}, box_a),
        bf16_map(cache[2], w_ih, {d, h, 4}, box_w), bf16_map(cache[3], w_hh, {h, h, 4}, box_w)};
    for (const CUtensorMap* m : maps)
        if (!m) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == FULL) return launch<FULL>(maps, p, grid, s);
    if (variant == NO_EPILOGUE) return launch<NO_EPILOGUE>(maps, p, grid, s);
    if (variant == NO_PRODUCTS) return launch<NO_PRODUCTS>(maps, p, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
