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
//   * the ring, its producer, the bias seed and the product loop are in
//     lstm_bf16.cuh, shared with the bf16 backward's gate launch
//     (lstm_last_bwd.cu), which so recomputes these pre-activations bit for
//     bit (the STORE_GATES variant stores them, chip_smoke.py compares),
//     and with the recurrence kernels 7 and 8 (lstm_scan.cu, D = 0);
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

#include "lstm_bf16.cuh"
#include "lstm_gates.cuh"

namespace {

using namespace oket_bf16;
using oket_lstm::f32_to_bf16;

// What a launch runs: the kernel, or for measuring it, the kernel without
// its epilogue (no loads of c or stores) or without its products, or the
// kernel that also stores its f32 pre-activation gates (to hold the
// backward's recompute to them).
enum Variant { FULL = 0, NO_EPILOGUE = 1, NO_PRODUCTS = 2, STORE_GATES = 3 };

struct StepArgs {
    const float* bias;  // [4H]
    const int* lens;    // [B], sorted descending
    float* c;           // [B, H]
    uint16_t* h_next;   // [B, H]
    uint16_t* cs_out;   // [B, H] bf16(c_t), or null
    uint16_t* last;     // [B, H], or null (every-state mode)
    float* gates;       // [B, 4H] the step's pre-activation gates (STORE_GATES), or null
    int B, D, H, t;
    int h_prev_slot;  // h_{t-1} is slot h_prev_slot of the h buffer
};

template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_last_step_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_h,
                          const __grid_constant__ CUtensorMap map_wih, const __grid_constant__ CUtensorMap map_whh,
                          const StepArgs p) {
    extern __shared__ uint8_t smem_raw[];
    const int n_act_all = active_prefix<THREADS>(p.lens, p.B, p.t);
    const Ring r = make_ring(smem_raw);
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
        if (threadIdx.x == 256)
            produce_gate_tiles(r, tiles, unit_tiles, nkx, nk, &map_x, &map_h, &map_wih, &map_whh, p.t,
                               p.h_prev_slot);
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
            seed_bias(p.bias, H, u0, lane, acc, [&](int n8, int u) {  // u and u + 1; H is even
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int hr = 0; hr < 2; ++hr) {
                        const int row = r0 + 64 * m + 8 * hr;
                        c_prev[m][hr][n8] = V != NO_EPILOGUE && t > 0 && row < n_act && u < H
                                                ? *reinterpret_cast<const float2*>(p.c + (size_t)row * H + u)
                                                : make_float2(0.f, 0.f);
                    }
            });
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int row = r0 + 64 * m + 8 * hr;
                    len[m][hr] = row < n_act ? max(p.lens[row], 1) : 0;
                }

            // the finished rows of an active tile are multiplied all the same
            tile_products<V != NO_PRODUCTS>(r, q, nk, wg, lane, acc);
            if constexpr (V == STORE_GATES) store_gate_tile(p.gates, H, n_act, r0, u0, lane, acc);
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
    if (const int e = allow_smem<lstm_last_step_kernel<V>, SMEM>()) return e;
    lstm_last_step_kernel<V><<<grid, THREADS, SMEM, stream>>>(*maps[0], *maps[1], *maps[2], *maps[3], p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One recurrence step t over rows [0, B), lengths sorted descending.  emb is
// the [L, B, D] input, h_buf an [h_slots, B, H] buffer whose slot
// h_prev_slot holds bf16(h_{t-1}); h_next (a slot of it), c, cs_out and last
// are [B, H].  Pointers are 16-byte aligned device pointers, D % 8 == H % 8
// == 0; cs_out and last may be null; grid is the number of persistent
// blocks; variant is 0 (the kernel) or, for measuring, 1 (no epilogue), 2
// (no products) or 3 (the kernel, which also stores the step's f32
// pre-activation gates of the active rows into gates [B, 4H]; null
// otherwise); the stream is a cudaStream_t.  Returns the cudaError_t of
// the launch, or -1 if the driver could not encode the tensor maps.
extern "C" int oket_lstm_last_step_bf16(const void* emb, const void* h_buf, const void* w_ih, const void* w_hh,
                                        const void* bias, const void* lens, void* c, void* h_next, void* cs_out,
                                        void* last, void* gates, int L, int B, int D, int H, int h_slots,
                                        int h_prev_slot, int t, int grid, int variant, void* stream) {
    StepArgs p;
    p.bias = static_cast<const float*>(bias);
    p.lens = static_cast<const int*>(lens);
    p.c = static_cast<float*>(c);
    p.h_next = static_cast<uint16_t*>(h_next);
    p.cs_out = static_cast<uint16_t*>(cs_out);
    p.last = static_cast<uint16_t*>(last);
    p.gates = static_cast<float*>(gates);
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
    if (variant == STORE_GATES && gates) return launch<STORE_GATES>(maps, p, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
