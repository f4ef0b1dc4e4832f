// Recurrence-only LSTM over a precomputed input projection, forward and
// backward, in bf16 (bf16 operands, f32 cell state and carries) or f32.
//
// Replaces the TPU kernels
// open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::_lstm_fwd_pallas
// (kernel body _fwd_kernel :47-70) and ::_lstm_bwd_pallas (kernel body
// _bwd_kernel :110-165), which lstm_scan_pallas (:213-231) joins by a custom
// VJP.  Every row runs every step (no lengths), torch gate order (i, f, g, o):
//   forward, step t = 0 .. L-1:
//     gates = x_proj[t] + bf16(h_{t-1}) . W_hh^T   (x_proj in bf16 with the bias
//             already in it; bf16 operands, f32 accumulation and sum)
//     c_t = f * c_{t-1} + i * g (f32 carry),  h_t = o * tanh(c_t)
//     hs[t] = bf16(h_t),  cs[t] = bf16(c_t)
//   backward, t = L-1 .. 0:
//     gates recomputed from x_proj[t] and hs[t-1] (h_0 = c_0 = 0): bitwise
//             the forward's
//     dh = dh_carry + dhs[t],  c_t and c_{t-1} read from the bf16 cs
//     dgates as in lstm_last_bwd.cu (bwd_cell, lstm_gates.cuh)
//     dx_proj[t] = bf16(dgates),  dh_carry <- bf16(dgates) . W_hh (f32 accumulation),
//     dc_carry <- dc * f
// dW_hh = sum over t >= 1 of dx_proj[t]^T . hs[t-1] is one large product
// outside the kernels (ops/lstm_scan_kernel.py), as on the TPU (:201-206).
//
// Bound on an H100 (bf16, at chip_smoke.py::read_peaks' peaks: 1070.53
// TFLOP/s at the card's maximum SM clock, 3.35 TB/s): about even.  Per
// (row, step) from step 1 on the forward does 2 * H * 4H operations (none
// at step 0, where h_0 = 0) and moves 4H + 2H bf16 values (x_proj in, hs
// and cs out): at H = 512 that is 2 MFLOP against 6 KiB, ~340 FLOP/byte,
// just above the card's ~320 ridge (the unfused training entity pass,
// B = 5632, L = 10: 0.1039 ms by bytes).  The backward does twice the
// operations (recompute and dh) and moves 4H + 4H + 3H values (0.1986 ms
// there, by operations).
//
// Design (bf16): kernel 1's Hopper loop (lstm_bf16.cuh: a persistent block,
// one producer thread loading 64-wide K stages by TMA into a 6-slot mbarrier
// ring, two consumer warpgroups taking 128-row x 32-unit x 4-gate tiles in
// turns with wgmma m64n128k16) with D = 0: no x stages, and x_proj[t] added
// where kernel 1 seeds its bias.  One launch per step, as the TPU's grid
// steps; W_hh (2 MiB at H = 512) streams from L2.
//   * bf16::lstm_scan_step_kernel_bf16 (kernel 7), per step: the tile's h
//     stages (h_{t-1} read by a 3-D map over hs at slot t - 1; none at
//     t = 0) multiplied from zero, then its rows of x_proj[t] added in f32
//     (add_rows: the plain version's order; seeding the accumulators with
//     x_proj flipped several times more bf16 roundings), then kernel 5's
//     every-state epilogue: c f32 in place (c_{t-1} loaded before the
//     products, under them), hs[t] and cs[t] stored as bf16 pairs;
//   * bf16::lstm_scan_bwd_gate_kernel_bf16 (kernel 8, part 1), per step:
//     the same function on the same tiles and maps (scan_gate_tiles), so
//     its recomputed pre-activations are kernel 7's bit for bit (the
//     STORE_GATES variants store them; chip_smoke.py wants 0 unequal);
//     then the backward cell math in the thread that holds a cell's four
//     gates: dx_proj[t] out in bf16 pairs, the dc carry in place;
//   * bf16::lstm_scan_bwd_product_kernel_bf16 (kernel 8, part 2), from
//     step 1 on (the dh of step 0 is never read): the fused backward's
//     product launch (lstm_bf16.cuh::product_tiles) with D = 0,
//     dh_carry = dx_proj[t] . W_hh over K = 4H, W_hh read as it is by
//     wgmma's transposed B, every K stage folded into an f32 sum.
// Every row of [0, B) is active: no lengths, no search.  Rows past B, units
// past H and K tails read as zero (TMA) and are not written.  Any B; H a
// multiple of 8 (TMA strides are multiples of 16 bytes).
//
// The f32 mode (the *_f32 entries; the TPU kernels take their inputs' dtype)
// computes the same for f32 x_proj, w_hh, hs, cs, dhs and dx_proj with the
// rounding points dropped, every product f32-accurate in 3xTF32 on the
// tensor cores (each operand split into hi = tf32(x) and lo = tf32(x - hi),
// lo.hi' + hi.lo' + hi.hi' summed; lstm_tf32.cuh).  Bound on an H100: the
// 3xTF32 rate, a sixth of the bf16 rate (178.42 TFLOP/s at read_peaks'
// maximum SM clock; on the unfused training entity pass, H = 512: 0.5958 ms
// forward, 1.1916 ms backward, by operations).  Design: the bf16 design
// above, on the f32 gate loop of
// lstm_tf32.cuh (the f32 forward's persistent block of 384 threads, a
// 4-slot TMA ring of A + W_hi + W_lo, one producer thread, warpgroups 0 and
// 1 sharing each 128-row x 32-unit x 4-gate tile, 64 rows each, wgmma
// m64n128k8 TF32 with A split in registers, each 32-wide K chunk folded into
// an f32 sum), with D = 0:
//   * lstm_split_kernel_tf32, once per call: the hi and lo parts of W_hh,
//     gate-major (2 x 4 MiB at H = 512), and for kernel 8 also of W_hh^T
//     [H, 4H] (the product launch's B: TF32 wgmma reads only K-major
//     operands); W_ih has no rows at D = 0 and is never read;
//   * tf32::lstm_scan_step_kernel_tf32 (kernel 7), per step: the tile's h
//     stages (h_{t-1} by a 3-D map over hs at slot t - 1; none at t = 0)
//     multiplied from zero (tile_products), then x_proj[t] added in f32 one
//     8-unit block at a time (add_rows: the plain version's order, as in
//     bf16), then the f32 forward's every-state epilogue: c in
//     place, hs[t] and cs[t] stored as float pairs;
//   * tf32::lstm_scan_bwd_gate_kernel_tf32 (kernel 8, part 1): the same
//     function on the same maps (scan_gate_tiles), so its gates are kernel
//     7's bit for bit, then bwd_cell per cell: dx_proj[t], dc in place;
//   * tf32::lstm_scan_bwd_product_kernel_tf32 (kernel 8, part 2, from step
//     1 on): the f32 backward's product launch (lstm_tf32.cuh::product_tiles)
//     with D = 0: dh_carry = dx_proj[t] . W_hh over K = 4H, every row.
// So a forward call is L + 1 launches and a backward call 2L.  No x or W_ih
// map is made (TMA refuses a zero extent).  The epilogues run on both
// consumer warpgroups while the tensor cores wait, as in kernel 1 f32.
// H a multiple of 4.  Any other H reaches the kernels zero-padded by the
// wrapper (ops/lstm_scan_kernel.py).

#include "lstm_bf16.cuh"
#include "lstm_tf32.cuh"

namespace {

using namespace oket_lstm;

// ----------------------------------------------------------------- bf16 mode

namespace bf16 {

using namespace oket_bf16;

// What a bf16 gate launch (kernel 7, kernel 8's part 1) runs: the kernel,
// or the kernel that also stores its f32 pre-activation gates (to hold
// kernel 8's recompute to kernel 7's, bitwise).
enum Variant { KERNEL = 0, STORE_GATES = 1 };

// The gate tiles of step t, kernel 1's loop with D = 0 over every row of
// [0, B): the ring and its producer (the h stages alone, none at t = 0);
// on each consumer tile pre(r0, u0, lane) (loads to hide under the
// products), the products h_{t-1} . W_hh^T from zero (tile_products), then
// epilogue(acc, r0, u0, lane, finish_gates), which must call
// finish_gates(n8) before it reads 8-unit block n8 of acc: that adds xp =
// x_proj[t] in f32 (add_rows) and, in the STORE_GATES variant, stores the
// block's gates into gates [B, 4H].  Kernel 7 and kernel 8's gate launch
// both run this function on the same maps, so their gates are the same
// sums in the same order; `pre` must do no arithmetic on acc.
template <int V, typename Pre, typename Epilogue>
__device__ __forceinline__ void scan_gate_tiles(const CUtensorMap* map_h, const CUtensorMap* map_whh,
                                                const uint16_t* xp, float* gates, int B, int H, int t, Pre pre,
                                                Epilogue epilogue) {
    extern __shared__ uint8_t smem_raw[];
    const Ring r = make_ring(smem_raw);
    __syncthreads();
    // block-uniform made warp-uniform for the compiler (a wgmma on what it
    // takes for a divergent path is serialised)
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    const int unit_tiles = (H + TU - 1) / TU;
    const int tiles = (B + TM - 1) / TM * unit_tiles;
    if ((int)blockIdx.x >= tiles) return;
    const int nk = t > 0 ? (H + TK - 1) / TK : 0;  // h_0 = 0: nothing to multiply at t == 0

    if (wg == 2) {
        setmaxnreg_dec<40>();
        if (threadIdx.x == 256)
            produce_gate_tiles(r, tiles, unit_tiles, 0, nk, nullptr, map_h, nullptr, map_whh, t, t - 1);
    } else {
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        // acc[m][4 (g NB + n8) + e] holds gate g of row r0 + 64 m + 8 (e/2),
        // unit u0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 16 warp + lane/4
        float acc[2][TN / 2];
        for (int q = wg;; q += 2) {  // q: the tile's place in the block's sequence
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
            const int r0 = row0 + warp * 16 + (lane >> 2);
            pre(r0, u0, lane);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int i = 0; i < TN / 2; ++i) acc[m][i] = 0.f;
            tile_products<true>(r, q, nk, wg, lane, acc);
            // the gates of 8-unit block n8: x_proj added in f32 (and stored)
            auto finish_gates = [&](int n8) {
                add_rows(xp, B, H, r0, u0, lane, n8, acc);
                if constexpr (V == STORE_GATES) store_gate_block(gates, H, B, r0, u0, lane, n8, acc);
            };
            epilogue(acc, r0, u0, lane, finish_gates);
        }
    }
}

struct StepArgs {
    const uint16_t* xp;  // [B, 4H] x_proj[t]
    float* c;            // [B, H] f32 cell state, updated in place
    uint16_t* hs_t;      // [B, H] out: bf16(h_t)
    uint16_t* cs_t;      // [B, H] out: bf16(c_t)
    float* gates;        // [B, 4H] the step's pre-activation gates (STORE_GATES), or null
    int B, H, t;
};

// Kernel 7, step t: the gate tiles, then the cell update of each (row,
// unit pair) this thread holds, as kernel 5 (lstm_last_fwd.cu) writes it.
template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_scan_step_kernel_bf16(const __grid_constant__ CUtensorMap map_h,
                               const __grid_constant__ CUtensorMap map_whh, const StepArgs p) {
    const int B = p.B, H = p.H, t = p.t;
    float2 c_prev[2][2][NB];
    // the cells' c_{t-1} are loaded before the products, so their latency
    // hides under them
    auto load_c = [&](int r0, int u0, int lane) {
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) {
            const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1; H is even
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int row = r0 + 64 * m + 8 * hr;
                    c_prev[m][hr][n8] = t > 0 && row < B && u < H
                                            ? *reinterpret_cast<const float2*>(p.c + (size_t)row * H + u)
                                            : make_float2(0.f, 0.f);
                }
        }
    };
    auto cell_update = [&](const float (&acc)[2][TN / 2], int r0, int u0, int lane, auto finish_gates) {
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) {
            finish_gates(n8);
            const int u = u0 + n8 * 8 + (lane & 3) * 2;
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int row = r0 + 64 * m + 8 * hr;
                    if (row >= B || u >= H) continue;
                    const size_t ro = (size_t)row * H;
                    float c_new[2], h[2];
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                        const int e = 2 * hr + x;
                        const float gi = fast_sigmoid(acc[m][n8 * 4 + e]);
                        const float gf = fast_sigmoid(acc[m][(NB + n8) * 4 + e]);
                        const float gg = tanhf(acc[m][(2 * NB + n8) * 4 + e]);
                        const float go = fast_sigmoid(acc[m][(3 * NB + n8) * 4 + e]);
                        c_new[x] = gf * (x ? c_prev[m][hr][n8].y : c_prev[m][hr][n8].x) + gi * gg;
                        h[x] = go * tanhf(c_new[x]);
                    }
                    *reinterpret_cast<float2*>(p.c + ro + u) = make_float2(c_new[0], c_new[1]);
                    *reinterpret_cast<uint32_t*>(p.hs_t + ro + u) = f32x2_to_bf16x2(h[0], h[1]);
                    *reinterpret_cast<uint32_t*>(p.cs_t + ro + u) = f32x2_to_bf16x2(c_new[0], c_new[1]);
                }
            }
    };
    scan_gate_tiles<V>(&map_h, &map_whh, p.xp, p.gates, B, H, t, load_c, cell_update);
}

struct BwdGateArgs {
    const uint16_t* xp;       // [B, 4H] x_proj[t]
    const uint16_t* cs_t;     // [B, H] bf16(c_t)
    const uint16_t* cs_prev;  // [B, H] bf16(c_{t-1}); unread at t == 0
    const uint16_t* dhs_t;    // [B, H] the cotangent of hs[t]
    const float* dh;          // [B, H] dh carry from step t+1 (0 at t = L-1)
    float* dc;                // [B, H] dc carry in, dc * f out
    uint16_t* dxp;            // [B, 4H] out: bf16(dgates) of step t
    float* gates;             // [B, 4H] the recomputed pre-activation gates (STORE_GATES), or null
    int B, H, t;
};

// Kernel 8, part 1, step t: kernel 7's gate tiles recomputed, then the cell
// math (bwd_cell) of each (row, unit pair) this thread holds from the bf16
// c_t, c_{t-1} and dhs[t] and the f32 dh and dc carries: dx_proj[t] in
// bf16, dc in place (one owner per cell).  No db: the bias is inside
// x_proj, and its gradient is dx_proj's sum, outside.
template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_scan_bwd_gate_kernel_bf16(const __grid_constant__ CUtensorMap map_h,
                                   const __grid_constant__ CUtensorMap map_whh, const BwdGateArgs p) {
    const int B = p.B, H = p.H, t = p.t;
    auto cell_grads = [&](const float (&acc)[2][TN / 2], int r0, int u0, int lane, auto finish_gates) {
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) {
            finish_gates(n8);
            const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1; H is even
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int row = r0 + 64 * m + 8 * hr;
                    if (row >= B || u >= H) continue;
                    const size_t o = (size_t)row * H + u;
                    const float2 c_t = bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(p.cs_t + o));
                    const float2 c_prev = t > 0 ? bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(p.cs_prev + o))
                                                : make_float2(0.f, 0.f);
                    const float2 dh_in = *reinterpret_cast<const float2*>(p.dh + o);
                    const float2 cot = bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(p.dhs_t + o));
                    float2* dc = reinterpret_cast<float2*>(p.dc + o);
                    const float2 dc_in = *dc;
                    float d[2][4], dc_out[2];
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                        const int e = 2 * hr + x;
                        const float pre[4] = {acc[m][n8 * 4 + e], acc[m][(NB + n8) * 4 + e],
                                              acc[m][(2 * NB + n8) * 4 + e], acc[m][(3 * NB + n8) * 4 + e]};
                        dc_out[x] = bwd_cell(pre, x ? c_t.y : c_t.x, x ? c_prev.y : c_prev.x,
                                             x ? dh_in.y + cot.y : dh_in.x + cot.x, x ? dc_in.y : dc_in.x, d[x]);
                    }
                    *dc = make_float2(dc_out[0], dc_out[1]);
                    uint16_t* dxp_row = p.dxp + (size_t)row * 4 * H + u;
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        *reinterpret_cast<uint32_t*>(dxp_row + (size_t)g * H) = f32x2_to_bf16x2(d[0][g], d[1][g]);
                }
        }
    };
    scan_gate_tiles<V>(&map_h, &map_whh, p.xp, p.gates, B, H, t, [](int, int, int) {}, cell_grads);
}

// Kernel 8, part 2, step t > 0: dh_carry = dx_proj[t] . W_hh, every row.
__global__ void __launch_bounds__(THREADS, 1)
    lstm_scan_bwd_product_kernel_bf16(const __grid_constant__ CUtensorMap map_dg,
                                      const __grid_constant__ CUtensorMap map_whh, const ProductArgs p) {
    extern __shared__ uint8_t smem_raw[];
    product_tiles(smem_raw, &map_dg, &map_whh, nullptr, p, p.B);
}

// The gate launches' maps: h_{t-1} at (t - 1, row0) of hs [L, B, H] in
// 128 x 64 boxes (rows past B and K tails read as zero); W_hh as
// [4][H][H], one box holding the four gate slabs of 32 units (units past
// H read as zero).  Null where the driver could not encode one.
void gate_maps(oket_sm90::CachedMap (&cache)[2], const void* hs, const void* w_hh, int L, int B, int H,
               const CUtensorMap* (&maps)[2]) {
    const uint64_t b = B, h = H;
    const uint32_t box_a[3] = {TK, TM, 1}, box_w[3] = {TK, TU, 4};
    maps[0] = oket_sm90::bf16_map(cache[0], hs, {h, b, (uint64_t)L}, box_a);
    maps[1] = oket_sm90::bf16_map(cache[1], w_hh, {h, h, 4}, box_w);
}

template <auto Kernel, typename Args>
int launch(const CUtensorMap* map_a, const CUtensorMap* map_b, const Args& p, int grid, void* stream) {
    if (const int e = allow_smem<Kernel, SMEM>()) return e;
    Kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(*map_a, *map_b, p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

// ------------------------------------------------------------------ f32 mode

namespace tf32 {

using namespace oket_tf32;

// What an f32 launch runs (the C entries' `variant`): the kernel (3xTF32);
// the kernel that also stores its f32 pre-activation gates (to hold kernel
// 8's recompute to kernel 7's, bitwise); or one TF32 product (hi.hi' alone,
// the planted check that the f32 rule sees the correction products).
enum EntryVariant { KERNEL = 0, STORE_GATES = 1, ONE_TF32 = 2 };

// sum += the gate columns this thread holds in 8-unit block n8 of the gate
// tile (r0's rows, unit u0) of a precomputed input projection xp [B, 4H]
// (f32, gate g of unit u at g H + u), in tile_products' layout: sum[4 (g NB
// + n8) + e] is gate g of row r0 + 8 (e/2), unit u0 + 8 n8 + 2 (lane%4) +
// e%2.  Rows past B and units past H add 0.  H is even and xp 8-byte
// aligned, so a unit pair is one load.  After the products, as the plain
// version orders the sum; one block at a time, in the epilogue, as the bf16
// kernels do it (all 64 values at once spilled there).
__device__ __forceinline__ void add_rows(const float* xp, int B, int H, int r0, int u0, int lane, int n8,
                                         float (&sum)[TN / 2]) {
    const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + 8 * hr;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            const float2 v = row < B && u < H
                                 ? __ldg(reinterpret_cast<const float2*>(xp + (size_t)row * 4 * H + g * H + u))
                                 : make_float2(0.f, 0.f);
            sum[(g * NB + n8) * 4 + 2 * hr] += v.x;
            sum[(g * NB + n8) * 4 + 2 * hr + 1] += v.y;
        }
    }
}

// A measuring store: the f32 pre-activation gates of 8-unit block n8 that
// this thread holds, rows < B, into gates [B, 4H] (gate g of unit u at
// g H + u).
__device__ __forceinline__ void store_gate_block(float* gates, int B, int H, int r0, int u0, int lane, int n8,
                                                 const float (&sum)[TN / 2]) {
    const int u = u0 + n8 * 8 + (lane & 3) * 2;
    if (u >= H) return;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + 8 * hr;
        if (row >= B) continue;
#pragma unroll
        for (int g = 0; g < 4; ++g)
            *reinterpret_cast<float2*>(gates + (size_t)row * 4 * H + g * H + u) =
                make_float2(sum[(g * NB + n8) * 4 + 2 * hr], sum[(g * NB + n8) * 4 + 2 * hr + 1]);
    }
}

// The gate tiles of step t, the f32 gate loop with D = 0 over every row of
// [0, B): the ring and its producer (the h stages alone, none at t = 0),
// the products h_{t-1} . W_hh^T from zero (tile_products, P: X3 or X1),
// then epilogue(sum, r0, u0, lane, finish_gates), which must call
// finish_gates(n8) before it reads 8-unit block n8 of sum: that adds xp =
// x_proj[t] in f32 (add_rows) and, with STORE, stores the block's gates
// into gates [B, 4H].  Kernel 7 and kernel 8's gate launch both run this
// function on the same maps, so their gates are the same sums in the same
// order.
template <int P, bool STORE, typename Epilogue>
__device__ __forceinline__ void scan_gate_tiles(const CUtensorMap* map_h, const CUtensorMap* map_whh_hi,
                                                const CUtensorMap* map_whh_lo, const float* xp, float* gates, int B,
                                                int H, int t, Epilogue epilogue) {
    extern __shared__ uint8_t smem_raw[];
    const Ring r = make_ring(smem_raw);
    __syncthreads();
    // block-uniform made warp-uniform for the compiler (a wgmma on what it
    // takes for a divergent path is serialised)
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    const int unit_tiles = (H + TU - 1) / TU;
    const int tiles = (B + TM - 1) / TM * unit_tiles;
    if ((int)blockIdx.x >= tiles) return;
    const int nk = t > 0 ? (H + TK - 1) / TK : 0;  // h_0 = 0: nothing to multiply at t == 0

    if (wg == 2) {
        setmaxnreg_dec<40>();
        if (threadIdx.x == 256 && nk > 0) {
            tma_prefetch_map(map_h);
            tma_prefetch_map(map_whh_hi);
            tma_prefetch_map(map_whh_lo);
            // h_{t-1} at (t - 1, row0) of hs; each weight part as [4][H][H],
            // one box holding the four gate slabs of 32 units
            produce(r, tiles, nk, [&](int tile, int kt, uint8_t* a, uint8_t* w_hi, uint8_t* w_lo, uint64_t* bar) {
                const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
                tma_load_3d(a, map_h, bar, kt * TK, row0, t - 1);
                tma_load_3d(w_hi, map_whh_hi, bar, kt * TK, u0, 0);
                tma_load_3d(w_lo, map_whh_lo, bar, kt * TK, u0, 0);
            });
        }
    } else {
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        // sum[4 (g NB + n8) + e] holds gate g of row r0 + 8 (e/2), unit
        // u0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 64 wg + 16 warp + lane/4
        float sum[TN / 2];
        for (int q = 0;; ++q) {  // q: the tile's place in the block's sequence
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
            const int r0 = row0 + 64 * wg + warp * 16 + (lane >> 2);
#pragma unroll
            for (int i = 0; i < TN / 2; ++i) sum[i] = 0.f;
            tile_products<P, true>(r, q, nk, wg, warp, lane, sum);
            // the gates of 8-unit block n8: x_proj added in f32 (and stored)
            auto finish_gates = [&](int n8) {
                add_rows(xp, B, H, r0, u0, lane, n8, sum);
                if constexpr (STORE) store_gate_block(gates, B, H, r0, u0, lane, n8, sum);
            };
            epilogue(sum, r0, u0, lane, finish_gates);
        }
    }
}

struct StepArgs {
    const float* xp;  // [B, 4H] x_proj[t]
    float* c;         // [B, H] cell state, updated in place
    float* hs_t;      // [B, H] out: h_t
    float* cs_t;      // [B, H] out: c_t
    float* gates;     // [B, 4H] the step's pre-activation gates (STORE), or null
    int B, H, t;
};

// Kernel 7, step t: the gate tiles, then the cell update of each (row,
// unit pair) this thread holds, as kernel 5 f32 (lstm_last_fwd_f32.cu)
// writes it: c_{t-1} loaded in the epilogue (held across the products it
// spilled the f32 forward), the accurate sigmoidf / tanhf.
template <int P, bool STORE>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_scan_step_kernel_tf32(const __grid_constant__ CUtensorMap map_h,
                               const __grid_constant__ CUtensorMap map_whh_hi,
                               const __grid_constant__ CUtensorMap map_whh_lo, const StepArgs p) {
    const int B = p.B, H = p.H, t = p.t;
    auto cell_update = [&](const float (&sum)[TN / 2], int r0, int u0, int lane, auto finish_gates) {
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) {
            finish_gates(n8);
            const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1; H is even
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = r0 + 8 * hr;
                if (row >= B || u >= H) continue;
                const size_t o = (size_t)row * H + u;
                const float2 c_prev = t > 0 ? *reinterpret_cast<const float2*>(p.c + o) : make_float2(0.f, 0.f);
                float c_new[2], h[2];
#pragma unroll
                for (int x = 0; x < 2; ++x) {
                    const int e = 2 * hr + x;
                    const float gi = sigmoidf(sum[n8 * 4 + e]);
                    const float gf = sigmoidf(sum[(NB + n8) * 4 + e]);
                    const float gg = tanhf(sum[(2 * NB + n8) * 4 + e]);
                    const float go = sigmoidf(sum[(3 * NB + n8) * 4 + e]);
                    c_new[x] = gf * (x ? c_prev.y : c_prev.x) + gi * gg;
                    h[x] = go * tanhf(c_new[x]);
                }
                const float2 c2 = make_float2(c_new[0], c_new[1]);
                *reinterpret_cast<float2*>(p.c + o) = c2;
                *reinterpret_cast<float2*>(p.hs_t + o) = make_float2(h[0], h[1]);
                *reinterpret_cast<float2*>(p.cs_t + o) = c2;
            }
        }
    };
    scan_gate_tiles<P, STORE>(&map_h, &map_whh_hi, &map_whh_lo, p.xp, p.gates, B, H, t, cell_update);
}

struct BwdGateArgs {
    const float* xp;       // [B, 4H] x_proj[t]
    const float* cs_t;     // [B, H] c_t
    const float* cs_prev;  // [B, H] c_{t-1}; unread at t == 0
    const float* dhs_t;    // [B, H] the cotangent of hs[t]
    const float* dh;       // [B, H] dh carry from step t+1 (0 at t = L-1)
    float* dc;             // [B, H] dc carry in, dc * f out
    float* dxp;            // [B, 4H] out: dgates of step t
    float* gates;          // [B, 4H] the recomputed pre-activation gates (STORE), or null
    int B, H, t;
};

// Kernel 8, part 1, step t: kernel 7's gate tiles recomputed, then the cell
// math (bwd_cell) of each (row, unit pair) this thread holds: dx_proj[t],
// dc in place (one owner per cell).  No db: the bias is inside x_proj, and
// its gradient is dx_proj's sum, outside.
template <int P, bool STORE>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_scan_bwd_gate_kernel_tf32(const __grid_constant__ CUtensorMap map_h,
                                   const __grid_constant__ CUtensorMap map_whh_hi,
                                   const __grid_constant__ CUtensorMap map_whh_lo, const BwdGateArgs p) {
    const int B = p.B, H = p.H, t = p.t;
    auto cell_grads = [&](const float (&sum)[TN / 2], int r0, int u0, int lane, auto finish_gates) {
#pragma unroll
        for (int n8 = 0; n8 < NB; ++n8) {
            finish_gates(n8);
            const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1; H is even
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = r0 + 8 * hr;
                if (row >= B || u >= H) continue;
                const size_t o = (size_t)row * H + u;
                const float2 c_t = *reinterpret_cast<const float2*>(p.cs_t + o);
                const float2 c_prev = t > 0 ? *reinterpret_cast<const float2*>(p.cs_prev + o) : make_float2(0.f, 0.f);
                const float2 dh_in = *reinterpret_cast<const float2*>(p.dh + o);
                const float2 cot = *reinterpret_cast<const float2*>(p.dhs_t + o);
                float2* dc = reinterpret_cast<float2*>(p.dc + o);
                const float2 dc_in = *dc;
                float d[2][4], dc_out[2];
#pragma unroll
                for (int x = 0; x < 2; ++x) {
                    const int e = 2 * hr + x;
                    const float pre[4] = {sum[n8 * 4 + e], sum[(NB + n8) * 4 + e], sum[(2 * NB + n8) * 4 + e],
                                          sum[(3 * NB + n8) * 4 + e]};
                    dc_out[x] = bwd_cell(pre, x ? c_t.y : c_t.x, x ? c_prev.y : c_prev.x,
                                         x ? dh_in.y + cot.y : dh_in.x + cot.x, x ? dc_in.y : dc_in.x, d[x]);
                }
                *dc = make_float2(dc_out[0], dc_out[1]);
                float* dxp_row = p.dxp + (size_t)row * 4 * H + u;
#pragma unroll
                for (int g = 0; g < 4; ++g)
                    *reinterpret_cast<float2*>(dxp_row + (size_t)g * H) = make_float2(d[0][g], d[1][g]);
            }
        }
    };
    scan_gate_tiles<P, STORE>(&map_h, &map_whh_hi, &map_whh_lo, p.xp, p.gates, B, H, t, cell_grads);
}

// Kernel 8, part 2, step t > 0: dh_carry = dx_proj[t] . W_hh, every row.
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_scan_bwd_product_kernel_tf32(const __grid_constant__ CUtensorMap map_dg,
                                      const __grid_constant__ CUtensorMap map_wt_hi,
                                      const __grid_constant__ CUtensorMap map_wt_lo, const ProductArgs p) {
    extern __shared__ uint8_t smem_raw[];
    product_tiles<P>(smem_raw, &map_dg, &map_wt_hi, &map_wt_lo, p, p.B);
}

// The gate launches' maps: h_{t-1} at (t - 1, row0) of hs [L, B, H] in
// 128 x 32 boxes (rows past B and K tails read as zero); the hi and lo
// parts of W_hh as [4][H][H], one box holding the four gate slabs of 32
// units (units past H read as zero).  Null where cuTensorMapEncodeTiled
// could not encode one.
void gate_maps(oket_sm90::CachedMap (&cache)[3], const void* hs, const void* w_split, int L, int B, int H,
               const CUtensorMap* (&maps)[3]) {
    const SplitWeights w = split_parts(w_split, 0, H);
    const uint64_t b = B, h = H;
    const uint32_t box_a[3] = {TK, TM, 1}, box_w[3] = {TK, TU, 4};
    maps[0] = oket_sm90::f32_map(cache[0], hs, {h, b, (uint64_t)L}, box_a);
    maps[1] = oket_sm90::f32_map(cache[1], w.whh_hi, {h, h, 4}, box_w);
    maps[2] = oket_sm90::f32_map(cache[2], w.whh_lo, {h, h, 4}, box_w);
}

template <auto Kernel, typename Args>
int launch(const CUtensorMap* const* maps, const Args& p, int grid, void* stream) {
    if (const int e = allow_smem<Kernel, SMEM>()) return e;
    Kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(*maps[0], *maps[1], *maps[2], p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32

}  // namespace

// The bf16 entries: x_proj [L, B, 4H], w_hh [4H, H], hs, cs and dhs
// [L, B, H] and dx_proj [L, B, 4H] in bf16; c, dh and dc [B, H] f32.  Every
// pointer is a 16-byte aligned device pointer, H % 8 == 0; grid is the
// number of persistent blocks (ops/lstm_kernel.py::forward_grid, and
// backward_product_grid_bf16 for the product); the stream is a
// cudaStream_t.  Each returns the cudaError_t of its launch, or -1 if the
// driver could not encode the tensor maps.

// Kernel 7, step t over rows [0, B): reads x_proj[t] and hs[t-1], updates c
// in place, writes hs[t] and cs[t].  variant is 0 (the kernel) or 1 (the
// kernel, which also stores the step's f32 pre-activation gates into gates
// [B, 4H]; null otherwise).
extern "C" int oket_lstm_scan_step_bf16(const void* xp, void* hs, const void* w_hh, void* c, void* cs, void* gates,
                                        int L, int B, int H, int t, int grid, int variant, void* stream) {
    using namespace bf16;
    const size_t slice = (size_t)B * H;
    StepArgs p;
    p.xp = static_cast<const uint16_t*>(xp) + 4 * slice * t;
    p.c = static_cast<float*>(c);
    p.hs_t = static_cast<uint16_t*>(hs) + slice * t;
    p.cs_t = static_cast<uint16_t*>(cs) + slice * t;
    p.gates = static_cast<float*>(gates);
    p.B = B;
    p.H = H;
    p.t = t;
    static thread_local oket_sm90::CachedMap cache[2];
    const CUtensorMap* maps[2];
    gate_maps(cache, hs, w_hh, L, B, H, maps);
    if (!maps[0] || !maps[1]) return -1;
    if (variant == KERNEL) return launch<lstm_scan_step_kernel_bf16<KERNEL>>(maps[0], maps[1], p, grid, stream);
    if (variant == STORE_GATES && gates) return launch<lstm_scan_step_kernel_bf16<STORE_GATES>>(maps[0], maps[1], p, grid, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 8, step t, part 1 (gate recompute and cell math): reads x_proj[t],
// hs[t-1], cs[t], cs[t-1] (not at t == 0), dhs[t] and the dh carry written
// by part 2 of step t+1; writes dx_proj[t], updates dc in place.  variant
// as kernel 7's (gates: the recomputed gates of step t).
extern "C" int oket_lstm_scan_bwd_gate_bf16(const void* xp, const void* hs, const void* w_hh, const void* cs,
                                            const void* dhs, const void* dh, void* dc, void* dxp, void* gates,
                                            int L, int B, int H, int t, int grid, int variant, void* stream) {
    using namespace bf16;
    const size_t slice = (size_t)B * H;
    BwdGateArgs p;
    p.xp = static_cast<const uint16_t*>(xp) + 4 * slice * t;
    p.cs_t = static_cast<const uint16_t*>(cs) + slice * t;
    p.cs_prev = static_cast<const uint16_t*>(cs) + slice * (t > 0 ? t - 1 : 0);
    p.dhs_t = static_cast<const uint16_t*>(dhs) + slice * t;
    p.dh = static_cast<const float*>(dh);
    p.dc = static_cast<float*>(dc);
    p.dxp = static_cast<uint16_t*>(dxp) + 4 * slice * t;
    p.gates = static_cast<float*>(gates);
    p.B = B;
    p.H = H;
    p.t = t;
    static thread_local oket_sm90::CachedMap cache[2];
    const CUtensorMap* maps[2];
    gate_maps(cache, hs, w_hh, L, B, H, maps);
    if (!maps[0] || !maps[1]) return -1;
    if (variant == KERNEL) return launch<lstm_scan_bwd_gate_kernel_bf16<KERNEL>>(maps[0], maps[1], p, grid, stream);
    if (variant == STORE_GATES && gates) return launch<lstm_scan_bwd_gate_kernel_bf16<STORE_GATES>>(maps[0], maps[1], p, grid, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 8, step t > 0, part 2: the dh carry [B, H] = dx_proj[t] . W_hh, f32.
extern "C" int oket_lstm_scan_bwd_product_bf16(const void* dxp, const void* w_hh, void* dh, int L, int B, int H,
                                               int t, int grid, void* stream) {
    using namespace bf16;
    ProductArgs p;
    p.dh = static_cast<float*>(dh);
    p.demb = nullptr;
    p.B = B;
    p.D = 0;
    p.H = H;
    p.t = t;
    // dx_proj[t] in 128 x 64 boxes; W_hh as it is, [4H] rows (K) of H
    // contiguous columns, in boxes of 64 columns x 64 k-rows (columns past H
    // and K tails read as zero)
    static thread_local oket_sm90::CachedMap cache[2];
    const uint64_t k = 4 * (uint64_t)H;
    const uint32_t box_a[3] = {TK, TM, 1}, box_w[3] = {TN / 2, TK, 1};
    const CUtensorMap* const maps[2] = {oket_sm90::bf16_map(cache[0], dxp, {k, (uint64_t)B, (uint64_t)L}, box_a),
                                        oket_sm90::bf16_map(cache[1], w_hh, {(uint64_t)H, k, 1}, box_w)};
    if (!maps[0] || !maps[1]) return -1;
    return launch<lstm_scan_bwd_product_kernel_bf16>(maps[0], maps[1], p, grid, stream);
}

// The f32 entries (3xTF32): x_proj [L, B, 4H], w_hh [4H, H], hs, cs and dhs
// [L, B, H] and dx_proj [L, B, 4H] in f32; c, dh and dc [B, H] f32.  Every
// pointer is a 16-byte aligned device pointer, H % 4 == 0; w_split is the
// split launch's output (2 x 4H x H floats for the forward, 4 x 4H x H for
// the backward); grid is the number of persistent blocks
// (ops/lstm_kernel.py::forward_grid, and backward_product_grid for the
// product); variant is 0 (the kernel), 1 (the kernel, which also stores the
// step's f32 pre-activation gates into gates [B, 4H]; null otherwise; the
// product launch runs the kernel) or 2 (1xTF32: hi.hi' alone, the planted
// check); the stream is a cudaStream_t.  Each returns the cudaError_t of its
// launch, or -1 if cuTensorMapEncodeTiled could not encode the tensor maps.

// Once per call, before the steps: the hi and lo parts of w_hh [4H, H],
// gate-major, into w_split, and with transposed != 0 also of w_hh^T [H, 4H]
// after them (the product launch's B).  No W_ih (D = 0): the split's W_ih
// parts are empty and it never reads w_ih.
extern "C" int oket_lstm_scan_split_f32(const void* w_hh, void* w_split, int H, int transposed, void* stream) {
    return transposed ? oket_tf32::launch_split<true>(nullptr, w_hh, w_split, 0, H, stream)
                      : oket_tf32::launch_split<false>(nullptr, w_hh, w_split, 0, H, stream);
}

// Kernel 7, step t over rows [0, B): reads x_proj[t] and hs[t-1], updates c
// in place, writes hs[t] and cs[t].
extern "C" int oket_lstm_scan_step_f32(const void* xp, void* hs, const void* w_split, void* c, void* cs, void* gates,
                                       int L, int B, int H, int t, int grid, int variant, void* stream) {
    using namespace tf32;
    const size_t slice = (size_t)B * H;
    StepArgs p;
    p.xp = static_cast<const float*>(xp) + 4 * slice * t;
    p.c = static_cast<float*>(c);
    p.hs_t = static_cast<float*>(hs) + slice * t;
    p.cs_t = static_cast<float*>(cs) + slice * t;
    p.gates = static_cast<float*>(gates);
    p.B = B;
    p.H = H;
    p.t = t;
    static thread_local oket_sm90::CachedMap cache[3];
    const CUtensorMap* maps[3];
    gate_maps(cache, hs, w_split, L, B, H, maps);
    if (!maps[0] || !maps[1] || !maps[2]) return -1;
    if (variant == KERNEL) return launch<lstm_scan_step_kernel_tf32<X3, false>>(maps, p, grid, stream);
    if (variant == STORE_GATES && gates) return launch<lstm_scan_step_kernel_tf32<X3, true>>(maps, p, grid, stream);
    if (variant == ONE_TF32) return launch<lstm_scan_step_kernel_tf32<X1, false>>(maps, p, grid, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 8, step t, part 1 (gate recompute and cell math): reads x_proj[t],
// hs[t-1], cs[t], cs[t-1] (not at t == 0), dhs[t] and the dh carry written
// by part 2 of step t+1; writes dx_proj[t], updates dc in place.
extern "C" int oket_lstm_scan_bwd_gate_f32(const void* xp, const void* hs, const void* w_split, const void* cs,
                                           const void* dhs, const void* dh, void* dc, void* dxp, void* gates, int L,
                                           int B, int H, int t, int grid, int variant, void* stream) {
    using namespace tf32;
    const size_t slice = (size_t)B * H;
    BwdGateArgs p;
    p.xp = static_cast<const float*>(xp) + 4 * slice * t;
    p.cs_t = static_cast<const float*>(cs) + slice * t;
    p.cs_prev = static_cast<const float*>(cs) + slice * (t > 0 ? t - 1 : 0);
    p.dhs_t = static_cast<const float*>(dhs) + slice * t;
    p.dh = static_cast<const float*>(dh);
    p.dc = static_cast<float*>(dc);
    p.dxp = static_cast<float*>(dxp) + 4 * slice * t;
    p.gates = static_cast<float*>(gates);
    p.B = B;
    p.H = H;
    p.t = t;
    static thread_local oket_sm90::CachedMap cache[3];
    const CUtensorMap* maps[3];
    gate_maps(cache, hs, w_split, L, B, H, maps);
    if (!maps[0] || !maps[1] || !maps[2]) return -1;
    if (variant == KERNEL) return launch<lstm_scan_bwd_gate_kernel_tf32<X3, false>>(maps, p, grid, stream);
    if (variant == STORE_GATES && gates)
        return launch<lstm_scan_bwd_gate_kernel_tf32<X3, true>>(maps, p, grid, stream);
    if (variant == ONE_TF32) return launch<lstm_scan_bwd_gate_kernel_tf32<X1, false>>(maps, p, grid, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 8, step t > 0, part 2: the dh carry [B, H] = dx_proj[t] . W_hh.
extern "C" int oket_lstm_scan_bwd_product_f32(const void* dxp, const void* w_split, void* dh, int L, int B, int H,
                                              int t, int grid, int variant, void* stream) {
    using namespace tf32;
    oket_tf32::ProductArgs p;
    p.dh = static_cast<float*>(dh);
    p.demb = nullptr;
    p.B = B;
    p.D = 0;
    p.H = H;
    p.t = t;
    // dx_proj[t] in 128 x 32 boxes; W_hh^T [H, 4H] in 128 x 32 boxes
    // (columns past H and K tails read as zero)
    static thread_local oket_sm90::CachedMap cache[3];
    const SplitWeights w = split_parts(w_split, 0, H);
    const uint64_t k = 4 * (uint64_t)H;
    const uint32_t box[3] = {TK, TM, 1};
    const CUtensorMap* const maps[3] = {oket_sm90::f32_map(cache[0], dxp, {k, (uint64_t)B, (uint64_t)L}, box),
                                        oket_sm90::f32_map(cache[1], w.wt_hi, {k, (uint64_t)H, 1}, box),
                                        oket_sm90::f32_map(cache[2], w.wt_lo, {k, (uint64_t)H, 1}, box)};
    if (!maps[0] || !maps[1] || !maps[2]) return -1;
    if (variant == KERNEL || variant == STORE_GATES)
        return launch<lstm_scan_bwd_product_kernel_tf32<X3>>(maps, p, grid, stream);
    if (variant == ONE_TF32) return launch<lstm_scan_bwd_product_kernel_tf32<X1>>(maps, p, grid, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}
