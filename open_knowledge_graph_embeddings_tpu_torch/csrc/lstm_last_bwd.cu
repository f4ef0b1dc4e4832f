// Backward of the length-aware fused LSTM (lstm_last_fwd.cu), bf16 operands,
// f32 carries and accumulators, in two modes.
//
// Replaces the TPU kernels
// open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::_fused_bwd_last
// (kernel body _fused_bwd_last_kernel :569-651; the cotangent is each row's
// last state, dlast [B, H]) and ::_fused_bwd (kernel body _fused_bwd_kernel
// :341-422; the cotangent is every state, dhs [L, B, H]).  The two differ only
// in where the cotangent enters.  For rows sorted by descending length, in
// reverse over t, on the rows active at t (max(len, 1) > t):
//   gates  = recomputed from x_t, bf16(h_{t-1}) = hs[t-1] and the bias by
//            kernel 1's own loop (lstm_bf16.cuh): bitwise the forward's
//   dh     = dh_carry + (len == t+1 ? dlast : 0)      (last-state mode)
//   dh     = dh_carry + dhs[t]                        (every-state mode)
//            (f32; the cotangent arrives in bf16)
//   tc     = tanh(c_t), c_t read from the bf16 residual cs[t]
//   dc     = dc_carry + dh * o * (1 - tc^2);  dc_carry <- dc * f
//   dgates = [dc*g*i*(1-i), dc*c_{t-1}*f*(1-f), dc*i*(1-g^2), dh*tc*o*(1-o)]  (f32)
//   dg     = bf16(dgates)
//   demb[t] = bf16(dg . W_ih),  dh_carry <- dg . W_hh    (f32 accumulation)
//   dW_ih += dg^T . x_t,  dW_hh += dg^T . bf16(h_{t-1}),  db += dgates (f32)
// and at the end dW is rounded to bf16.  Positions a row never reaches hold
// unread garbage in demb, as in the TPU kernel.
//
// Bound on an H100: tensor-core operations.  Per active (row, step): the gate
// recompute 2*(D+H)*4H (no h product at t == 0), demb 2*4H*D, dh 2*4H*H (from
// t = 1 on), dW_ih 2*D*4H, dW_hh 2*H*4H (from t = 1 on): ~3x the forward.
//
// Design.  The TPU kernel holds both weights and both dW accumulators in VMEM
// for its whole grid (4 MiB of bf16 weights and 8 MiB of f32 dW at H = 512);
// a block here has 227 KB of shared memory.  And one block cannot finish a
// step alone: demb and dh_carry need every gate column of a row (K = 4H),
// while the gate math needs the four gate columns of a unit together.  So a
// step is two launches, and dW a third after the loop, all with weights
// streamed from L2.  The two per-step launches have kernel 1's Hopper shape
// and loop (lstm_bf16.cuh: a persistent block, one producer thread loading
// 64-wide K stages by TMA into a 6-slot mbarrier ring, two consumer
// warpgroups taking 128-row tiles in turns with wgmma m64n128k16):
//   1. bf16::lstm_bwd_gate_kernel_bf16, per step: kernel 1's gate product on
//      its tiles (128 rows x 32 units x the four gates) and tensor maps, so
//      the recomputed pre-activations are the forward's bit for bit; then the
//      cell math above in the thread that holds the four gates; writes dg[t]
//      (bf16 [B, 4H]), updates dc_carry in place (one owner per cell), and
//      writes the tile's column sums of the f32 dgates to db_part[t][row
//      tile] (a fixed-order shuffle and shared memory sum: no atomics);
//   2. bf16::lstm_bwd_product_kernel_bf16 (lstm_bf16.cuh::product_tiles,
//      which kernel 8 runs too, with D = 0), per step: [dh_carry | demb[t]] =
//      dg[t] . [W_hh | W_ih] over K = 4H, 128 x 128 output tiles, reading the
//      gate-major weights as they are ([4H, H] and [4H, D]: K rows of
//      contiguous output columns) through wgmma's transposed-B form; both
//      consumer warpgroups share each tile and fold every K stage into an
//      f32 sum (the tensor cores' own accumulation over K = 4H flipped too
//      many bf16 roundings of demb);
//   3. lstm_bwd_dw_kernel, once (mma.sync m16n8k16): dW = sum over t of dg[t]^T . [x_t | hs[t-1]]
//      over the active rows of each step, one block per 128 x 128 tile of dW
//      that walks every (t, row chunk) in order; and db = the sum of db_part
//      over (t, active row block), each column summed by one block in a
//      fixed order.  Deterministic, no float atomics, so dW and db do not
//      wobble from run to run.
// The rows are sorted by descending length, so the rows active at step t are
// a prefix, found by a binary search over the lengths.  Inactive rows are
// never read: every load of a row past the step's active prefix is
// zero-filled.  Any B; D and H multiples of 8.
//
// The f32 mode (the *_f32 entries; the TPU kernels take their inputs' dtype)
// computes the same with the rounding points dropped: the residuals, the
// cotangent, dg, demb and dW in f32.  Every product runs on the tensor cores
// in 3xTF32: each f32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (lstm_sm90.cuh::tf32_split; 10 + 10 mantissa bits, so x is
// kept to ~2^-22), and a product sums lo.hi' + hi.lo' + hi.hi' in f32: as
// accurate as an f32 product (utils/numerics.py's f32 rule), where one TF32
// product (hi.hi' alone, the 1xTF32 variant) is not.  Bound on an H100: the
// 3xTF32 rate, a third of the tensor cores' TF32 rate (2.7x f32 FFMA's).
// Four kinds of launch:
//   0. lstm_tf32.cuh::lstm_split_kernel_tf32<true>, once per call: hi and
//      lo of W_ih and W_hh gate-major (for the gate launch) and of
//      [W_hh | W_ih]^T (for the product launch: TF32 wgmma reads only
//      K-major operands, there is no transposed form as for 16-bit types);
//   1. lstm_bwd_gate_kernel_tf32, per step: the gate loop of lstm_tf32.cuh,
//      the one the f32 forward (lstm_last_fwd_f32.cu) runs, so the gates
//      recomputed here are the forward's, summed in the same order (kernel
//      1's Hopper shape: TMA ring of 4 slots of A + W_hi + W_lo, 48 KB
//      each, one producer thread, two consumer warpgroups sharing each
//      128-row x 32-unit tile, 64 rows each, wgmma m64n128k8 TF32, A from
//      registers, read from the swizzled slot and split there, B the split
//      weights, each K chunk of 32 folded into an f32 sum); then the cell
//      math of the bf16 kernel per cell, dg[t] in f32, dc in place, db_part
//      by a fixed-order sum;
//   2. lstm_bwd_product_kernel_tf32, per step: [dh | demb[t]] = dg[t] .
//      [W_hh | W_ih] on the same ring and loop, 128 x 128 output tiles
//      (lstm_tf32.cuh::product_tiles, which kernel 8 runs too, with D = 0);
//   3. lstm_bwd_dw_kernel_tf32, once: the dW walk of the bf16 kernel with
//      mma.sync m16n8k8 TF32 fragments loaded from the k-major shared tiles
//      (wgmma would need K-major copies of dg, emb and hs: dW reduces over
//      rows), 64-row chunks through a 3-slot cp.async ring, blocks of 256
//      rows summed apart, then the same db reduction.
// No float atomics: dW and db do not change from run to run.  D and H
// multiples of 4 (TMA strides are multiples of 16 bytes); K tails, rows
// past B and units past H read as zero.  On an H100 (chip_smoke.py; numbers
// in PERF.md) the gate and product launches reach about half of their parts
// of the bound and the dW launch a third, and the whole backward runs below
// cuDNN's packed f32 LSTM backward on the training passes.

#include "lstm_bf16.cuh"
#include "lstm_gates.cuh"
#include "lstm_tf32.cuh"

namespace {

using namespace oket_lstm;

constexpr int WB = 128;       // dW tile: 128 gate columns x 128 output columns
constexpr int WLD = WB + 8;   // smem row stride of the k-major tiles

constexpr int DBC = 16;  // db columns per block and pass; NT / DBC partial sums each

struct DwArgs {
    const uint16_t* dg;     // [L, B, 4H]
    const uint16_t* x;      // [L, B, D]
    const uint16_t* hs;     // [L, B, H]
    const int* lens;        // [B], sorted descending
    const float* db_part;   // [L, ceil(B / BM), 4H]: written for the active row blocks only
    uint16_t* dw_ih;        // [4H, D]
    uint16_t* dw_hh;        // [4H, H]
    float* db;              // [4H]
    long long B;
    int D, H, L;
};

// Next (step, row chunk) of the K walk: row chunks of `chunk` over each
// step's active rows (nrows at step t), steps in order, steps with no active
// row skipped.
template <typename Args>
__device__ __forceinline__ void dw_advance(const Args& p, int chunk, int& t, int& k0, int& nrows) {
    k0 += chunk;
    while (t < p.L && k0 >= nrows) {
        ++t;
        k0 = 0;
        nrows = t < p.L ? active_rows(p.lens, p.B, t) : 0;
    }
}

// db[c] = the sum of db_part[t][rb][c] over every step t and every row block
// rb active at t (its first row is), for this block's columns: thread
// (lane = tid / DBC) sums the (t, rb) entries lane, lane + NT / DBC, ... in
// order, then one thread per column adds the partial sums in order.
template <typename Args>
__device__ void db_reduce(const Args& p) {
    __shared__ float part[NT / DBC][DBC];
    const int H4 = 4 * p.H;
    const int nrb = (int)((p.B + BM - 1) / BM);
    const int n_entries = p.L * nrb;
    const int col = threadIdx.x % DBC, lane = threadIdx.x / DBC;
    const int block = blockIdx.y * gridDim.x + blockIdx.x;
    for (int c0 = block * DBC; c0 < H4; c0 += gridDim.x * gridDim.y * DBC) {
        float s = 0.f;
        for (int e = lane; e < n_entries; e += NT / DBC) {
            const int t = e / nrb, rb = e % nrb;
            if (max(__ldg(p.lens + (size_t)rb * BM), 1) > t && c0 + col < H4)
                s += __ldg(p.db_part + ((size_t)t * nrb + rb) * H4 + c0 + col);
        }
        part[lane][col] = s;
        __syncthreads();
        if (threadIdx.x < DBC && c0 + threadIdx.x < H4) {
            float v = 0.f;
            for (int l = 0; l < NT / DBC; ++l) v += part[l][threadIdx.x];
            p.db[c0 + threadIdx.x] = v;
        }
        __syncthreads();
    }
}

__device__ __forceinline__ uint32_t pack_pair(uint16_t lo, uint16_t hi) {
    return (uint32_t)lo | ((uint32_t)hi << 16);
}

__global__ void __launch_bounds__(NT) lstm_bwd_dw_kernel(const DwArgs p) {
    __shared__ __align__(16) uint16_t As[2][BK][WLD];  // dg rows (k) x gate columns (m)
    __shared__ __align__(16) uint16_t Bs[2][BK][WLD];  // x or h rows (k) x output columns (n)

    const int H4 = 4 * p.H;
    const int nyd = (p.D + WB - 1) / WB;
    const bool hh = (int)blockIdx.y >= nyd;
    const int N = hh ? p.H : p.D;
    const int m0 = blockIdx.x * WB;
    const int n0 = (hh ? blockIdx.y - nyd : blockIdx.y) * WB;
    uint16_t* out = hh ? p.dw_hh : p.dw_ih;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;  // 4 x 32 gate columns, 2 x 64 output columns
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    db_reduce(p);

    // dW_hh pairs dg[t] with h_{t-1} = hs[t-1]: no term at t = 0 (h_0 = 0)
    auto load = [&](int t, int k0, int nrows, int s) {
        const uint16_t* a = p.dg + (size_t)t * p.B * H4;
        const uint16_t* b = hh ? p.hs + (size_t)(t - 1) * p.B * p.H : p.x + (size_t)t * p.B * p.D;
        constexpr int CH = WB / 8;  // 16-byte chunks per tile row
        for (int i = threadIdx.x; i < BK * CH; i += NT) {
            const int kr = i / CH, c = (i % CH) * 8;
            const long long row = k0 + kr;
            const uint16_t* asrc = a + (size_t)row * H4 + m0 + c;
            const bool aok = row < nrows && m0 + c < H4;
            cp_async16(&As[s][kr][c], aok ? asrc : a, aok ? 16 : 0);
            const uint16_t* bsrc = b + (size_t)row * N + n0 + c;
            const bool bok = row < nrows && n0 + c < N;
            cp_async16(&Bs[s][kr][c], bok ? bsrc : b, bok ? 16 : 0);
        }
    };

    int t = hh ? 1 : 0, k0 = -BK;
    int nrows = t < p.L ? active_rows(p.lens, p.B, t) : 0;
    dw_advance(p, BK, t, k0, nrows);
    if (t < p.L) {
        int s = 0;
        load(t, k0, nrows, s);
        cp_async_commit();
        dw_advance(p, BK, t, k0, nrows);
        while (true) {
            const bool more = t < p.L;
            if (more) load(t, k0, nrows, s ^ 1);
            cp_async_commit();
            cp_async_wait_1();
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                const int k = kk + tig * 2;
                uint32_t a[2][4], b[8][2];
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    const int m = wm * 32 + mi * 16 + gid;
                    a[mi][0] = pack_pair(As[s][k][m], As[s][k + 1][m]);
                    a[mi][1] = pack_pair(As[s][k][m + 8], As[s][k + 1][m + 8]);
                    a[mi][2] = pack_pair(As[s][k + 8][m], As[s][k + 9][m]);
                    a[mi][3] = pack_pair(As[s][k + 8][m + 8], As[s][k + 9][m + 8]);
                }
#pragma unroll
                for (int ni = 0; ni < 8; ++ni) {
                    const int n = wn * 64 + ni * 8 + gid;
                    b[ni][0] = pack_pair(Bs[s][k][n], Bs[s][k + 1][n]);
                    b[ni][1] = pack_pair(Bs[s][k + 8][n], Bs[s][k + 9][n]);
                }
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                    for (int ni = 0; ni < 8; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
            }
            __syncthreads();
            if (!more) break;
            dw_advance(p, BK, t, k0, nrows);
            s ^= 1;
        }
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = m0 + wm * 32 + mi * 16 + gid + ((e >> 1) << 3);
                const int n = n0 + wn * 64 + ni * 8 + tig * 2 + (e & 1);
                if (m < H4 && n < N) out[(size_t)m * N + n] = f32_to_bf16(acc[mi][ni][e]);
            }
}

// ------------------------------------------------- bf16 gate and product launches

namespace bf16 {

using namespace oket_bf16;

struct GateArgs16 {
    const float* bias;        // [4H]
    const int* lens;          // [B], sorted descending
    const uint16_t* cs_t;     // [B, H] bf16(c_t)
    const uint16_t* cs_prev;  // [B, H] bf16(c_{t-1}); unread at t == 0
    const uint16_t* cot;      // [B, H]: dlast, or dhs[t] in the every-state mode
    const float* dh;          // [B, H] dh carry from step t+1 (0 for rows first active at t)
    float* dc;                // [B, H] dc carry in, dc * f out
    uint16_t* dg;             // [B, 4H] bf16(dgates) of step t
    float* db_part;           // [ceil(B / TM), 4H] per-row-tile sums of the f32 dgates of step t
    float* gates;             // [B, 4H] the recomputed pre-activation gates (STORE_GATES), or null
    int every_step;           // 1: add cot at every active step (dhs[t]); 0: at len == t+1
    int B, D, H, t;
};

// What the bf16 gate entry launches (its `variant`): the kernel, or the
// kernel that also stores its f32 pre-activation gates (to hold them to
// kernel 1's, bitwise).
enum GateVariant { KERNEL = 0, STORE_GATES = 1 };

// Gate launch of step t: the forward's gate product recomputed by kernel
// 1's loop (lstm_bf16.cuh: the same tiles, tensor maps, bias seed and
// wgmma sequence, so the same f32 sums bit for bit), then in the thread
// that holds a cell's four gates the cell math (bwd_cell) from bf16 c_t,
// c_{t-1} and cotangent and the f32 dh and dc carries; writes dg[t] in
// bf16, updates dc in place (one owner per cell), and the tile's column
// sums of the f32 dgates to db_part[t][row tile] (a fixed-order shuffle and
// shared-memory sum: no atomics).  The warpgroups take the tiles in turns,
// as in kernel 1, so one's epilogue runs under the other's products.
template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_bwd_gate_kernel_bf16(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_h,
                              const __grid_constant__ CUtensorMap map_wih,
                              const __grid_constant__ CUtensorMap map_whh, const GateArgs16 p) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ float s_db[2][4][TN];  // [consumer warpgroup][warp][gate column of the tile]
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
        setmaxnreg_dec<40>();
        // x_t at (t, row0) of emb, h_{t-1} at (t - 1, row0) of hs
        if (threadIdx.x == 256)
            produce_gate_tiles(r, tiles, unit_tiles, nkx, nk, &map_x, &map_h, &map_wih, &map_whh, p.t, p.t - 1);
    } else {
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int H = p.H, t = p.t;
        // acc[m][4 (g NB + n8) + e] holds gate g of row r0 + 64 m + 8 (e/2),
        // unit u0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 16 warp + lane/4
        float acc[2][TN / 2];
        int len[2][2];
        for (int q = wg;; q += 2) {  // q: the tile's place in the block's sequence
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
            const int r0 = row0 + warp * 16 + (lane >> 2);
            seed_bias(p.bias, H, u0, lane, acc, [](int, int) {});
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int row = r0 + 64 * m + 8 * hr;
                    len[m][hr] = row < n_act ? max(p.lens[row], 1) : 0;
                }
            tile_products<true>(r, q, nk, wg, lane, acc);
            if constexpr (V == STORE_GATES) store_gate_tile(p.gates, H, n_act, r0, u0, lane, acc);

            // epilogue: the cell math of each (row, unit pair) this thread
            // holds, one 8-unit block at a time; db sums this thread's rows,
            // then this warp's 32 rows (the lanes differing in lane / 4)
#pragma unroll
            for (int n8 = 0; n8 < NB; ++n8) {
                const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1; H is even
                float dbs[4][2] = {};  // [gate][unit parity]
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int hr = 0; hr < 2; ++hr) {
                        if (len[m][hr] <= t || u >= H) continue;  // finished at t, past B or past H
                        const int row = r0 + 64 * m + 8 * hr;
                        const size_t o = (size_t)row * H + u;
                        const bool inject = p.every_step || len[m][hr] == t + 1;
                        const float2 c_t = bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(p.cs_t + o));
                        const float2 c_prev = t > 0 ? bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(p.cs_prev + o))
                                                    : make_float2(0.f, 0.f);
                        const float2 dh_in = *reinterpret_cast<const float2*>(p.dh + o);
                        const float2 cot = inject ? bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(p.cot + o))
                                                  : make_float2(0.f, 0.f);
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
                        uint16_t* dg_row = p.dg + (size_t)row * 4 * H + u;
#pragma unroll
                        for (int g = 0; g < 4; ++g) {
                            *reinterpret_cast<uint32_t*>(dg_row + (size_t)g * H) =
                                (uint32_t)f32_to_bf16(d[0][g]) | ((uint32_t)f32_to_bf16(d[1][g]) << 16);
                            dbs[g][0] += d[0][g];
                            dbs[g][1] += d[1][g];
                        }
                    }
#pragma unroll
                for (int g = 0; g < 4; ++g)
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                        float v = dbs[g][x];
                        v += __shfl_xor_sync(0xffffffffu, v, 4);
                        v += __shfl_xor_sync(0xffffffffu, v, 8);
                        v += __shfl_xor_sync(0xffffffffu, v, 16);
                        if (lane < 4) s_db[wg][warp][g * TU + n8 * 8 + lane * 2 + x] = v;
                    }
            }
            // then the warpgroup's four warps in a fixed order, one column a thread
            named_barrier(1 + wg, 128);
            const int i = threadIdx.x % 128, u = u0 + i % TU;
            if (u < H)
                p.db_part[(size_t)(row0 / TM) * 4 * H + (size_t)(i / TU) * H + u] =
                    ((s_db[wg][0][i] + s_db[wg][1][i]) + s_db[wg][2][i]) + s_db[wg][3][i];
            named_barrier(1 + wg, 128);  // s_db is read before the next tile writes it
        }
    }
}

// Product launch of step t (lstm_bf16.cuh::product_tiles) over the rows
// active at t.
__global__ void __launch_bounds__(THREADS, 1)
    lstm_bwd_product_kernel_bf16(const __grid_constant__ CUtensorMap map_dg,
                                 const __grid_constant__ CUtensorMap map_whh,
                                 const __grid_constant__ CUtensorMap map_wih, const ProductArgs p,
                                 const int* lens) {
    extern __shared__ uint8_t smem_raw[];
    product_tiles(smem_raw, &map_dg, &map_whh, &map_wih, p, active_prefix<THREADS>(lens, p.B, p.t));
}

template <int V>
int launch_gate(const CUtensorMap* const (&maps)[4], const GateArgs16& p, int grid, cudaStream_t s) {
    if (const int e = allow_smem<lstm_bwd_gate_kernel_bf16<V>, SMEM>()) return e;
    lstm_bwd_gate_kernel_bf16<V><<<grid, THREADS, SMEM, s>>>(*maps[0], *maps[1], *maps[2], *maps[3], p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace bf16

// ------------------------------------------------------------------ f32 mode

namespace tf32 {

using namespace oket_tf32;

struct Tf32GateArgs {
    const float* bias;     // [4H]
    const int* lens;       // [B], sorted descending
    const float* cs_t;     // [B, H] c_t
    const float* cs_prev;  // [B, H] c_{t-1}; unread at t == 0
    const float* cot;      // [B, H]: dlast, or dhs[t] in the every-state mode
    const float* dh;       // [B, H] dh carry from step t+1 (0 for rows first active at t)
    float* dc;             // [B, H] dc carry in, dc * f out
    float* dg;             // [B, 4H] dgates of step t
    float* db_part;        // [ceil(B / TM), 4H] per-row-tile sums of the dgates of step t
    int every_step;        // 1: add cot at every active step (dhs[t]); 0: at len == t+1
    int B, D, H, t;
};

// Gate launch of step t: the forward's gate product recomputed in 3xTF32
// for a tile of 128 rows x 32 units (x the four gates, as in kernel 1:
// the thread that holds gate 0 of a cell holds its gates 1-3 too) by the
// f32 forward's loop on the same tiles (lstm_tf32.cuh::tile_products, so
// the same sums in the same order), then the cell math of the bf16 kernel
// (bwd_cell) in that thread; writes dg[t], updates dc in place (one owner
// per cell), and the tile's column sums of dg to db_part (a fixed-order
// shuffle and shared-memory sum: no atomics).  FOLD = false keeps one
// tensor-core accumulator over all of K (for measuring what the fold buys).
template <int V, bool FOLD = true>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_bwd_gate_kernel_tf32(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_h,
                              const __grid_constant__ CUtensorMap map_wih_hi,
                              const __grid_constant__ CUtensorMap map_wih_lo,
                              const __grid_constant__ CUtensorMap map_whh_hi,
                              const __grid_constant__ CUtensorMap map_whh_lo, const Tf32GateArgs p) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ float s_db[2][4][TN];  // [consumer warpgroup][warp][gate column of the tile]
    const Ring r = make_ring(smem_raw);
    const int n_act_all = active_prefix<THREADS>(p.lens, p.B, p.t);
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
        setmaxnreg_dec<40>();
        if (threadIdx.x == 256) {
            tma_prefetch_map(&map_x);
            tma_prefetch_map(&map_wih_hi);
            tma_prefetch_map(&map_wih_lo);
            if (nk > nkx) {
                tma_prefetch_map(&map_h);
                tma_prefetch_map(&map_whh_hi);
                tma_prefetch_map(&map_whh_lo);
            }
            // x_t at (t, row0) of emb, h_{t-1} at (t - 1, row0) of hs; each
            // weight as [4][H][K], one box holding the four gate slabs
            produce(r, tiles, nk, [&](int tile, int kt, uint8_t* a, uint8_t* w_hi, uint8_t* w_lo, uint64_t* bar) {
                const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
                if (kt < nkx) {
                    tma_load_3d(a, &map_x, bar, kt * TK, row0, p.t);
                    tma_load_3d(w_hi, &map_wih_hi, bar, kt * TK, u0, 0);
                    tma_load_3d(w_lo, &map_wih_lo, bar, kt * TK, u0, 0);
                } else {
                    tma_load_3d(a, &map_h, bar, (kt - nkx) * TK, row0, p.t - 1);
                    tma_load_3d(w_hi, &map_whh_hi, bar, (kt - nkx) * TK, u0, 0);
                    tma_load_3d(w_lo, &map_whh_lo, bar, (kt - nkx) * TK, u0, 0);
                }
            });
        }
    } else {
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int H = p.H, t = p.t;
        // acc[4 (g NB + n8) + e] holds gate g of row r0 + 8 (e/2), unit
        // u0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 64 wg + 16 warp + lane/4
        float acc[TN / 2];
        for (int q = 0;; ++q) {  // q: the tile's place in the block's sequence
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
            const int r0 = row0 + 64 * wg + warp * 16 + (lane >> 2);
            seed_bias(p.bias, H, u0, lane, acc);  // the bias seeds the sum
            tile_products<V, FOLD>(r, q, nk, wg, warp, lane, acc);

            // epilogue: the cell math of each (row, unit) this thread holds
            float dbs[4][NB][2];  // [gate][n8][unit parity]: this thread's rows, in order
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
                for (int n8 = 0; n8 < NB; ++n8) dbs[g][n8][0] = dbs[g][n8][1] = 0.f;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = r0 + 8 * hr;
                if (row >= n_act) continue;  // finished at t, or past B
                const bool inject = p.every_step || max(p.lens[row], 1) == t + 1;
                const size_t ro = (size_t)row * H;
#pragma unroll
                for (int n8 = 0; n8 < NB; ++n8) {
                    const int u = u0 + n8 * 8 + (lane & 3) * 2;
                    if (u >= H) continue;
                    const float2 c_t = *reinterpret_cast<const float2*>(p.cs_t + ro + u);
                    const float2 c_prev =
                        t > 0 ? *reinterpret_cast<const float2*>(p.cs_prev + ro + u) : make_float2(0.f, 0.f);
                    const float2 dh_in = *reinterpret_cast<const float2*>(p.dh + ro + u);
                    const float2 cot =
                        inject ? *reinterpret_cast<const float2*>(p.cot + ro + u) : make_float2(0.f, 0.f);
                    float2* dc = reinterpret_cast<float2*>(p.dc + ro + u);
                    const float2 dc_in = *dc;
                    float d[2][4], dc_out[2];
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                        const int e = 2 * hr + x;
                        const float pre[4] = {acc[n8 * 4 + e], acc[(NB + n8) * 4 + e], acc[(2 * NB + n8) * 4 + e],
                                              acc[(3 * NB + n8) * 4 + e]};
                        dc_out[x] = bwd_cell(pre, x ? c_t.y : c_t.x, x ? c_prev.y : c_prev.x,
                                             x ? dh_in.y + cot.y : dh_in.x + cot.x, x ? dc_in.y : dc_in.x, d[x]);
                    }
                    *dc = make_float2(dc_out[0], dc_out[1]);
                    float* dg_row = p.dg + (size_t)row * 4 * H + u;
#pragma unroll
                    for (int g = 0; g < 4; ++g) {
                        *reinterpret_cast<float2*>(dg_row + (size_t)g * H) = make_float2(d[0][g], d[1][g]);
                        dbs[g][n8][0] += d[0][g];
                        dbs[g][n8][1] += d[1][g];
                    }
                }
            }
            // db: this warp's 16 rows (the lanes differing in lane / 4),
            // then the eight consumer warps in a fixed order
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
                for (int n8 = 0; n8 < NB; ++n8)
#pragma unroll
                    for (int x = 0; x < 2; ++x) {
                        float v = dbs[g][n8][x];
                        v += __shfl_xor_sync(0xffffffffu, v, 4);
                        v += __shfl_xor_sync(0xffffffffu, v, 8);
                        v += __shfl_xor_sync(0xffffffffu, v, 16);
                        if (lane < 4) s_db[wg][warp][g * TU + n8 * 8 + lane * 2 + x] = v;
                    }
            named_barrier(1, 256);
            const int i = threadIdx.x, u = u0 + i % TU;
            if (i < TN && u < H) {
                float v = 0.f;
#pragma unroll
                for (int w = 0; w < 8; ++w) v += s_db[w / 4][w % 4][i];
                p.db_part[(size_t)(row0 / TM) * 4 * H + (size_t)(i / TU) * H + u] = v;
            }
            named_barrier(1, 256);  // s_db is read before the next tile writes it
        }
    }
}

// Product launch of step t (lstm_tf32.cuh::product_tiles) over the rows
// active at t.
template <int V, bool FOLD = true>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_bwd_product_kernel_tf32(const __grid_constant__ CUtensorMap map_dg,
                                 const __grid_constant__ CUtensorMap map_wt_hi,
                                 const __grid_constant__ CUtensorMap map_wt_lo, const ProductArgs p,
                                 const int* lens) {
    extern __shared__ uint8_t smem_raw[];
    product_tiles<V, FOLD>(smem_raw, &map_dg, &map_wt_hi, &map_wt_lo, p, active_prefix<THREADS>(lens, p.B, p.t));
}

// What the f32 entries launch (their `variant`): the kernel; one TF32
// product (hi.hi' alone), the planted check; or one tensor-core
// accumulator over all of K in the gate and product launches (no fold).
enum BackwardVariant { KERNEL = 0, ONE_TF32 = 1, UNFOLDED = 2 };

template <int V, bool FOLD>
int launch_gate(const CUtensorMap* const (&maps)[6], const Tf32GateArgs& p, int grid, cudaStream_t s) {
    if (const int e = allow_smem<lstm_bwd_gate_kernel_tf32<V, FOLD>, SMEM>()) return e;
    lstm_bwd_gate_kernel_tf32<V, FOLD>
        <<<grid, THREADS, SMEM, s>>>(*maps[0], *maps[1], *maps[2], *maps[3], *maps[4], *maps[5], p);
    return static_cast<int>(cudaGetLastError());
}

template <int V, bool FOLD>
int launch_product(const CUtensorMap* const (&maps)[3], const ProductArgs& p, const int* lens, int grid,
                   cudaStream_t s) {
    if (const int e = allow_smem<lstm_bwd_product_kernel_tf32<V, FOLD>, SMEM>()) return e;
    lstm_bwd_product_kernel_tf32<V, FOLD><<<grid, THREADS, SMEM, s>>>(*maps[0], *maps[1], *maps[2], p, lens);
    return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int DBK = 64;       // dW rows per chunk: eight k8 steps between barriers
constexpr int DSTAGES = 3;    // chunks in the cp.async ring: two in flight while one is multiplied
constexpr int DLD = WB + 8;   // smem row stride: 136 = 8 mod 32, so a fragment load (k = lane%4, + 4;
                              // column lane/4, + 8) reads 32 distinct banks
constexpr int DW_SMEM = DSTAGES * 2 * DBK * DLD * 4;  // 204 KB: the ring of dg and x / h tiles
// dW sums over every active (row, step), 26636 terms on the flagship's entity
// pass: one f32 accumulator taking them in turn drifted from the plain
// version's per-step products by 1.2e-5 of max|dW| on an H100, too near the
// f32 rule's limit.  So the kernel sums blocks of DW_BLOCK chunks (256 rows)
// apart and adds the block sums into a second accumulator.
constexpr int DW_BLOCK = 256 / DBK;

struct Tf32DwArgs {
    const float* dg;       // [L, B, 4H]
    const float* x;        // [L, B, D]
    const float* hs;       // [L, B, H]
    const int* lens;       // [B], sorted descending
    const float* db_part;  // [L, ceil(B / BM), 4H]: written for the active row tiles only
    float* dw_ih;          // [4H, D]
    float* dw_hh;          // [4H, H]
    float* db;             // [4H]
    long long B;
    int D, H, L;
};

// dW launch, once per call: dW = sum over t of dg[t]^T . [x_t | hs[t-1]]
// on mma.sync m16n8k8 in 3xTF32 (fragments read from the k-major shared
// tiles, split in registers; the correction products first), over the
// (t, row chunk) walk of lstm_bwd_dw_kernel, one block per 128 x 128 tile
// of dW, blocks of 256 rows summed apart; and db by db_reduce.  Warp
// (wm = warp % 4, wn = warp / 4) holds gate columns m0 + 32 wm + [0, 32)
// and output columns n0 + 64 wn + [0, 64).  The chunks stream through a
// ring of DSTAGES slots of 64 rows (cp.async, 16-byte copies): on an H100
// this ran faster than 16-row chunks double buffered, whose barrier every
// two k8 steps held the eight warps back.
template <int V>
__global__ void __launch_bounds__(NT) lstm_bwd_dw_kernel_tf32(const Tf32DwArgs p) {
    extern __shared__ __align__(16) float dw_smem[];
    float* As = dw_smem;                         // [DSTAGES][DBK][DLD] dg rows (k) x gate columns (m)
    float* Bs = dw_smem + DSTAGES * DBK * DLD;   // [DSTAGES][DBK][DLD] x or h rows (k) x output columns (n)

    const int H4 = 4 * p.H;
    const int nyd = (p.D + WB - 1) / WB;
    const bool hh = (int)blockIdx.y >= nyd;
    const int N = hh ? p.H : p.D;
    const int m0 = blockIdx.x * WB;
    const int n0 = (hh ? blockIdx.y - nyd : blockIdx.y) * WB;
    float* out = hh ? p.dw_hh : p.dw_ih;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    float acc[2][8][4], sum[2][8][4];  // this block of chunks; the blocks before it
    // sum += acc, acc = 0 (fixed order: the walk is the same in every thread)
    auto flush = [&]() {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    sum[mi][ni][e] += acc[mi][ni][e];
                    acc[mi][ni][e] = 0.f;
                }
    };
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = sum[mi][ni][e] = 0.f;

    db_reduce(p);

    // dW_hh pairs dg[t] with h_{t-1} = hs[t-1]: no term at t = 0 (h_0 = 0)
    auto load = [&](int t, int k0, int nrows, int s) {
        const float* a = p.dg + (size_t)t * p.B * H4;
        const float* b = hh ? p.hs + (size_t)(t - 1) * p.B * p.H : p.x + (size_t)t * p.B * p.D;
        constexpr int CH = WB / 4;  // 16-byte chunks per tile row
        for (int i = threadIdx.x; i < DBK * CH; i += NT) {
            const int kr = i / CH, c = (i % CH) * 4;
            const long long row = k0 + kr;
            const float* asrc = a + (size_t)row * H4 + m0 + c;
            const bool aok = row < nrows && m0 + c < H4;
            cp_async16(As + (s * DBK + kr) * DLD + c, aok ? asrc : a, aok ? 16 : 0);
            const float* bsrc = b + (size_t)row * N + n0 + c;
            const bool bok = row < nrows && n0 + c < N;
            cp_async16(Bs + (s * DBK + kr) * DLD + c, bok ? bsrc : b, bok ? 16 : 0);
        }
    };

    // the loads walk DSTAGES - 1 chunks ahead of the products; rows past a
    // step's active prefix are zero-filled, so the products need no walk
    int t = hh ? 1 : 0, k0 = -DBK;
    int nrows = t < p.L ? active_rows(p.lens, p.B, t) : 0;
    dw_advance(p, DBK, t, k0, nrows);
    int loaded = 0;
    for (int s = 0; s < DSTAGES - 1; ++s) {
        if (t < p.L) {
            load(t, k0, nrows, s);
            ++loaded;
            dw_advance(p, DBK, t, k0, nrows);
        }
        cp_async_commit();
    }
    for (int chunk = 0; chunk < loaded; ++chunk) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(DSTAGES - 2));
        __syncthreads();  // the chunk has landed, and every warp is done with the slot loaded next
        if (t < p.L) {
            load(t, k0, nrows, (chunk + DSTAGES - 1) % DSTAGES);
            ++loaded;
            dw_advance(p, DBK, t, k0, nrows);
        }
        cp_async_commit();
        const float* A = As + (chunk % DSTAGES) * DBK * DLD;
        const float* Bt = Bs + (chunk % DSTAGES) * DBK * DLD;
#pragma unroll
        for (int kk = 0; kk < DBK; kk += 8) {
            uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int m = wm * 32 + mi * 16 + gid;
                tf32_split(A[(kk + tig) * DLD + m], a_hi[mi][0], a_lo[mi][0]);
                tf32_split(A[(kk + tig) * DLD + m + 8], a_hi[mi][1], a_lo[mi][1]);
                tf32_split(A[(kk + tig + 4) * DLD + m], a_hi[mi][2], a_lo[mi][2]);
                tf32_split(A[(kk + tig + 4) * DLD + m + 8], a_hi[mi][3], a_lo[mi][3]);
            }
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                const int n = wn * 64 + ni * 8 + gid;
                uint32_t b_hi[2], b_lo[2];
                tf32_split(Bt[(kk + tig) * DLD + n], b_hi[0], b_lo[0]);
                tf32_split(Bt[(kk + tig + 4) * DLD + n], b_hi[1], b_lo[1]);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    if (V == X3) {
                        mma_tf32(acc[mi][ni], a_lo[mi], b_hi);
                        mma_tf32(acc[mi][ni], a_hi[mi], b_lo);
                    }
                    mma_tf32(acc[mi][ni], a_hi[mi], b_hi);
                }
            }
        }
        if ((chunk + 1) % DW_BLOCK == 0) flush();
    }
    flush();

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = m0 + wm * 32 + mi * 16 + gid + ((e >> 1) << 3);
                const int n = n0 + wn * 64 + ni * 8 + tig * 2 + (e & 1);
                if (m < H4 && n < N) out[(size_t)m * N + n] = sum[mi][ni][e];
            }
}

}  // namespace tf32

}  // namespace

// The bf16 entries: emb [L, B, D], hs and cs [L, B, H], the cotangent
// (dlast [B, H] or dhs[t]), weights, dg [L, B, 4H], demb and dW in bf16;
// lens int32, bias, dh, dc, db_part and db f32.  D % 8 == H % 8 == 0 (TMA
// strides are multiples of 16 bytes), every pointer 16-byte aligned (the
// bias 8-byte); grid is the number of persistent blocks.  Each returns the
// cudaError_t of its launch, or -1 if the driver could not encode the
// tensor maps.

// Step t, part 1: the gate recompute and the cell math.  cs_t, cs_prev and
// cot are [B, H] (cs[t], cs[t-1] (unread at t == 0), dlast or dhs[t]);
// every_step = 0: cot enters at each row's last step, 1: at every active
// step.  variant is 0 (the kernel) or 1 (the kernel, which also stores the
// recomputed f32 pre-activation gates of the active rows into gates
// [B, 4H]; null otherwise).
extern "C" int oket_lstm_bwd_gate_bf16(const void* emb, const void* hs, const void* w_ih, const void* w_hh,
                                       const void* bias, const void* lens, const void* cs_t, const void* cs_prev,
                                       const void* cot, int every_step, const void* dh, void* dc, void* dg,
                                       void* db_part, void* gates, int L, int B, int D, int H, int t, int grid,
                                       int variant, void* stream) {
    using namespace bf16;
    GateArgs16 p;
    p.bias = static_cast<const float*>(bias);
    p.lens = static_cast<const int*>(lens);
    p.cs_t = static_cast<const uint16_t*>(cs_t);
    p.cs_prev = static_cast<const uint16_t*>(cs_prev);
    p.cot = static_cast<const uint16_t*>(cot);
    p.dh = static_cast<const float*>(dh);
    p.dc = static_cast<float*>(dc);
    p.dg = static_cast<uint16_t*>(dg);
    p.db_part = static_cast<float*>(db_part);
    p.gates = static_cast<float*>(gates);
    p.every_step = every_step;
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    // kernel 1's maps in training: x_t at (t, row0) of emb, h_{t-1} at
    // (t - 1, row0) of hs, in 128 x 64 boxes (rows past B read as zero);
    // each weight as [4][H][K], one box holding the four gate slabs of 32
    // units (units past H and K tails read as zero)
    static thread_local oket_sm90::CachedMap cache[4];
    const uint64_t b = B, d = D, h = H, l = L;
    const uint32_t box_a[3] = {TK, TM, 1}, box_w[3] = {TK, TU, 4};
    const CUtensorMap* const maps[4] = {
        oket_sm90::bf16_map(cache[0], emb, {d, b, l}, box_a), oket_sm90::bf16_map(cache[1], hs, {h, b, l}, box_a),
        oket_sm90::bf16_map(cache[2], w_ih, {d, h, 4}, box_w), oket_sm90::bf16_map(cache[3], w_hh, {h, h, 4}, box_w)};
    for (const CUtensorMap* m : maps)
        if (!m) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == KERNEL) return launch_gate<KERNEL>(maps, p, grid, s);
    if (variant == STORE_GATES && gates) return launch_gate<STORE_GATES>(maps, p, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Step t, part 2: [dh | demb[t]] = dg[t] . [W_hh | W_ih]; dg is [L, B, 4H].
extern "C" int oket_lstm_bwd_product_bf16(const void* dg, const void* w_hh, const void* w_ih, const void* lens,
                                          void* dh, void* demb, int L, int B, int D, int H, int t, int grid,
                                          void* stream) {
    using namespace bf16;
    ProductArgs p;
    p.dh = static_cast<float*>(dh);
    p.demb = static_cast<uint16_t*>(demb);
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    // dg[t] in 128 x 64 boxes; each weight as it is, [4H] rows (K) of
    // contiguous columns, in boxes of 64 columns x 64 k-rows (columns past H
    // or D and K tails read as zero)
    static thread_local oket_sm90::CachedMap cache[3];
    const uint64_t k = 4 * (uint64_t)H;
    const uint32_t box_a[3] = {TK, TM, 1}, box_w[3] = {TN / 2, TK, 1};
    const CUtensorMap* const maps[3] = {
        oket_sm90::bf16_map(cache[0], dg, {k, (uint64_t)B, (uint64_t)L}, box_a),
        oket_sm90::bf16_map(cache[1], w_hh, {(uint64_t)H, k, 1}, box_w),
        oket_sm90::bf16_map(cache[2], w_ih, {(uint64_t)D, k, 1}, box_w)};
    for (const CUtensorMap* m : maps)
        if (!m) return -1;
    if (const int e = allow_smem<lstm_bwd_product_kernel_bf16, SMEM>()) return e;
    lstm_bwd_product_kernel_bf16<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
        *maps[0], *maps[1], *maps[2], p, static_cast<const int*>(lens));
    return static_cast<int>(cudaGetLastError());
}

// After the loop: dW_ih [4H, D] and dW_hh [4H, H] in bf16, db [4H] in f32.
extern "C" int oket_lstm_bwd_dw_bf16(const void* dg, const void* x, const void* hs, const void* lens,
                                     const void* db_part, void* dw_ih, void* dw_hh, void* db, long long B,
                                     int D, int H, int L, void* stream) {
    DwArgs p;
    p.dg = static_cast<const uint16_t*>(dg);
    p.x = static_cast<const uint16_t*>(x);
    p.hs = static_cast<const uint16_t*>(hs);
    p.lens = static_cast<const int*>(lens);
    p.db_part = static_cast<const float*>(db_part);
    p.dw_ih = static_cast<uint16_t*>(dw_ih);
    p.dw_hh = static_cast<uint16_t*>(dw_hh);
    p.db = static_cast<float*>(db);
    p.B = B;
    p.D = D;
    p.H = H;
    p.L = L;
    const dim3 grid((unsigned)((4 * H + WB - 1) / WB), (unsigned)((D + WB - 1) / WB + (H + WB - 1) / WB));
    lstm_bwd_dw_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}


// The f32 mode (3xTF32): emb [L, B, D], hs and cs [L, B, H], the cotangent
// (dlast [B, H] or dhs[t]), weights, dg [L, B, 4H], demb and dW in f32;
// lens int32, bias, dh, dc, db_part and db f32, as in the bf16 entries.
// D % 4 == H % 4 == 0 (TMA strides are multiples of 16 bytes) and every
// pointer 16-byte aligned.  w_split is the split launch's output (4 (H + D)
// 4H floats); variant is 0 (3xTF32), 1 (1xTF32, the planted check) or 2
// (one accumulator over K in the gate and product launches); grid is the
// number of persistent blocks.  Returns the cudaError_t of the
// launch, or -1 if the driver could not encode the tensor maps.

// Once per backward call, before the steps: split W_ih and W_hh into w_split.
extern "C" int oket_lstm_bwd_split_f32(const void* w_ih, const void* w_hh, void* w_split, int D, int H,
                                       void* stream) {
    return oket_tf32::launch_split<true>(w_ih, w_hh, w_split, D, H, stream);
}

// Step t, part 1: the gate recompute and the cell math.  cs_t, cs_prev and
// cot are [B, H] (cs[t], cs[t-1] (unread at t == 0), dlast or dhs[t]).
extern "C" int oket_lstm_bwd_gate_f32(const void* emb, const void* hs, const void* w_split, const void* bias,
                                      const void* lens, const void* cs_t, const void* cs_prev, const void* cot,
                                      int every_step, const void* dh, void* dc, void* dg, void* db_part, int L,
                                      int B, int D, int H, int t, int grid, int variant, void* stream) {
    using namespace tf32;
    Tf32GateArgs p;
    p.bias = static_cast<const float*>(bias);
    p.lens = static_cast<const int*>(lens);
    p.cs_t = static_cast<const float*>(cs_t);
    p.cs_prev = static_cast<const float*>(cs_prev);
    p.cot = static_cast<const float*>(cot);
    p.dh = static_cast<const float*>(dh);
    p.dc = static_cast<float*>(dc);
    p.dg = static_cast<float*>(dg);
    p.db_part = static_cast<float*>(db_part);
    p.every_step = every_step;
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    // x_t and h_{t-1} in 128 x 32 boxes (rows past B read as zero); each
    // weight part as [4][H][K], one box holding the four gate slabs of 32
    // units (units past H and K tails read as zero)
    static thread_local oket_sm90::CachedMap cache[6];
    const SplitWeights w = split_parts(w_split, D, H);
    const uint64_t b = B, d = D, h = H, l = L;
    const uint32_t box_a[3] = {TK, TM, 1}, box_w[3] = {TK, TU, 4};
    const CUtensorMap* const maps[6] = {
        oket_sm90::f32_map(cache[0], emb, {d, b, l}, box_a),   oket_sm90::f32_map(cache[1], hs, {h, b, l}, box_a),
        oket_sm90::f32_map(cache[2], w.wih_hi, {d, h, 4}, box_w), oket_sm90::f32_map(cache[3], w.wih_lo, {d, h, 4}, box_w),
        oket_sm90::f32_map(cache[4], w.whh_hi, {h, h, 4}, box_w), oket_sm90::f32_map(cache[5], w.whh_lo, {h, h, 4}, box_w)};
    for (const CUtensorMap* m : maps)
        if (!m) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == KERNEL) return launch_gate<X3, true>(maps, p, grid, s);
    if (variant == ONE_TF32) return launch_gate<X1, true>(maps, p, grid, s);
    if (variant == UNFOLDED) return launch_gate<X3, false>(maps, p, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Step t, part 2: [dh | demb[t]] = dg[t] . [W_hh | W_ih]; dg is [L, B, 4H].
extern "C" int oket_lstm_bwd_product_f32(const void* dg, const void* w_split, const void* lens, void* dh, void* demb,
                                         int L, int B, int D, int H, int t, int grid, int variant, void* stream) {
    using namespace tf32;
    oket_tf32::ProductArgs p;
    p.dh = static_cast<float*>(dh);
    p.demb = static_cast<float*>(demb);
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    // dg[t] in 128 x 32 boxes, [W_hh | W_ih]^T in 128 x 32 boxes (columns
    // past H + D and K tails read as zero)
    static thread_local oket_sm90::CachedMap cache[3];
    const SplitWeights w = split_parts(w_split, D, H);
    const uint64_t k = 4 * (uint64_t)H, n = (uint64_t)H + D;
    const uint32_t box[3] = {TK, TM, 1};
    const CUtensorMap* const maps[3] = {oket_sm90::f32_map(cache[0], dg, {k, (uint64_t)B, (uint64_t)L}, box),
                                        oket_sm90::f32_map(cache[1], w.wt_hi, {k, n, 1}, box),
                                        oket_sm90::f32_map(cache[2], w.wt_lo, {k, n, 1}, box)};
    for (const CUtensorMap* m : maps)
        if (!m) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* l = static_cast<const int*>(lens);
    if (variant == KERNEL) return launch_product<X3, true>(maps, p, l, grid, s);
    if (variant == ONE_TF32) return launch_product<X1, true>(maps, p, l, grid, s);
    if (variant == UNFOLDED) return launch_product<X3, false>(maps, p, l, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// After the loop: dW_ih [4H, D], dW_hh [4H, H] and db [4H].
extern "C" int oket_lstm_bwd_dw_f32(const void* dg, const void* x, const void* hs, const void* lens,
                                    const void* db_part, void* dw_ih, void* dw_hh, void* db, long long B, int D,
                                    int H, int L, int variant, void* stream) {
    using namespace tf32;
    Tf32DwArgs p;
    p.dg = static_cast<const float*>(dg);
    p.x = static_cast<const float*>(x);
    p.hs = static_cast<const float*>(hs);
    p.lens = static_cast<const int*>(lens);
    p.db_part = static_cast<const float*>(db_part);
    p.dw_ih = static_cast<float*>(dw_ih);
    p.dw_hh = static_cast<float*>(dw_hh);
    p.db = static_cast<float*>(db);
    p.B = B;
    p.D = D;
    p.H = H;
    p.L = L;
    const dim3 grid((unsigned)((4 * H + WB - 1) / WB), (unsigned)((D + WB - 1) / WB + (H + WB - 1) / WB));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == KERNEL || variant == UNFOLDED) {  // dW sums apart already (blocks of 256 rows)
        if (const int e = allow_smem<lstm_bwd_dw_kernel_tf32<X3>, DW_SMEM>()) return e;
        lstm_bwd_dw_kernel_tf32<X3><<<grid, NT, DW_SMEM, s>>>(p);
    } else if (variant == ONE_TF32) {
        if (const int e = allow_smem<lstm_bwd_dw_kernel_tf32<X1>, DW_SMEM>()) return e;
        lstm_bwd_dw_kernel_tf32<X1><<<grid, NT, DW_SMEM, s>>>(p);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
