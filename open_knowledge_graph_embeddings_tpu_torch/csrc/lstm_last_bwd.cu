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
//   gates  = recomputed from x_t, bf16(h_{t-1}) = hs[t-1] and the bias (the
//            forward's own gate product, lstm_gates.cuh)
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
// streamed from L2:
//   1. lstm_bwd_gate_kernel, per step: the forward's gate product for BM rows
//      x BN units (all four gates), then the cell math above in the thread that
//      holds the four gates; writes dg[t] (bf16 [B, 4H]), updates dc_carry in
//      place (one owner per cell), and writes the block's column sums of the
//      f32 dgates to db_part[t][row block] (a fixed-order shuffle and shared
//      memory sum: no atomics);
//   2. lstm_bwd_product_kernel (lstm_product.cuh, shared with lstm_scan.cu),
//      per step: [dh_carry | demb[t]] = dg[t] . [W_hh | W_ih] over K = 4H,
//      reading the gate-major weights as they are ([4H, H] and [4H, D]: K
//      rows of contiguous output columns) with ldmatrix.trans;
//   3. lstm_bwd_dw_kernel, once: dW = sum over t of dg[t]^T . [x_t | hs[t-1]]
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
// 3xTF32 rate, a third of the 495 TFLOP/s TF32 rate (165 TFLOP/s, 2.5x the
// 67 TFLOP/s of f32 FFMA).  Four kinds of launch:
//   0. lstm_bwd_split_kernel_tf32, once per call: hi and lo of W_ih and W_hh
//      gate-major (for the gate launch) and of [W_hh | W_ih]^T (for the
//      product launch: TF32 wgmma reads only K-major operands, there is no
//      transposed form as for 16-bit types);
//   1. lstm_bwd_gate_kernel_tf32, per step: kernel 1's Hopper shape (TMA
//      ring of 4 slots of A + W_hi + W_lo, 48 KB each, one producer thread,
//      two consumer warpgroups taking 128-row x 32-unit tiles in turns) with
//      wgmma m64n128k8 TF32, A from registers (read from the swizzled slot
//      and split there), B the split weights; then the cell math of the bf16
//      kernel per cell, dg[t] in f32, dc in place, db_part by a fixed-order
//      sum;
//   2. lstm_bwd_product_kernel_tf32, per step: [dh | demb[t]] = dg[t] .
//      [W_hh | W_ih] on the same ring and consumers, 128 x 128 output tiles;
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

#include "lstm_product.cuh"
#include "lstm_sm90.cuh"

namespace {

using namespace oket_lstm;

struct GateBwdArgs {
    GateArgs g;               // x = emb[t], h_prev = hs[t-1]
    const float* bias;        // [4H]
    const int* lens;          // [B]
    const uint16_t* cs_t;     // [B, H] bf16(c_t)
    const uint16_t* cs_prev;  // [B, H] bf16(c_{t-1}); unread at t == 0
    const uint16_t* dlast;    // [B, H]: dlast, or dhs[t] in the every-state mode
    int every_step;           // 1: add dlast at every active step (dhs[t]); 0: at len == t+1
    const float* dh;          // [B, H] dh carry from step t+1 (0 for rows first active at t)
    float* dc;                // [B, H] dc carry in, dc * f out
    uint16_t* dg;             // [B, 4H] bf16(dgates) of step t
    float* db_part;           // [gridDim.x, 4H] per-row-block sums of the f32 dgates of step t
};

__global__ void __launch_bounds__(NT) lstm_bwd_gate_kernel(const GateBwdArgs p) {
    __shared__ __align__(16) TileA As[2];
    __shared__ __align__(16) TileW Bs[2];
    __shared__ int s_len[BM];
    __shared__ float s_db[4][4 * BN];  // [row warp][gate column of the block]

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;
    const int t = p.g.t, H = p.g.H;
    if (!load_lengths(p.lens, p.g.B, row0, t, s_len)) return;

    float acc[2][4][2][4];
    gate_product(p.g, row0, j0, s_len, As, Bs, acc);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    float dbs[4][2][2];  // [gate][n8 tile][column parity]: this thread's rows
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) dbs[g][ni][0] = dbs[g][ni][1] = 0.f;

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = wm * WM + mi * 16 + gid + ((e >> 1) << 3);
                const int j = j0 + wn * WN + ni * 8 + tig * 2 + (e & 1);
                const int len = s_len[r];
                if (len <= t || j >= H) continue;
                const size_t o = (size_t)(row0 + r) * H + j;
                const float c_t = bf16_to_f32(p.cs_t[o]);
                const float c_prev = t > 0 ? bf16_to_f32(p.cs_prev[o]) : 0.f;
                const bool inject = p.every_step || len == t + 1;
                const float dh = p.dh[o] + (inject ? bf16_to_f32(p.dlast[o]) : 0.f);
                const float pre[4] = {acc[mi][0][ni][e] + p.bias[j], acc[mi][1][ni][e] + p.bias[H + j],
                                      acc[mi][2][ni][e] + p.bias[2 * H + j], acc[mi][3][ni][e] + p.bias[3 * H + j]};
                float d[4];
                p.dc[o] = bwd_cell(pre, c_t, c_prev, dh, p.dc[o], d);
                uint16_t* dg_row = p.dg + (size_t)(row0 + r) * 4 * H + j;
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    dg_row[(size_t)g * H] = f32_to_bf16(d[g]);
                    dbs[g][ni][e & 1] += d[g];
                }
            }

    // db: sum this warp's 32 rows (lanes differing in gid), then the four row
    // warps in a fixed order
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                float v = dbs[g][ni][c];
                v += __shfl_xor_sync(0xffffffffu, v, 4);
                v += __shfl_xor_sync(0xffffffffu, v, 8);
                v += __shfl_xor_sync(0xffffffffu, v, 16);
                if (gid == 0) s_db[wm][g * BN + wn * WN + ni * 8 + tig * 2 + c] = v;
            }
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * BN; i += NT) {
        const int g = i / BN, j = j0 + i % BN;
        if (j < H)
            p.db_part[(size_t)blockIdx.x * 4 * H + (size_t)g * H + j] =
                ((s_db[0][i] + s_db[1][i]) + s_db[2][i]) + s_db[3][i];
    }
}

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

// ------------------------------------------------------------------ f32 mode

namespace tf32 {

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
constexpr int SMEM = STAGES * STAGE_BYTES + (2 * STAGES + 2) * 8 + 1024;
constexpr int THREADS = 384;  // warpgroups 0 and 1 consume, warpgroup 2 produces

// What a launch computes: the kernel (3xTF32), or hi.hi' alone (1xTF32),
// planted by chip_smoke.py to show that the f32 rule sees the correction
// products.
enum Variant { X3 = 0, X1 = 1 };

// Rows active at step t (max(len, 1) > t): a prefix [0, n) of the sorted
// lengths, searched by every thread of the block at once (the search of
// lstm_last_fwd.cu): each round probes THREADS evenly spaced rows.
__device__ int active_prefix(const int* lens, int B, int t) {
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

// The ring of STAGES slots (A, W_hi, W_lo), a full and an empty mbarrier
// each, and the two consumer warpgroups' turn barriers.
struct Ring {
    uint8_t* slots;
    uint64_t* full;
    uint64_t* empty;
    uint64_t* turn;  // turn[w]: the other warpgroup finished a tile's products
};

__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw) {
    Ring r;
    r.slots = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    r.full = reinterpret_cast<uint64_t*>(r.slots + STAGES * STAGE_BYTES);
    r.empty = r.full + STAGES;
    r.turn = r.empty + STAGES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&r.full[s], 1);
            mbar_init(&r.empty[s], 4);  // the four warps of the warpgroup that read the slot
        }
        mbar_init(&r.turn[0], 4);
        mbar_init(&r.turn[1], 4);
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

// acc[m] += A[64 m .. 64 m + 63, :] . W^T over the nk stages of the block's
// tile q, in 3xTF32: per k8 step, A's fragments are read from the swizzled
// slot into registers and split there, then lo.W_hi and hi.W_lo are
// accumulated before hi.W_hi (the correction products first, as CUTLASS's
// fast-f32 product does), all into the one accumulator.  One k8 step's
// products stay in flight while the next step's fragments are split (two
// sets of fragment registers, by step parity).  The products of tile q start
// when the other warpgroup's of tile q - 1 are done.
template <int V>
__device__ __forceinline__ void tile_products(const Ring& r, int q, int nk, int wg, int warp, int lane,
                                              float (&acc)[2][TN / 2]) {
    if (q > 0) mbar_wait(&r.turn[wg], ((q - 1) / 2) & 1);
    uint32_t hi[2][2][4], lo[2][2][4];  // [k8 step parity][64-row half][fragment register]
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
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    // register i: row 16 warp + lane / 4 + 8 (i % 2), k = lane % 4 + 4 (i / 2)
                    const int row = 64 * m + 16 * warp + (lane >> 2) + 8 * (i & 1);
                    const int k = kk * 8 + (lane & 3) + 4 * (i >> 1);
                    const float x = *reinterpret_cast<const float*>(a + row * 128 + (((k >> 2) ^ (row & 7)) << 4) +
                                                                    (k & 3) * 4);
                    tf32_split(x, hi[b][m][i], lo[b][m][i]);
                }
            wgmma_fence_regs(acc[0]);
            wgmma_fence_regs(acc[1]);
            wgmma_fence();
            const uint64_t d_hi = wgmma_desc(w_hi + kk * 32), d_lo = wgmma_desc(w_lo + kk * 32);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                if (V == X3) {
                    wgmma_m64n128k8_tf32(acc[m], lo[b][m], d_hi);
                    wgmma_m64n128k8_tf32(acc[m], hi[b][m], d_lo);
                }
                wgmma_m64n128k8_tf32(acc[m], hi[b][m], d_hi);
            }
            wgmma_commit();
            wgmma_wait<1>();  // the previous k8 step's products are done
            wgmma_fence_regs(acc[0]);
            wgmma_fence_regs(acc[1]);
            // so at the first k8 step of a stage, the previous stage is read
            if (kk == 0 && kt > 0 && lane == 0) mbar_arrive(&r.empty[prev]);
        }
        prev = s;
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc[0]);
    wgmma_fence_regs(acc[1]);
    if (lane == 0) {
        if (nk > 0) mbar_arrive(&r.empty[prev]);
        mbar_arrive(&r.turn[1 - wg]);
    }
}

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
// the thread that holds gate 0 of a cell holds its gates 1-3 too), then
// the cell math of the bf16 kernel (bwd_cell) in that thread; writes dg[t],
// updates dc in place (one owner per cell), and the tile's column sums of
// dg to db_part (a fixed-order shuffle and shared-memory sum: no atomics).
template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_bwd_gate_kernel_tf32(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_h,
                              const __grid_constant__ CUtensorMap map_wih_hi,
                              const __grid_constant__ CUtensorMap map_wih_lo,
                              const __grid_constant__ CUtensorMap map_whh_hi,
                              const __grid_constant__ CUtensorMap map_whh_lo, const Tf32GateArgs p) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ float s_db[2][4][TN];  // [consumer warpgroup][warp][gate column of the tile]
    const Ring r = make_ring(smem_raw);
    const int n_act_all = active_prefix(p.lens, p.B, p.t);
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
        // acc[m][4 (g NB + n8) + e] holds gate g of row r0 + 64 m + 8 (e/2),
        // unit u0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 16 warp + lane/4
        float acc[2][TN / 2];
        for (int q = wg;; q += 2) {
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
            const int r0 = row0 + warp * 16 + (lane >> 2);
            // the bias seeds the accumulators
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
            }
            tile_products<V>(r, q, nk, wg, warp, lane, acc);

            // epilogue: the cell math of each (row, unit) this thread holds
            float dbs[4][NB][2];  // [gate][n8][unit parity]: this thread's rows, in order
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
                for (int n8 = 0; n8 < NB; ++n8) dbs[g][n8][0] = dbs[g][n8][1] = 0.f;
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int row = r0 + 64 * m + 8 * hr;
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
                            const float pre[4] = {acc[m][n8 * 4 + e], acc[m][(NB + n8) * 4 + e],
                                                  acc[m][(2 * NB + n8) * 4 + e], acc[m][(3 * NB + n8) * 4 + e]};
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
            // db: this warp's 16 rows per half (the lanes differing in
            // lane / 4), then the four warps in a fixed order
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
            named_barrier(1 + wg, 128);
            const int i = threadIdx.x % 128, u = u0 + i % TU;
            if (u < H)
                p.db_part[(size_t)(row0 / TM) * 4 * H + (size_t)(i / TU) * H + u] =
                    ((s_db[wg][0][i] + s_db[wg][1][i]) + s_db[wg][2][i]) + s_db[wg][3][i];
            named_barrier(1 + wg, 128);  // s_db is read before the next tile writes it
        }
    }
}

struct Tf32ProdArgs {
    const int* lens;  // [B], sorted descending
    float* dh;        // [B, H] out: dg . W_hh (t > 0)
    float* demb;      // [B, D] out: dg . W_ih, step t
    int B, D, H, t;
};

// Product launch of step t: [dh | demb[t]] = dg[t] . [W_hh | W_ih] over
// K = 4H in 3xTF32, a tile of 128 rows x 128 output columns; B is the split
// copy of [W_hh | W_ih]^T ([H + D, 4H], K-major), as TF32 wgmma reads only
// K-major operands.  Rows past the active prefix are computed and not
// written; at t == 0 only the tiles holding demb columns run (dh of step 0
// is never read).
template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_bwd_product_kernel_tf32(const __grid_constant__ CUtensorMap map_dg,
                                 const __grid_constant__ CUtensorMap map_wt_hi,
                                 const __grid_constant__ CUtensorMap map_wt_lo, const Tf32ProdArgs p) {
    extern __shared__ uint8_t smem_raw[];
    const Ring r = make_ring(smem_raw);
    const int n_act_all = active_prefix(p.lens, p.B, p.t);
    __syncthreads();
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
            tma_prefetch_map(&map_dg);
            tma_prefetch_map(&map_wt_hi);
            tma_prefetch_map(&map_wt_lo);
            produce(r, tiles, nk, [&](int tile, int kt, uint8_t* a, uint8_t* w_hi, uint8_t* w_lo, uint64_t* bar) {
                const int row0 = tile / col_tiles * TM, n0 = (tile % col_tiles + n_first) * TN;
                tma_load_3d(a, &map_dg, bar, kt * TK, row0, p.t);
                tma_load_3d(w_hi, &map_wt_hi, bar, kt * TK, n0, 0);
                tma_load_3d(w_lo, &map_wt_lo, bar, kt * TK, n0, 0);
            });
        }
    } else {
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        // acc[m][4 n8 + e] holds row r0 + 64 m + 8 (e/2), column
        // n0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 16 warp + lane/4
        float acc[2][TN / 2];
        for (int q = wg;; q += 2) {
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / col_tiles * TM, n0 = (tile % col_tiles + n_first) * TN;
            const int r0 = row0 + warp * 16 + (lane >> 2);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int i = 0; i < TN / 2; ++i) acc[m][i] = 0.f;
            tile_products<V>(r, q, nk, wg, warp, lane, acc);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int row = r0 + 64 * m + 8 * hr;
                    if (row >= n_act) continue;
#pragma unroll
                    for (int n8 = 0; n8 < TN / 8; ++n8) {
                        const int n = n0 + n8 * 8 + (lane & 3) * 2;  // and n + 1: H and N are even
                        const float2 v = make_float2(acc[m][n8 * 4 + 2 * hr], acc[m][n8 * 4 + 2 * hr + 1]);
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

// Split launch, once per backward call: the hi and lo parts of W_ih and
// W_hh in their gate-major layout (for the gate launch) and of
// [W_hh | W_ih]^T (for the product launch), through a 32 x 32 shared tile.
// w_split holds w_ih_hi [4H, D], w_ih_lo, w_hh_hi [4H, H], w_hh_lo,
// wt_hi [H + D, 4H], wt_lo, in that order.
__global__ void __launch_bounds__(256) lstm_bwd_split_kernel_tf32(const float* w_ih, const float* w_hh,
                                                                   float* w_split, int D, int H) {
    __shared__ float t_hi[32][33], t_lo[32][33];
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
            t_hi[i][tx] = __uint_as_float(hi);
            t_lo[i][tx] = __uint_as_float(lo);
        }
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
        const int n = n0 + i, k = k0 + tx;
        if (k < H4 && n < N) {
            wt_hi[(size_t)n * H4 + k] = t_hi[tx][i];
            wt_lo[(size_t)n * H4 + k] = t_lo[tx][i];
        }
    }
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

// cudaFuncSetAttribute for the `bytes` of dynamic shared memory of
// `Kernel`, once per device.
template <auto Kernel, int bytes = SMEM>
int allow_smem() {
    static bool done[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!done[dev]) {
        const cudaError_t e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return static_cast<int>(e);
        done[dev] = true;
    }
    return 0;
}

// The split weights' parts (see lstm_bwd_split_kernel_tf32).
struct SplitWeights {
    const float *wih_hi, *wih_lo, *whh_hi, *whh_lo, *wt_hi, *wt_lo;
};

inline SplitWeights split_parts(const void* w_split, int D, int H) {
    const float* base = static_cast<const float*>(w_split);
    const size_t ih = (size_t)4 * H * D, hh = (size_t)4 * H * H, t = (size_t)(H + D) * 4 * H;
    return {base, base + ih, base + 2 * ih, base + 2 * ih + hh, base + 2 * ih + 2 * hh, base + 2 * ih + 2 * hh + t};
}

}  // namespace tf32

}  // namespace

// Step t of the reverse loop, part 1 (gate math; grid over rows x units).
// every_step = 0: dlast [B, H] enters at each row's last step; 1: dlast is
// dhs[t] and enters at every active step.
extern "C" int oket_lstm_bwd_gate_bf16(const void* x, const void* h_prev, const void* w_ih,
                                       const void* w_hh, const void* bias, const void* lens,
                                       const void* cs_t, const void* cs_prev, const void* dlast,
                                       int every_step, const void* dh, void* dc, void* dg, void* db_part,
                                       long long B, int D, int H, int t, void* stream) {
    GateBwdArgs p;
    p.g.x = static_cast<const uint16_t*>(x);
    p.g.h_prev = static_cast<const uint16_t*>(h_prev);
    p.g.w_ih = static_cast<const uint16_t*>(w_ih);
    p.g.w_hh = static_cast<const uint16_t*>(w_hh);
    p.g.B = B;
    p.g.D = D;
    p.g.H = H;
    p.g.t = t;
    p.bias = static_cast<const float*>(bias);
    p.lens = static_cast<const int*>(lens);
    p.cs_t = static_cast<const uint16_t*>(cs_t);
    p.cs_prev = static_cast<const uint16_t*>(cs_prev);
    p.dlast = static_cast<const uint16_t*>(dlast);
    p.every_step = every_step;
    p.dh = static_cast<const float*>(dh);
    p.dc = static_cast<float*>(dc);
    p.dg = static_cast<uint16_t*>(dg);
    p.db_part = static_cast<float*>(db_part);
    const dim3 grid((unsigned)((B + BM - 1) / BM), (unsigned)((H + BN - 1) / BN));
    lstm_bwd_gate_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// Step t of the reverse loop, part 2 ([dh | demb] = dg . [W_hh | W_ih]).
extern "C" int oket_lstm_bwd_product_bf16(const void* dg, const void* w_hh, const void* w_ih,
                                          const void* lens, void* dh, void* demb, long long B, int D,
                                          int H, int t, void* stream) {
    ProdArgs p;
    p.dg = static_cast<const uint16_t*>(dg);
    p.w_hh = static_cast<const uint16_t*>(w_hh);
    p.w_ih = static_cast<const uint16_t*>(w_ih);
    p.lens = static_cast<const int*>(lens);
    p.dh = static_cast<float*>(dh);
    p.demb = static_cast<uint16_t*>(demb);
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    return launch_bwd_product(p, stream);
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
// 4H floats); variant is 0 (3xTF32) or 1 (1xTF32, the planted check); grid
// is the number of persistent blocks.  Returns the cudaError_t of the
// launch, or -1 if the driver could not encode the tensor maps.

// Once per backward call, before the steps: split W_ih and W_hh into w_split.
extern "C" int oket_lstm_bwd_split_f32(const void* w_ih, const void* w_hh, void* w_split, int D, int H,
                                       void* stream) {
    const dim3 grid((unsigned)((4 * H + 31) / 32), (unsigned)((H + D + 31) / 32));
    tf32::lstm_bwd_split_kernel_tf32<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w_ih), static_cast<const float*>(w_hh), static_cast<float*>(w_split), D, H);
    return static_cast<int>(cudaGetLastError());
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
    if (variant == X3) {
        if (const int e = allow_smem<lstm_bwd_gate_kernel_tf32<X3>>()) return e;
        lstm_bwd_gate_kernel_tf32<X3><<<grid, THREADS, SMEM, s>>>(*maps[0], *maps[1], *maps[2], *maps[3], *maps[4],
                                                                  *maps[5], p);
    } else if (variant == X1) {
        if (const int e = allow_smem<lstm_bwd_gate_kernel_tf32<X1>>()) return e;
        lstm_bwd_gate_kernel_tf32<X1><<<grid, THREADS, SMEM, s>>>(*maps[0], *maps[1], *maps[2], *maps[3], *maps[4],
                                                                  *maps[5], p);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// Step t, part 2: [dh | demb[t]] = dg[t] . [W_hh | W_ih]; dg is [L, B, 4H].
extern "C" int oket_lstm_bwd_product_f32(const void* dg, const void* w_split, const void* lens, void* dh, void* demb,
                                         int L, int B, int D, int H, int t, int grid, int variant, void* stream) {
    using namespace tf32;
    Tf32ProdArgs p;
    p.lens = static_cast<const int*>(lens);
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
    if (variant == X3) {
        if (const int e = allow_smem<lstm_bwd_product_kernel_tf32<X3>>()) return e;
        lstm_bwd_product_kernel_tf32<X3><<<grid, THREADS, SMEM, s>>>(*maps[0], *maps[1], *maps[2], p);
    } else if (variant == X1) {
        if (const int e = allow_smem<lstm_bwd_product_kernel_tf32<X1>>()) return e;
        lstm_bwd_product_kernel_tf32<X1><<<grid, THREADS, SMEM, s>>>(*maps[0], *maps[1], *maps[2], p);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
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
    if (variant == X3) {
        if (const int e = allow_smem<lstm_bwd_dw_kernel_tf32<X3>, DW_SMEM>()) return e;
        lstm_bwd_dw_kernel_tf32<X3><<<grid, NT, DW_SMEM, s>>>(p);
    } else if (variant == X1) {
        if (const int e = allow_smem<lstm_bwd_dw_kernel_tf32<X1>, DW_SMEM>()) return e;
        lstm_bwd_dw_kernel_tf32<X1><<<grid, NT, DW_SMEM, s>>>(p);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
