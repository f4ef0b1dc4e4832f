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
// cotangent, dg, demb and dW in f32, every product in true f32 FFMA on the
// CUDA cores (lstm_f32.cuh; no TF32), bound by FP32 operations.  The same
// three launches: lstm_bwd_gate_kernel_f32 (gate_product_f32 and the same
// cell math, db_part from a fixed-order sum), lstm_bwd_product_kernel_f32
// and lstm_bwd_dw_kernel_f32 (a register-tiled FFMA product over the same
// (t, row chunk) walk, summed in blocks of 256 rows, then the same db
// reduction).  D and H multiples of 4.

#include "lstm_f32.cuh"

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

struct GateBwdArgsF32 {
    GateArgsF32 g;         // x = emb[t], h_prev = hs[t-1]
    const float* bias;     // [4H]
    const int* lens;       // [B]
    const float* cs_t;     // [B, H] c_t
    const float* cs_prev;  // [B, H] c_{t-1}; unread at t == 0
    const float* dlast;    // [B, H]: dlast, or dhs[t] in the every-state mode
    int every_step;        // 1: add dlast at every active step (dhs[t]); 0: at len == t+1
    const float* dh;       // [B, H] dh carry from step t+1 (0 for rows first active at t)
    float* dc;             // [B, H] dc carry in, dc * f out
    float* dg;             // [B, 4H] dgates of step t
    float* db_part;        // [gridDim.x, 4H] per-row-block sums of the dgates of step t
};

__global__ void __launch_bounds__(NT) lstm_bwd_gate_kernel_f32(const GateBwdArgsF32 p) {
    __shared__ __align__(16) TileAF As[2];
    __shared__ __align__(16) TileWF Bs[2];
    __shared__ int s_len[BM];
    __shared__ float s_db[NT / 32][4 * BN];  // [warp][gate column of the block]

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;
    const int t = p.g.t, H = p.g.H;
    if (!load_lengths(p.lens, p.g.B, row0, t, s_len)) return;

    float acc[FRM][4][FUN];
    gate_product_f32(p.g, row0, j0, s_len, As, Bs, acc);

    float dbs[4][FUN] = {};  // [gate][unit]: this thread's rows, in order
#pragma unroll
    for (int i = 0; i < FRM; ++i) {
        const int r = f32_row(i);
        const int len = s_len[r];
        if (len <= t) continue;
#pragma unroll
        for (int u = 0; u < FUN; ++u) {
            const int j = j0 + f32_unit(u);
            if (j >= H) continue;
            const size_t o = (size_t)(row0 + r) * H + j;
            const float c_prev = t > 0 ? p.cs_prev[o] : 0.f;
            const bool inject = p.every_step || len == t + 1;
            const float dh = p.dh[o] + (inject ? p.dlast[o] : 0.f);
            const float pre[4] = {acc[i][0][u] + p.bias[j], acc[i][1][u] + p.bias[H + j],
                                  acc[i][2][u] + p.bias[2 * H + j], acc[i][3][u] + p.bias[3 * H + j]};
            float d[4];
            p.dc[o] = bwd_cell(pre, p.cs_t[o], c_prev, dh, p.dc[o], d);
            float* dg_row = p.dg + (size_t)(row0 + r) * 4 * H + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                dg_row[(size_t)g * H] = d[g];
                dbs[g][u] += d[g];
            }
        }
    }

    // db: the two row groups of a warp (lanes l and l ^ 16), then the eight
    // warps in a fixed order
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int u = 0; u < FUN; ++u) {
            const float v = dbs[g][u] + __shfl_xor_sync(0xffffffffu, dbs[g][u], 16);
            if (lane < 16) s_db[warp][g * BN + f32_unit(u)] = v;
        }
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * BN; i += NT) {
        const int g = i / BN, j = j0 + i % BN;
        if (j >= H) continue;
        float v = 0.f;
        for (int w = 0; w < NT / 32; ++w) v += s_db[w][i];
        p.db_part[(size_t)blockIdx.x * 4 * H + (size_t)g * H + j] = v;
    }
}

constexpr int FWLD = WB + 4;  // smem row stride of the k-major f32 tiles
// dW sums over every active (row, step), 26636 terms on the flagship's entity
// pass: one f32 accumulator taking them in turn drifted from the plain
// version's per-step products by 1.2e-5 of max|dW| on an H100, too near the
// f32 rule's limit.  So the kernel sums blocks of DW_BLOCK chunks (256 rows) apart and
// adds the block sums into a second accumulator.
constexpr int DW_BLOCK = 16;

struct DwArgsF32 {
    const float* dg;       // [L, B, 4H]
    const float* x;        // [L, B, D]
    const float* hs;       // [L, B, H]
    const int* lens;       // [B], sorted descending
    const float* db_part;  // [L, ceil(B / BM), 4H]: written for the active row blocks only
    float* dw_ih;          // [4H, D]
    float* dw_hh;          // [4H, H]
    float* db;             // [4H]
    long long B;
    int D, H, L;
};

// The dW tile walk of lstm_bwd_dw_kernel with an FFMA product: thread (tm =
// tid / 16, tn = tid % 16) holds gate columns m0 + 4 tm + 64 w + e and output
// columns n0 + 4 tn + 64 v + e, both read as float4 from the k-major tiles.
__global__ void __launch_bounds__(NT) lstm_bwd_dw_kernel_f32(const DwArgsF32 p) {
    __shared__ __align__(16) float As[2][FBK][FWLD];  // dg rows (k) x gate columns (m)
    __shared__ __align__(16) float Bs[2][FBK][FWLD];  // x or h rows (k) x output columns (n)

    const int H4 = 4 * p.H;
    const int nyd = (p.D + WB - 1) / WB;
    const bool hh = (int)blockIdx.y >= nyd;
    const int N = hh ? p.H : p.D;
    const int m0 = blockIdx.x * WB;
    const int n0 = (hh ? blockIdx.y - nyd : blockIdx.y) * WB;
    float* out = hh ? p.dw_hh : p.dw_ih;
    const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
    float acc[2][4][2][4], sum[2][4][2][4];  // this block of chunks; the blocks before it
    // sum += acc, acc = 0 (fixed order: the walk is the same in every thread)
    auto flush = [&]() {
#pragma unroll
        for (int w = 0; w < 2; ++w)
#pragma unroll
            for (int em = 0; em < 4; ++em)
#pragma unroll
                for (int v = 0; v < 2; ++v)
#pragma unroll
                    for (int en = 0; en < 4; ++en) {
                        sum[w][em][v][en] += acc[w][em][v][en];
                        acc[w][em][v][en] = 0.f;
                    }
    };
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int em = 0; em < 4; ++em)
#pragma unroll
            for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int en = 0; en < 4; ++en) acc[w][em][v][en] = sum[w][em][v][en] = 0.f;

    db_reduce(p);

    // dW_hh pairs dg[t] with h_{t-1} = hs[t-1]: no term at t = 0 (h_0 = 0)
    auto load = [&](int t, int k0, int nrows, int s) {
        const float* a = p.dg + (size_t)t * p.B * H4;
        const float* b = hh ? p.hs + (size_t)(t - 1) * p.B * p.H : p.x + (size_t)t * p.B * p.D;
        constexpr int CH = WB / 4;  // 16-byte chunks per tile row
        for (int i = threadIdx.x; i < FBK * CH; i += NT) {
            const int kr = i / CH, c = (i % CH) * 4;
            const long long row = k0 + kr;
            const float* asrc = a + (size_t)row * H4 + m0 + c;
            const bool aok = row < nrows && m0 + c < H4;
            cp_async16(&As[s][kr][c], aok ? asrc : a, aok ? 16 : 0);
            const float* bsrc = b + (size_t)row * N + n0 + c;
            const bool bok = row < nrows && n0 + c < N;
            cp_async16(&Bs[s][kr][c], bok ? bsrc : b, bok ? 16 : 0);
        }
    };

    int t = hh ? 1 : 0, k0 = -FBK;
    int nrows = t < p.L ? active_rows(p.lens, p.B, t) : 0;
    dw_advance(p, FBK, t, k0, nrows);
    if (t < p.L) {
        int s = 0;
        load(t, k0, nrows, s);
        cp_async_commit();
        dw_advance(p, FBK, t, k0, nrows);
        for (int chunk = 1;; ++chunk) {
            const bool more = t < p.L;
            if (more) load(t, k0, nrows, s ^ 1);
            cp_async_commit();
            cp_async_wait_1();
            __syncthreads();
#pragma unroll
            for (int k = 0; k < FBK; ++k) {
                float4 a[2], b[2];
#pragma unroll
                for (int w = 0; w < 2; ++w) a[w] = *reinterpret_cast<const float4*>(&As[s][k][tm * 4 + 64 * w]);
#pragma unroll
                for (int v = 0; v < 2; ++v) b[v] = *reinterpret_cast<const float4*>(&Bs[s][k][tn * 4 + 64 * v]);
#pragma unroll
                for (int w = 0; w < 2; ++w) {
                    const float av[4] = {a[w].x, a[w].y, a[w].z, a[w].w};
#pragma unroll
                    for (int em = 0; em < 4; ++em)
#pragma unroll
                        for (int v = 0; v < 2; ++v) {
                            acc[w][em][v][0] = fmaf(av[em], b[v].x, acc[w][em][v][0]);
                            acc[w][em][v][1] = fmaf(av[em], b[v].y, acc[w][em][v][1]);
                            acc[w][em][v][2] = fmaf(av[em], b[v].z, acc[w][em][v][2]);
                            acc[w][em][v][3] = fmaf(av[em], b[v].w, acc[w][em][v][3]);
                        }
                }
            }
            __syncthreads();
            if (chunk % DW_BLOCK == 0) flush();
            if (!more) break;
            dw_advance(p, FBK, t, k0, nrows);
            s ^= 1;
        }
    }
    flush();

#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int em = 0; em < 4; ++em)
#pragma unroll
            for (int v = 0; v < 2; ++v)
#pragma unroll
                for (int en = 0; en < 4; ++en) {
                    const int m = m0 + tm * 4 + 64 * w + em;
                    const int n = n0 + tn * 4 + 64 * v + en;
                    if (m < H4 && n < N) out[(size_t)m * N + n] = sum[w][em][v][en];
                }
}

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

// The f32 mode: the same three entries for f32 x, hs, cs, dlast (or dhs[t]),
// weights, dg, demb and dW (lens int32, bias, dh, dc, db_part and db f32, as
// in the bf16 entries); D % 4 == H % 4 == 0.
extern "C" int oket_lstm_bwd_gate_f32(const void* x, const void* h_prev, const void* w_ih, const void* w_hh,
                                      const void* bias, const void* lens, const void* cs_t, const void* cs_prev,
                                      const void* dlast, int every_step, const void* dh, void* dc, void* dg,
                                      void* db_part, long long B, int D, int H, int t, void* stream) {
    GateBwdArgsF32 p;
    p.g.x = static_cast<const float*>(x);
    p.g.h_prev = static_cast<const float*>(h_prev);
    p.g.w_ih = static_cast<const float*>(w_ih);
    p.g.w_hh = static_cast<const float*>(w_hh);
    p.g.B = B;
    p.g.D = D;
    p.g.H = H;
    p.g.t = t;
    p.bias = static_cast<const float*>(bias);
    p.lens = static_cast<const int*>(lens);
    p.cs_t = static_cast<const float*>(cs_t);
    p.cs_prev = static_cast<const float*>(cs_prev);
    p.dlast = static_cast<const float*>(dlast);
    p.every_step = every_step;
    p.dh = static_cast<const float*>(dh);
    p.dc = static_cast<float*>(dc);
    p.dg = static_cast<float*>(dg);
    p.db_part = static_cast<float*>(db_part);
    const dim3 grid((unsigned)((B + BM - 1) / BM), (unsigned)((H + BN - 1) / BN));
    lstm_bwd_gate_kernel_f32<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int oket_lstm_bwd_product_f32(const void* dg, const void* w_hh, const void* w_ih, const void* lens,
                                         void* dh, void* demb, long long B, int D, int H, int t, void* stream) {
    ProdArgsF32 p;
    p.dg = static_cast<const float*>(dg);
    p.w_hh = static_cast<const float*>(w_hh);
    p.w_ih = static_cast<const float*>(w_ih);
    p.lens = static_cast<const int*>(lens);
    p.dh = static_cast<float*>(dh);
    p.demb = static_cast<float*>(demb);
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    return launch_bwd_product_f32(p, stream);
}

extern "C" int oket_lstm_bwd_dw_f32(const void* dg, const void* x, const void* hs, const void* lens,
                                    const void* db_part, void* dw_ih, void* dw_hh, void* db, long long B, int D,
                                    int H, int L, void* stream) {
    DwArgsF32 p;
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
    lstm_bwd_dw_kernel_f32<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
