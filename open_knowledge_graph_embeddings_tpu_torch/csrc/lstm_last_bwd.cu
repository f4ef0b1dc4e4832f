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
//   3. bf16::lstm_bwd_dw_kernel_bf16, once: dW_ih = sum over t of dg[t]^T .
//      x_t and dW_hh = sum over t >= 1 of dg[t]^T . hs[t-1] over each
//      step's active rows (the TPU kernel's VMEM accumulation, as one
//      reduction over ~26,600 row-steps on the flagship's entity pass), and
//      db = the fixed-order sum of db_part.  Its least time is the
//      tensor-core operations' (2 x 4H x (D + H) per active row-step); on
//      the card it is bound by the bytes each tile brings into shared
//      memory: every row of dg is read by all the output column tiles and
//      every row of x or hs by all the gate column tiles (~1.6 GB a call at
//      D = H = 512 against ~160 MB of operands).  It replaces a first
//      simple launch (one block per 128 x 128 tile walking every row alone,
//      128 blocks on 132 SMs, mma.sync fed by 16-bit shared loads, a 2-slot
//      cp.async buffer, db reduced serially in every block's prologue) with
//      kernel 1's Hopper shape: persistent blocks, one producer thread
//      loading each 64-row chunk of the walk by TMA into a 6-slot mbarrier
//      ring (lstm_sm90.cuh::Ring; 64 x 64 boxes of dg and of x or hs, both
//      MN-major, their columns contiguous), two consumer warpgroups on
//      wgmma m64n128k16 with A and B transposed, each chunk's products from
//      zero folded into an f32 sum.  A 128 x 128 tile a block, each
//      walking every row of its tile alone: the flagship's 128 tiles fill
//      the card's 132 SMs, and db runs on the blocks with no tile.  The
//      rows of a step's last chunk past its active prefix are zeroed in
//      shared memory before the products.  What the launch is bound by on
//      the card, and the wider tiles, TMA multicast and split walks
//      weighed against it, are at the kernel.
// The rows are sorted by descending length, so the rows active at step t are
// a prefix, found by a binary search over the lengths.  Inactive rows are
// never read, or are zeroed before a product reads them.  Any B; D and H
// multiples of 8.
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
//   3. lstm_bwd_dw_kernel_tf32, once: the bf16 dW launch's shape
//      (persistent blocks, a block walking every active row of its 128 x
//      128 tile of dW alone, one producer thread loading each chunk by TMA
//      into the shared lstm_sm90.cuh::Ring, two consumer warpgroups of 64
//      gate columns each) on wgmma m64n128k8 TF32.  dW reduces over rows,
//      so both operands arrive MN-major, and TF32 wgmma takes only K-major
//      ones: the consumers write both, split, into K-major hi and lo tiles
//      in shared memory a chunk ahead (32 rows: a 3-slot ring of 32 KB
//      stages and two 64 KB buffers, 226 KB), and multiply them there;
//      the products of 256 rows from zero, folded into an f32 sum (the
//      mma.sync launch's blocks before it); then the same db reduction.
// No float atomics: dW and db do not change from run to run.  D and H
// multiples of 4 (TMA strides are multiples of 16 bytes); K tails, rows
// past B and units past H read as zero.  On an H100 (chip_smoke.py; numbers
// in PERF.md) the gate and product launches reach about half of their parts
// of the bound, and the whole backward runs below cuDNN's packed f32 LSTM
// backward on the training passes.

#include "lstm_bf16.cuh"
#include "lstm_gates.cuh"
#include "lstm_tf32.cuh"

namespace {

using namespace oket_lstm;
using namespace oket_sm90;

constexpr int DBC = 16;  // db columns per pass; NT / DBC partial sums each

// What both dtypes' dW launches read and write: the lengths, the gate
// launches' db_part, and dW (T: bf16 bits or f32) and db out.
template <typename T>
struct DwArgs {
    const int* lens;       // [B], sorted descending
    const float* db_part;  // [L, ceil(B / BM), 4H]: written for the active row tiles only
    T* dw_ih;              // [4H, D]
    T* dw_hh;              // [4H, H]
    float* db;             // [4H]
    int B, D, H, L;
};

constexpr int DW_TILE = 128;  // dW tile: 128 gate columns x 128 output columns

// Tile u of dW: 128 gate columns from m0 x 128 output columns from n0 of
// dW_ih, or of dW_hh when hh (the output-column tiles of a gate-column tile
// in order, dW_ih's first).
struct DwTile {
    int m0, n0, N;
    bool hh;
};

template <typename Args>
__device__ __forceinline__ DwTile dw_tile(const Args& p, int u, int cols, int nd) {
    DwTile w;
    const int j = u % cols;
    w.hh = j >= nd;
    w.m0 = u / cols * DW_TILE;
    w.n0 = (w.hh ? j - nd : j) * DW_TILE;
    w.N = w.hh ? p.H : p.D;
    return w;
}

// dW tiles of a call: 128-column tiles of the 4H gate columns x those of
// the D + H output columns (dW_ih's, then dW_hh's).
template <typename Args>
__host__ __device__ __forceinline__ int dw_tiles(const Args& p) {
    return (4 * p.H + DW_TILE - 1) / DW_TILE * ((p.D + DW_TILE - 1) / DW_TILE + (p.H + DW_TILE - 1) / DW_TILE);
}

// The dW launches' grid: a block per tile and per db pass, at most
// max_blocks (the SM count: the blocks are persistent).
template <typename Args>
int dw_grid(const Args& p, int max_blocks) {
    return min(dw_tiles(p) + (4 * p.H + DBC - 1) / DBC, max_blocks);
}

// The producer thread of a dW launch: for each chunk of ROWS rows of the
// block's walk (each of its tiles, in order: every step's active rows
// (active_rows) in chunks, steps in order; dW_hh has no term at t = 0,
// h_0 = 0, so its tiles start at step 1), the next slot of the ring gets
// by TMA BOXES boxes of ROWS rows x BOX_COLS columns of dg[t] (the tile's
// gate columns), then as many of x_t or hs[t-1] (its output columns),
// through 3-D maps over [L, B, columns]: both operands MN-major, their
// columns contiguous.  A box wholly past 4H or N is not loaded: what the
// slot holds there reaches only outputs that are not written.
template <int ROWS, int BOX_COLS, int BOXES, int BOX_BYTES, typename R, typename Args>
__device__ __forceinline__ void produce_dw(const R& r, const Args& p, const CUtensorMap* map_dg,
                                           const CUtensorMap* map_x, const CUtensorMap* map_hs) {
    tma_prefetch_map(map_dg);
    tma_prefetch_map(map_x);
    tma_prefetch_map(map_hs);
    const int H4 = 4 * p.H, nd = (p.D + DW_TILE - 1) / DW_TILE;
    const int cols = nd + (p.H + DW_TILE - 1) / DW_TILE, tiles = dw_tiles(p);
    int it = 0;
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
        const DwTile w = dw_tile(p, u, cols, nd);
        const int na = min(BOXES, (H4 - w.m0 + BOX_COLS - 1) / BOX_COLS);
        const int nb = min(BOXES, (w.N - w.n0 + BOX_COLS - 1) / BOX_COLS);
        const CUtensorMap* map_b = w.hh ? map_hs : map_x;
        for (int t = w.hh; t < p.L; ++t) {
            const int nrows = active_rows(p.lens, p.B, t);
            for (int k0 = 0; k0 < nrows; k0 += ROWS, ++it) {
                const int s = it % R::STAGES;
                mbar_wait(&r.empty[s], ((it / R::STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(&r.full[s], (na + nb) * BOX_BYTES);
                uint8_t* a = r.slot(s);
                uint8_t* b = a + BOXES * BOX_BYTES;
                for (int j = 0; j < na; ++j)
                    tma_load_3d(a + j * BOX_BYTES, map_dg, &r.full[s], w.m0 + j * BOX_COLS, k0, t);
                for (int j = 0; j < nb; ++j)
                    tma_load_3d(b + j * BOX_BYTES, map_b, &r.full[s], w.n0 + j * BOX_COLS, k0, t - w.hh);
            }
        }
    }
}

// A chunk of a dW launch's walk: rows k0 .. k0 + ROWS of the nrows active
// at step t, of tile u (u past the block's last tile: the walk's end).
struct DwChunk {
    int u, t, k0, nrows;
};

// The chunk after c in the block's walk, in produce_dw's order (its tiles,
// each from its first step, steps with no active row skipped); rows = 0
// from {blockIdx.x, the first tile's first step - 1, 0, 0} finds the
// first.  nrows is made warp-uniform: the compiler serialises a wgmma that
// depends on what it takes for a divergent value.
template <typename Args>
__device__ __forceinline__ void dw_next_chunk(const Args& p, int rows, int tiles, int cols, int nd, DwChunk& c) {
    c.k0 += rows;
    while (c.u < tiles && c.k0 >= c.nrows) {
        c.k0 = 0;
        c.nrows = 0;
        if (++c.t < p.L)
            c.nrows = __shfl_sync(0xffffffff, active_rows(p.lens, p.B, c.t), 0);
        else if ((c.u += gridDim.x) < tiles)
            c.t = (int)dw_tile(p, c.u, cols, nd).hh - 1;
    }
}

// db[c0 .. c0 + DBC) = the sum of db_part[t][rb][c] over every step t and
// every row block rb active at t (its first row is), by NT threads: thread
// tid (lane = tid / DBC) sums the (t, rb) entries lane, lane + NT / DBC,
// ... in order, then one thread per column adds the partial sums in order;
// sync() synchronises the NT threads.  Both dtypes' dW launches run it, in
// the same order, so db does not depend on how a launch divides its work.
template <typename Args, typename Sync>
__device__ __forceinline__ void db_columns(const Args& p, int c0, int tid, float (&part)[NT / DBC][DBC], Sync sync) {
    const int H4 = 4 * p.H;
    const int nrb = (int)((p.B + BM - 1) / BM);
    const int n_entries = p.L * nrb;
    const int col = tid % DBC, lane = tid / DBC;
    float s = 0.f;
    for (int e = lane; e < n_entries; e += NT / DBC) {
        const int t = e / nrb, rb = e % nrb;
        if (max(__ldg(p.lens + (size_t)rb * BM), 1) > t && c0 + col < H4)
            s += __ldg(p.db_part + ((size_t)t * nrb + rb) * H4 + c0 + col);
    }
    part[lane][col] = s;
    sync();
    if (tid < DBC && c0 + tid < H4) {
        float v = 0.f;
        for (int l = 0; l < NT / DBC; ++l) v += part[l][tid];
        p.db[c0 + tid] = v;
    }
    sync();
}

// db in a dW launch, by its 256 consumer threads (tid), after their tiles:
// DBC columns a pass, on the blocks with no tile where there are such (the
// last ones), else on all, from the last back.
template <typename Args>
__device__ __forceinline__ void dw_db(const Args& p, int tiles, int tid, float (&part)[NT / DBC][DBC]) {
    const int busy = min((int)gridDim.x, tiles);
    const int pool = busy < (int)gridDim.x ? gridDim.x - busy : gridDim.x;
    if ((int)blockIdx.x >= (int)gridDim.x - pool)
        for (int c = (gridDim.x - 1 - blockIdx.x) * DBC; c < 4 * p.H; c += pool * DBC)
            db_columns(p, c, tid, part, [] { named_barrier(3, 256); });
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
    const RingBf16 r = make_ring<RingBf16>(smem_raw, 4);
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

// ------------------------------------------------------------- bf16 dW launch

constexpr int DW_BOX = 64;                          // rows (K) and columns of a TMA box
constexpr int DW_BOX_BYTES = DW_BOX * DW_BOX * 2;   // 8 KB
constexpr int DW_STAGES = 6;
using RingDw = Ring<4 * DW_BOX_BYTES, DW_STAGES>;   // a stage: two dg boxes, then two x or hs boxes

// What the dW entry launches (its `variant`): the kernel, or for measuring
// it the kernel without its products (the loads alone).
enum DwVariant { DW_KERNEL = 0, DW_NO_PRODUCTS = 1 };

using DwArgs16 = DwArgs<uint16_t>;

// dW launch, once per call: dW_ih = sum over t of dg[t]^T . x_t and dW_hh =
// sum over t >= 1 of dg[t]^T . hs[t-1] over each step's active rows,
// rounded to bf16 at the end, and db (db_columns).  A tile's walk is every
// step's active rows (active_rows) in chunks of DW_BOX, steps in order;
// dW_hh has no term at t = 0 (h_0 = 0), so its tiles start at step 1.  For
// each chunk one producer thread loads by TMA into the ring boxes of 64
// rows x 64 columns of dg[t] (the tile's gate columns) and of x_t or
// hs[t-1] (its output columns), through 3-D maps over [L, B, columns], so
// both operands arrive MN-major (their columns contiguous, the reduction
// over rows).  The two consumer warpgroups take 64 gate columns each
// against the tile's 128 output columns: wgmma m64n128k16 with A and B both
// transposed, four k16 steps a chunk, from zero, folded into an f32 sum
// (the tensor cores' own accumulation over a long K flips bf16 roundings:
// tile_products_folded).  A step's last chunk may end inside its active
// prefix: the rows past it hold whatever dg and hs hold there
// (torch.empty; NaN . 0 is NaN), so the consumers zero them in the slot
// before the products.
//
// The launch is bound by the bytes its tiles bring into shared memory, not
// by the tensor cores: on an H100 its loads alone (V = DW_NO_PRODUCTS, the
// slots taken and given back unread) take 81 % of the kernel's time
// (chip_smoke.py --backward-split; numbers in PERF.md).  Weighed against
// that, and not kept: wider tiles need more registers than an SM has (the
// fold keeps two 64-register sums per consumer thread, so an SM holds the
// sums of at most three 64 x 128 warpgroup tiles, and a 256 x 128 tile on
// four consumer warpgroups does not fit); TMA multicast to clusters of two
// blocks (the two gate-column tiles of one output-column tile, each block
// loading one of a chunk's two x / hs boxes for both: a quarter fewer bytes
// from L2) read 0.68 ms against 0.22 on the flagship's entity pass; and
// splitting each tile's walk into slices summed in a fixed order read
// slower at every split of the flagship's passes (S = 2 .. 8), whose 128
// tiles fill the card's 132 SMs alone.  So a tile is one block's whole walk.
//
// Block b takes tiles b, b + G, ... (G = the grid: at most a block per SM);
// db goes to the blocks with no tile where there are such (4 of 132 at the
// flagship's widths), else to all, DBC columns a pass.  No float atomics:
// dW and db are the same bits from run to run.
template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_bwd_dw_kernel_bf16(const __grid_constant__ CUtensorMap map_dg, const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_hs, const DwArgs16 p) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ float part[NT / DBC][DBC];
    const RingDw r = make_ring<RingDw>(smem_raw, 8);
    __syncthreads();
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    const int H4 = 4 * p.H, nd = (p.D + DW_TILE - 1) / DW_TILE;
    const int cols = nd + (p.H + DW_TILE - 1) / DW_TILE;
    const int tiles = dw_tiles(p);

    if (wg == 2) {
        setmaxnreg_dec<40>();
        if (threadIdx.x == 256) produce_dw<DW_BOX, DW_BOX, 2, DW_BOX_BYTES>(r, p, &map_dg, &map_x, &map_hs);
    } else {
        setmaxnreg_inc<232>();
        const int tid = threadIdx.x, wt = tid % 128, warp = wt / 32, lane = tid % 32;
        // sum[4 n8 + e] holds gate column m0 + 64 wg + 16 warp + lane/4 + 8
        // (e/2), output column n0 + 8 n8 + 2 (lane%4) + e%2 (the wgmma layout)
        float sum[64], st[64];
        int it = 0;
        for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
            const DwTile w = dw_tile(p, u, cols, nd);
#pragma unroll
            for (int i = 0; i < 64; ++i) sum[i] = 0.f;
            for (int t = w.hh; t < p.L; ++t) {
                const int nrows = active_rows(p.lens, p.B, t);
                for (int k0 = 0; k0 < nrows; k0 += DW_BOX, ++it) {
                    const int valid = nrows - k0;  // rows of the chunk in the active prefix
                    const int s = it % DW_STAGES;
                    mbar_wait(&r.full[s], (it / DW_STAGES) & 1);
                    if (V == DW_KERNEL) {
                        uint8_t* a = r.slot(s) + wg * DW_BOX_BYTES;
                        uint8_t* b = r.slot(s) + 2 * DW_BOX_BYTES;
                        if (valid < DW_BOX) {
                            // each warpgroup zeroes its dg box and one of the
                            // two x / hs boxes, rows valid .. 63 (whole
                            // 128-byte rows: the swizzle moves chunks only
                            // within a row); then both see both
                            uint4* za = reinterpret_cast<uint4*>(a + valid * 128);
                            uint4* zb = reinterpret_cast<uint4*>(b + wg * DW_BOX_BYTES + valid * 128);
                            for (int i = wt; i < (DW_BOX - valid) * 8; i += 128) za[i] = zb[i] = make_uint4(0, 0, 0, 0);
                            fence_proxy_async();
                            named_barrier(1, 256);
                        }
                        wgmma_fence_regs(st);
                        wgmma_fence();
#pragma unroll
                        for (int kk = 0; kk < DW_BOX / 16; ++kk)
                            wgmma_m64n128k16<1, 1>(st, wgmma_desc_mn(a + kk * 2048, DW_BOX_BYTES),
                                                   wgmma_desc_mn(b + kk * 2048, DW_BOX_BYTES), kk > 0);
                        wgmma_commit();
                        wgmma_wait<0>();
                        wgmma_fence_regs(st);
                    }
                    if (lane == 0) mbar_arrive(&r.empty[s]);
                    if (V == DW_KERNEL) {
#pragma unroll
                        for (int i = 0; i < 64; ++i) sum[i] += st[i];
                    }
                }
            }
            uint16_t* out = w.hh ? p.dw_hh : p.dw_ih;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int m = w.m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hr;
                if (m >= H4) continue;
#pragma unroll
                for (int n8 = 0; n8 < 16; ++n8) {
                    const int n = w.n0 + 8 * n8 + 2 * (lane & 3);  // and n + 1: D and H are even
                    if (n < w.N)
                        *reinterpret_cast<uint32_t*>(out + (size_t)m * w.N + n) =
                            f32x2_to_bf16x2(sum[4 * n8 + 2 * hr], sum[4 * n8 + 2 * hr + 1]);
                }
            }
        }
        dw_db(p, tiles, tid, part);
    }
}

// The launch of kernel V: a block per tile and per db pass, at most
// max_blocks.
template <int V>
int launch_dw(const CUtensorMap* const (&maps)[3], const DwArgs16& p, int max_blocks, cudaStream_t s) {
    const int grid = dw_grid(p, max_blocks);
    if (const int e = allow_smem<lstm_bwd_dw_kernel_bf16<V>, RingDw::SMEM>()) return e;
    lstm_bwd_dw_kernel_bf16<V><<<grid, THREADS, RingDw::SMEM, s>>>(*maps[0], *maps[1], *maps[2], p);
    return static_cast<int>(cudaGetLastError());
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
    const RingTf32 r = make_ring<RingTf32>(smem_raw, 8);
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

// ------------------------------------------------------------- f32 dW launch

constexpr int DW32_ROWS = 32;                       // rows (K) of a chunk: 128 bytes of f32 along K
constexpr int DW32_BOX_BYTES = DW32_ROWS * 32 * 4;  // 4 KB: a TMA box of 32 rows x 32 columns
constexpr int DW32_OPERAND = 4 * DW32_BOX_BYTES;    // 16 KB: a chunk of 128 columns, as four boxes
constexpr int DW32_STAGES = 3;
using RingDw32 = Ring<2 * DW32_OPERAND, DW32_STAGES>;  // a stage: dg's four boxes, then x's or hs's
// A chunk's operands transposed and split: A's hi and lo, then B's (16 KB
// each), K-major; two buffers after the ring (its barriers padded to a
// swizzle atom): 226 KB in all, so db's partial sums take the first
// buffer at the end.
constexpr int DW32_BUF = 4 * DW32_OPERAND;
constexpr int DW32_SMEM = RingDw32::SMEM + 1024 + 2 * DW32_BUF;

using DwArgs32 = DwArgs<float>;
constexpr int DW32_FOLD = 8;  // chunks (256 rows) a wgmma accumulator sums before its fold

// A chunk's 128 columns of dg, x or hs (the four MN-major boxes at `op`:
// row k of box j holds columns 32 j .. 32 j + 31, 128-byte swizzled) into
// a K-major wgmma operand, split: row n of `bt_hi` and `bt_lo` holds the
// hi and lo parts of column n's 32 k (the 128-byte swizzle of
// lstm_sm90.cuh), rows k at or past `valid` as zero.  Consumer thread i (0 .. 255) moves one 4 x 4
// block: k 4 p .. 4 p + 3 by columns 32 j + 4 q .. + 3, for j = i / 64,
// p = i % 8 and q = (p + i / 8) % 8, in 16-byte loads and stores; the
// eight threads of a quarter warp (one p each) then hit eight different
// 16-byte chunks of a 128-byte row both ways (p ^ 4 (q & 1) and q ^ 4 (p & 1)
// are permutations of 0 .. 7), so no access has a bank conflict.
__device__ __forceinline__ void dw_split_transposed(const uint8_t* op, uint8_t* bt_hi, uint8_t* bt_lo, int i,
                                                    int valid) {
    const int j = i >> 6, p = i & 7, q = (p + (i >> 3)) & 7;
    float v[4][4];  // [k - 4 p][column - 32 j - 4 q]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int k = 4 * p + r;
        const float4 x = *reinterpret_cast<const float4*>(op + j * DW32_BOX_BYTES + k * 128 + ((q ^ (k & 7)) << 4));
        const bool keep = k < valid;
        v[r][0] = keep ? x.x : 0.f;
        v[r][1] = keep ? x.y : 0.f;
        v[r][2] = keep ? x.z : 0.f;
        v[r][3] = keep ? x.w : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int n = 32 * j + 4 * q + c;
        uint4 hi, lo;
        tf32_split(v[0][c], hi.x, lo.x);
        tf32_split(v[1][c], hi.y, lo.y);
        tf32_split(v[2][c], hi.z, lo.z);
        tf32_split(v[3][c], hi.w, lo.w);
        const int off = n * 128 + ((p ^ (n & 7)) << 4);
        *reinterpret_cast<uint4*>(bt_hi + off) = hi;
        *reinterpret_cast<uint4*>(bt_lo + off) = lo;
    }
}

// dW launch, once per call: dW_ih = sum over t of dg[t]^T . x_t and dW_hh =
// sum over t >= 1 of dg[t]^T . hs[t-1] over each step's active rows, in
// 3xTF32, and db (db_columns).  The bf16 launch's shape: persistent blocks,
// a 128 x 128 tile of dW a block walking every active row of it alone, in
// order; one producer thread (produce_dw) loading each chunk of 32 rows by
// TMA into a ring of DW32_STAGES slots, both operands MN-major (32 x 32
// boxes: the 128-byte swizzle holds 32 f32); two consumer warpgroups, 64
// gate columns each against the tile's 128 output columns, on wgmma
// m64n128k8 TF32.  TF32 wgmma reads only K-major operands (only 16-bit
// types have the transposed form), and dW reduces over rows, so the 256
// consumer threads write both operands of a chunk, split, into K-major hi
// and lo tiles in shared memory (dw_split_transposed), a chunk ahead: the
// next chunk's while this chunk's products run, into two buffers in turns,
// fenced for the async proxy.  Both operands from shared memory, a
// warpgroup issues a chunk's 12 products at once (per k8 step lo.B_hi +
// hi.B_lo + hi.B_hi, the correction products first).
//
// The launch is bound by shared memory's bandwidth: a chunk moves ~272 KB
// through it (the products read A 48 KB and B 96 KB, the transposes 32 KB
// in and 64 KB out, TMA 32 KB), ~2,100 cycles at 128 bytes a cycle against
// the tensor cores' ~1,540.  Measured on an H100 beside this form (1.18 ms
// on the flagship's entity pass; chip_smoke.py --backward-split, PERF.md):
// A split in registers a k8 step ahead of its products, as the gate loop
// does, read 1.31 ms (each step's split waits for the products of the
// step before); a chunk's A fragments split at once, 1.35-1.39 (with the
// chunk's and the tile's sums they do not fit the 168 registers ptxas
// gives a thread of a block of 288 or 384, setmaxnreg or not, and on a
// block of 256 whose thread 0 loads, the loads alone read 0.51 ms against
// 0.36).
//
// The products of DW32_FOLD chunks (256 rows in the walk's order, across
// steps) accumulate on the tensor cores from zero and are then folded into
// an f32 sum in registers; a tile's last chunk folds too.  The tensor
// cores' f32 accumulation truncates, so a run's sum shrinks with its
// length: one accumulator over 26,636 row-steps drifted 1.2e-5 of max|dW|
// from f32 products on an H100, and over each step's rows alone ~2e-5.
// 256 rows are the blocks of the mma.sync launch this one replaced: dW
// keeps its rounding, whose small shrink a card test that trains LSTM
// Tucker3 on the card and on the CPU passes at its seeds where a fold
// every 32 rows, less biased, sits at the f32 rule's limit (PERF.md, PR
// 21; test_torch_cuda.py::test_family_steps_on_card_match_cpu).  Each
// chunk waits for its products; a named barrier of both warpgroups then
// publishes the next chunk's tiles and frees this chunk's buffer.  Every
// chunk reads the accumulators, unconditionally, and folds them times 1 or
// 0: ptxas serialises every wgmma of a kernel that reads the accumulators
// on a path it cannot prove uniform (C7518; a fold under a condition was
// such a path).  A step's last chunk may
// end inside its active prefix: the rows past it hold whatever dg and hs
// hold there (torch.empty; NaN . 0 is NaN), so the tiles take zero there;
// the slot is never written.
//
// Block b takes tiles b, b + G, ... (G = the grid: at most a block per SM);
// db as in the bf16 launch (dw_db).  No float atomics: dW and db are the
// same bits from run to run.  V: X3 (the kernel), X1 (hi.hi' alone, the
// planted check) or NO_PRODUCTS (for measuring: the slots taken and given
// back unread, the loads alone).
template <int V>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_bwd_dw_kernel_tf32(const __grid_constant__ CUtensorMap map_dg, const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_hs, const DwArgs32 p) {
    extern __shared__ uint8_t smem_raw[];
    const RingDw32 r = make_ring<RingDw32>(smem_raw, 8);
    uint8_t* const bufs = r.slot(DW32_STAGES) + 1024;  // past the ring's barriers: 1024-byte aligned
    __syncthreads();
    const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);
    const int H4 = 4 * p.H, nd = (p.D + DW_TILE - 1) / DW_TILE;
    const int cols = nd + (p.H + DW_TILE - 1) / DW_TILE;
    const int tiles = dw_tiles(p);

    if (wg == 2) {
        setmaxnreg_dec<40>();
        if (threadIdx.x == 256) produce_dw<DW32_ROWS, 32, 4, DW32_BOX_BYTES>(r, p, &map_dg, &map_x, &map_hs);
        return;
    }
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x, warp = (tid / 32) % 4, lane = tid % 32;
    // the block's walk: nx is the chunk multiplied next, `it` its place
    // (slot it % DW32_STAGES, buffer it % 2)
    DwChunk nx = {(int)blockIdx.x, (int)blockIdx.x < tiles ? (int)dw_tile(p, blockIdx.x, cols, nd).hh - 1 : 0, 0, 0};
    dw_next_chunk(p, 0, tiles, cols, nd, nx);
    int it = 0;
    if constexpr (V == NO_PRODUCTS) {
        for (; nx.u < tiles; ++it, dw_next_chunk(p, DW32_ROWS, tiles, cols, nd, nx)) {
            mbar_wait(&r.full[it % DW32_STAGES], (it / DW32_STAGES) & 1);
            if (lane == 0) mbar_arrive(&r.empty[it % DW32_STAGES]);
        }
    } else {
        // chunk j (the chunk nx) into its buffer once its slot is full; the
        // slot is then free
        auto stage = [&](int j) {
            const int s = j % DW32_STAGES, valid = nx.nrows - nx.k0;
            mbar_wait(&r.full[s], (j / DW32_STAGES) & 1);
            uint8_t* buf = bufs + (j & 1) * DW32_BUF;
            dw_split_transposed(r.slot(s), buf, buf + DW32_OPERAND, tid, valid);
            dw_split_transposed(r.slot(s) + DW32_OPERAND, buf + 2 * DW32_OPERAND, buf + 3 * DW32_OPERAND, tid, valid);
            fence_proxy_async();
            if (lane == 0) mbar_arrive(&r.empty[s]);
        };
        // sum[4 n8 + e] holds gate column m0 + 64 wg + 16 warp + lane/4 + 8
        // (e/2), output column n0 + 8 n8 + 2 (lane%4) + e%2 (the wgmma
        // layout); st the chunk's tensor-core sum
        float sum[64], st[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) st[i] = 0.f;
        int run = 0;  // chunks in st since its last fold: 0, st starts from zero
        if (nx.u < tiles) stage(0);
        named_barrier(1, 256);
        for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
            const DwTile w = dw_tile(p, u, cols, nd);
#pragma unroll
            for (int i = 0; i < 64; ++i) sum[i] = 0.f;
            while (nx.u == u) {
                // this warpgroup's 64 rows of A (gate columns), all of B
                const uint8_t* a = bufs + (it & 1) * DW32_BUF + wg * (DW32_OPERAND / 2);
                const uint8_t* b = bufs + (it & 1) * DW32_BUF + 2 * DW32_OPERAND;
                wgmma_fence_regs(st);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < DW32_ROWS / 8; ++kk) {
                    const uint64_t a_hi = wgmma_desc(a + kk * 32), a_lo = wgmma_desc(a + DW32_OPERAND + kk * 32);
                    const uint64_t b_hi = wgmma_desc(b + kk * 32), b_lo = wgmma_desc(b + DW32_OPERAND + kk * 32);
                    if (V == X3) {
                        wgmma_m64n128k8_tf32_ss(st, a_lo, b_hi, kk > 0 || run > 0);
                        wgmma_m64n128k8_tf32_ss(st, a_hi, b_lo);
                        wgmma_m64n128k8_tf32_ss(st, a_hi, b_hi);
                    } else {
                        wgmma_m64n128k8_tf32_ss(st, a_hi, b_hi, kk > 0 || run > 0);
                    }
                }
                wgmma_commit();
                dw_next_chunk(p, DW32_ROWS, tiles, cols, nd, nx);
                if (nx.u < tiles) stage(it + 1);  // under this chunk's products
                ++it;
                run = nx.u != u || run + 1 == DW32_FOLD ? 0 : run + 1;
                const float take = run == 0 ? 1.f : 0.f;  // fold now
                wgmma_wait<0>();
                wgmma_fence_regs(st);
#pragma unroll
                for (int i = 0; i < 64; ++i) sum[i] += take * st[i];  // the sum's bits, or sum + st's
                named_barrier(1, 256);  // the next chunk's tiles are whole; this chunk's buffer is free
            }
            float* out = w.hh ? p.dw_hh : p.dw_ih;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int m = w.m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * hr;
                if (m >= H4) continue;
#pragma unroll
                for (int n8 = 0; n8 < 16; ++n8) {
                    const int n = w.n0 + 8 * n8 + 2 * (lane & 3);  // and n + 1: D and H are even
                    if (n < w.N)
                        *reinterpret_cast<float2*>(out + (size_t)m * w.N + n) =
                            make_float2(sum[4 * n8 + 2 * hr], sum[4 * n8 + 2 * hr + 1]);
                }
            }
        }
    }
    // db's partial sums in the first buffer: each chunk's products were
    // waited for before its barrier
    dw_db(p, tiles, tid, *reinterpret_cast<float(*)[NT / DBC][DBC]>(bufs));
}

template <int V>
int launch_dw(const CUtensorMap* const (&maps)[3], const DwArgs32& p, int max_blocks, cudaStream_t s) {
    if (const int e = allow_smem<lstm_bwd_dw_kernel_tf32<V>, DW32_SMEM>()) return e;
    lstm_bwd_dw_kernel_tf32<V><<<dw_grid(p, max_blocks), THREADS, DW32_SMEM, s>>>(*maps[0], *maps[1], *maps[2], p);
    return static_cast<int>(cudaGetLastError());
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
// max_blocks caps the grid (the SM count); variant 0 is the kernel, 1 the
// kernel without its products (measuring).
extern "C" int oket_lstm_bwd_dw_bf16(const void* dg, const void* x, const void* hs, const void* lens,
                                     const void* db_part, void* dw_ih, void* dw_hh, void* db, int L, int B, int D,
                                     int H, int max_blocks, int variant, void* stream) {
    using namespace bf16;
    if (L < 1 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    DwArgs16 p;
    p.lens = static_cast<const int*>(lens);
    p.db_part = static_cast<const float*>(db_part);
    p.dw_ih = static_cast<uint16_t*>(dw_ih);
    p.dw_hh = static_cast<uint16_t*>(dw_hh);
    p.db = static_cast<float*>(db);
    p.B = B;
    p.D = D;
    p.H = H;
    p.L = L;
    // dg, x and hs as [L, B, columns] in boxes of 64 columns x 64 rows (rows
    // past B, columns past 4H, D or H read as zero)
    static thread_local oket_sm90::CachedMap cache[3];
    const uint64_t b = B, l = L;
    const uint32_t box[3] = {DW_BOX, DW_BOX, 1};
    const CUtensorMap* const maps[3] = {oket_sm90::bf16_map(cache[0], dg, {4 * (uint64_t)H, b, l}, box),
                                        oket_sm90::bf16_map(cache[1], x, {(uint64_t)D, b, l}, box),
                                        oket_sm90::bf16_map(cache[2], hs, {(uint64_t)H, b, l}, box)};
    for (const CUtensorMap* m : maps)
        if (!m) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == DW_KERNEL) return launch_dw<DW_KERNEL>(maps, p, max_blocks, s);
    if (variant == DW_NO_PRODUCTS) return launch_dw<DW_NO_PRODUCTS>(maps, p, max_blocks, s);
    return static_cast<int>(cudaErrorInvalidValue);
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

// After the loop: dW_ih [4H, D], dW_hh [4H, H] and db [4H].  max_blocks
// caps the grid (the SM count); variant 0 is 3xTF32, 1 the 1xTF32 check, 2
// the kernel without its products (measuring).
extern "C" int oket_lstm_bwd_dw_f32(const void* dg, const void* x, const void* hs, const void* lens,
                                    const void* db_part, void* dw_ih, void* dw_hh, void* db, int L, int B, int D,
                                    int H, int max_blocks, int variant, void* stream) {
    using namespace tf32;
    if (L < 1 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    DwArgs32 p;
    p.lens = static_cast<const int*>(lens);
    p.db_part = static_cast<const float*>(db_part);
    p.dw_ih = static_cast<float*>(dw_ih);
    p.dw_hh = static_cast<float*>(dw_hh);
    p.db = static_cast<float*>(db);
    p.B = B;
    p.D = D;
    p.H = H;
    p.L = L;
    // dg, x and hs as [L, B, columns] in boxes of 32 columns x 32 rows (rows
    // past B, columns past 4H, D or H read as zero)
    static thread_local oket_sm90::CachedMap cache[3];
    const uint64_t b = B, l = L;
    const uint32_t box[3] = {32, DW32_ROWS, 1};
    const CUtensorMap* const maps[3] = {oket_sm90::f32_map(cache[0], dg, {4 * (uint64_t)H, b, l}, box),
                                        oket_sm90::f32_map(cache[1], x, {(uint64_t)D, b, l}, box),
                                        oket_sm90::f32_map(cache[2], hs, {(uint64_t)H, b, l}, box)};
    for (const CUtensorMap* m : maps)
        if (!m) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == X3) return launch_dw<X3>(maps, p, max_blocks, s);
    if (variant == X1) return launch_dw<X1>(maps, p, max_blocks, s);
    if (variant == NO_PRODUCTS) return launch_dw<NO_PRODUCTS>(maps, p, max_blocks, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
