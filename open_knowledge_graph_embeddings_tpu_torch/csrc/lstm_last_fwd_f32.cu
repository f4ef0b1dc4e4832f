// Length-aware fused LSTM forward in f32 on Hopper's tensor cores (3xTF32),
// one time step per launch: the f32 mode of lstm_last_fwd.cu (kernels 1 and
// 5 of PERF.md's table).
//
// Replaces, for f32 inputs, the TPU kernels
// open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::_fused_fwd_last
// (kernel body _fused_fwd_last_kernel :479-522) and ::_fused_fwd (kernel body
// _fused_fwd_kernel :272-302), which take their inputs' dtype: torch gate
// order (i, f, g, o),
//   gates = x_t . W_ih^T + bias + h_{t-1} . W_hh^T   (f32-accurate products)
//   c_t = f * c_{t-1} + i * g,  h_t = o * tanh(c_t)   (f32)
// and each row's output is h at its step max(len, 1) (last-state mode, `last`
// given), with the hs / cs residuals in training (h_next = hs[t], cs_out =
// cs[t]), or h and c at every step a row reaches (every-state mode: `last`
// null; the positions a row never reaches hold unread garbage, as on the TPU,
// :266-269).  What the bf16 kernel computes, with its rounding points
// dropped: a rounding to f32 is the identity.
//
// Bound on an H100: tensor-core operations at the 3xTF32 rate (a sixth of
// the bf16 rate, 178 TFLOP/s at the 1980 MHz maximum SM clock), 2 * (D + H)
// * 4H per active (row, step) (no h product at t == 0); at D = H = 512 that
// is ~4 MFLOP against 2 KiB of token embedding read.  The flagship's cache
// chunk (B = 32768, L = 10) needs 3.12 ms there, 8.33 ms at the FFMA rate of
// the CUDA cores, which the kernel's FFMA design before this one reached at
// 38 %.
//
// Design: the 3xTF32 gate loop of lstm_tf32.cuh (its ring, split, fragment
// loads and products are the f32 backward's, lstm_last_bwd.cu), and the
// shape of bf16 kernel 1 (lstm_last_fwd.cu) around it:
//   * one split launch per call writes the hi and lo TF32 parts of W_ih and
//     W_hh, gate-major (2 x 8 MiB at d = 512); then one launch per step
//     (stream order is the grid-wide barrier between steps), persistent
//     over ops/lstm_kernel.py::forward_grid, 384 threads;
//   * warpgroup 2 gives its registers away (setmaxnreg 40; the consumers
//     take 232) and one of its threads loads each 32-wide K stage by TMA:
//     x at (t, row0) of emb [L, B, D], h_{t-1} at (its slot, row0) of the h
//     buffer [slots, B, H] (hs in training, written in place as the
//     residual; two slots in turns when serving), W_hi and W_lo as
//     [4][H][K], one box holding the four gate slabs of 32 units.  Rows past
//     B, units past H and K tails read as zero;
//   * warpgroups 0 and 1 share each of the block's 128-row x 32-unit x
//     4-gate tiles, 64 rows each (lstm_tf32.cuh::tile_products): the
//     bias seeds an f32 sum and the lengths are loaded; then the 3xTF32
//     products (wgmma m64n128k8, A split in registers), each K chunk of 32
//     summed by the tensor cores apart and added to the f32 sum (one
//     tensor-core accumulator over all of K was not accurate enough: the
//     recurrence on trained weights amplified its error past the f32
//     rule); then the epilogue in the thread that holds a cell's four
//     gates: c_{t-1}, the accurate sigmoidf / tanhf (lstm_gates.cuh, as the
//     plain version's torch.sigmoid / tanh), c updated in place in f32 (one
//     owner per cell), h_next, cs_out when given, and `last` at the row's
//     step max(len, 1).  Rows are sorted by descending length; only the
//     active prefix's row tiles are walked, and the finished rows inside an
//     active tile are computed and not written.
// On an H100 (chip_smoke.py; numbers in PERF.md) the kernel runs at ~60 %
// of its bound at B = 32768, under 0.4x cuDNN's f32 LSTM.  Without its
// epilogue it runs at the tensor cores' TF32 rate: what holds it is the
// epilogue, which both warpgroups run at once while the tensor cores wait.
// bf16 kernel 1's turns, where each warpgroup takes whole 128-row tiles and
// one's epilogue runs under the other's products, would need 256 registers
// a thread here: the fold keeps an f32 sum beside the tensor cores' chunk
// sum.
// The variants: the kernel (3xTF32); one TF32 product (hi.hi' alone) and
// one tensor-core accumulator over all of K (no fold), which chip_smoke.py
// plants and the f32 rule (on a trained model, for the second) must fail;
// and for measuring, the kernel without its epilogue (no loads of c, no
// stores) or without its products.  D and H multiples of 4 (TMA strides are multiples of 16 bytes;
// the wrapper checks this and the 16-byte alignment of each base pointer).

#include "lstm_gates.cuh"
#include "lstm_tf32.cuh"

namespace {

using namespace oket_tf32;
using oket_lstm::sigmoidf;

// What a launch runs (the C entry's `variant`): the kernel, the kernel
// without its epilogue, without its products, with one TF32 product, or
// with one tensor-core accumulator over all of K (no fold).
enum ForwardVariant { FULL = 0, NO_EPILOGUE = 1, FWD_NO_PRODUCTS = 2, ONE_TF32 = 3, UNFOLDED = 4 };

struct StepArgs {
    const float* bias;  // [4H]
    const int* lens;    // [B], sorted descending
    float* c;           // [B, H]
    float* h_next;      // [B, H]
    float* cs_out;      // [B, H] c_t, or null
    float* last;        // [B, H], or null (every-state mode)
    int B, D, H, t;
    int h_prev_slot;  // h_{t-1} is slot h_prev_slot of the h buffer
};

// P: what the products compute (lstm_tf32.cuh::Variant); EPI: whether the
// epilogue runs; FOLD: whether each K chunk is folded into the f32 sum.
template <int P, bool EPI, bool FOLD = true>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_fwd_step_kernel_tf32(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_h,
                              const __grid_constant__ CUtensorMap map_wih_hi,
                              const __grid_constant__ CUtensorMap map_wih_lo,
                              const __grid_constant__ CUtensorMap map_whh_hi,
                              const __grid_constant__ CUtensorMap map_whh_lo, const StepArgs p) {
    extern __shared__ uint8_t smem_raw[];
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
            produce(r, tiles, nk, [&](int tile, int kt, uint8_t* a, uint8_t* w_hi, uint8_t* w_lo, uint64_t* bar) {
                const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
                if (kt < nkx) {
                    tma_load_3d(a, &map_x, bar, kt * TK, row0, p.t);
                    tma_load_3d(w_hi, &map_wih_hi, bar, kt * TK, u0, 0);
                    tma_load_3d(w_lo, &map_wih_lo, bar, kt * TK, u0, 0);
                } else {
                    tma_load_3d(a, &map_h, bar, (kt - nkx) * TK, row0, p.h_prev_slot);
                    tma_load_3d(w_hi, &map_whh_hi, bar, (kt - nkx) * TK, u0, 0);
                    tma_load_3d(w_lo, &map_whh_lo, bar, (kt - nkx) * TK, u0, 0);
                }
            });
        }
    } else {
        setmaxnreg_inc<232>();
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        const int H = p.H, t = p.t;
        // sum[4 (g NB + n8) + e] holds gate g of row r0 + 8 (e/2), unit
        // u0 + 8 n8 + 2 (lane%4) + e%2, for r0 = row0 + 64 wg + 16 warp + lane/4
        float sum[TN / 2];
        int len[2];
        for (int q = 0;; ++q) {  // q: the tile's place in the block's sequence
            const int tile = blockIdx.x + q * gridDim.x;
            if (tile >= tiles) break;
            const int row0 = tile / unit_tiles * TM, u0 = tile % unit_tiles * TU;
            const int r0 = row0 + 64 * wg + warp * 16 + (lane >> 2);
            seed_bias(p.bias, H, u0, lane, sum);
            // the rows' lengths are loaded before the products, so their
            // latency hides under them; c_{t-1} is loaded in the epilogue
            // (held across the products too, it made ptxas spill 108 bytes
            // and the kernel 3-9 % slower on an H100)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = r0 + 8 * hr;
                len[hr] = row < n_act ? max(p.lens[row], 1) : 0;
            }
            // the finished rows of an active tile are multiplied all the same
            tile_products<P, FOLD>(r, q, nk, wg, warp, lane, sum);
            if constexpr (!EPI) {  // the sums stay computed, as in the kernel
#pragma unroll
                for (int i = 0; i < TN / 2; ++i) asm volatile("" ::"f"(sum[i]));
            }
            if constexpr (EPI) {
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    if (len[hr] <= t) continue;  // finished, or past B
                    const size_t ro = (size_t)(r0 + 8 * hr) * H;
                    const bool at_last = p.last && len[hr] == t + 1;
#pragma unroll
                    for (int n8 = 0; n8 < NB; ++n8) {
                        const int u = u0 + n8 * 8 + (lane & 3) * 2;  // and u + 1; H is even
                        if (u >= H) continue;
                        const float2 c_prev =
                            t > 0 ? *reinterpret_cast<const float2*>(p.c + ro + u) : make_float2(0.f, 0.f);
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
                        const float2 c2 = make_float2(c_new[0], c_new[1]), h2 = make_float2(h[0], h[1]);
                        *reinterpret_cast<float2*>(p.c + ro + u) = c2;
                        *reinterpret_cast<float2*>(p.h_next + ro + u) = h2;
                        if (p.cs_out) *reinterpret_cast<float2*>(p.cs_out + ro + u) = c2;
                        if (at_last) *reinterpret_cast<float2*>(p.last + ro + u) = h2;
                    }
                }
            }
        }
    }
}

template <int P, bool EPI, bool FOLD = true>
int launch(const CUtensorMap* const (&maps)[6], const StepArgs& p, int grid, cudaStream_t stream) {
    if (const int e = allow_smem<lstm_fwd_step_kernel_tf32<P, EPI, FOLD>, SMEM>()) return e;
    lstm_fwd_step_kernel_tf32<P, EPI, FOLD>
        <<<grid, THREADS, SMEM, stream>>>(*maps[0], *maps[1], *maps[2], *maps[3], *maps[4], *maps[5], p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Once per forward call, before the steps: the hi and lo parts of w_ih
// [4H, D] and w_hh [4H, H], gate-major, into w_split (2 * 4H * (D + H)
// floats: w_ih_hi, w_ih_lo, w_hh_hi, w_hh_lo).  Returns the cudaError_t of
// the launch.
extern "C" int oket_lstm_fwd_split_f32(const void* w_ih, const void* w_hh, void* w_split, int D, int H,
                                       void* stream) {
    return launch_split<false>(w_ih, w_hh, w_split, D, H, stream);
}

// One recurrence step t over rows [0, B), lengths sorted descending.  emb is
// the [L, B, D] input, h_buf an [h_slots, B, H] buffer whose slot
// h_prev_slot holds h_{t-1}; h_next (a slot of it), c, cs_out and last are
// [B, H]; w_split is the split launch's output.  All f32 but lens (int32).
// Pointers are 16-byte aligned device pointers, D % 4 == H % 4 == 0; cs_out
// and last may be null; grid is the number of persistent blocks; variant is
// 0 (the kernel), 1 (no epilogue), 2 (no products), 3 (1xTF32) or 4 (one
// accumulator, no fold); the stream is a cudaStream_t.  Returns the
// cudaError_t of the launch, or -1 if the driver could not encode the
// tensor maps.
extern "C" int oket_lstm_last_step_f32(const void* emb, const void* h_buf, const void* w_split, const void* bias,
                                       const void* lens, void* c, void* h_next, void* cs_out, void* last, int L,
                                       int B, int D, int H, int h_slots, int h_prev_slot, int t, int grid,
                                       int variant, void* stream) {
    StepArgs p;
    p.bias = static_cast<const float*>(bias);
    p.lens = static_cast<const int*>(lens);
    p.c = static_cast<float*>(c);
    p.h_next = static_cast<float*>(h_next);
    p.cs_out = static_cast<float*>(cs_out);
    p.last = static_cast<float*>(last);
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    p.h_prev_slot = h_prev_slot;
    // x_t and h_{t-1} in 128 x 32 boxes (rows past B read as zero); each
    // weight part as [4][H][K], one box holding the four gate slabs of 32
    // units (units past H and K tails read as zero)
    static thread_local oket_sm90::CachedMap cache[6];
    const SplitWeights w = split_parts(w_split, D, H);
    const uint64_t b = B, d = D, h = H;
    const uint32_t box_a[3] = {TK, TM, 1}, box_w[3] = {TK, TU, 4};
    const CUtensorMap* const maps[6] = {
        f32_map(cache[0], emb, {d, b, (uint64_t)L}, box_a), f32_map(cache[1], h_buf, {h, b, (uint64_t)h_slots}, box_a),
        f32_map(cache[2], w.wih_hi, {d, h, 4}, box_w),     f32_map(cache[3], w.wih_lo, {d, h, 4}, box_w),
        f32_map(cache[4], w.whh_hi, {h, h, 4}, box_w),     f32_map(cache[5], w.whh_lo, {h, h, 4}, box_w)};
    for (const CUtensorMap* m : maps)
        if (!m) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == FULL) return launch<X3, true>(maps, p, grid, s);
    if (variant == NO_EPILOGUE) return launch<X3, false>(maps, p, grid, s);
    if (variant == FWD_NO_PRODUCTS) return launch<NO_PRODUCTS, true>(maps, p, grid, s);
    if (variant == ONE_TF32) return launch<X1, true>(maps, p, grid, s);
    if (variant == UNFOLDED) return launch<X3, true, false>(maps, p, grid, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
