// Recurrence-only LSTM over a precomputed input projection, forward and
// backward, bf16 operands, f32 cell state and carries.
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
//     gates recomputed from x_proj[t] and hs[t-1] (h_0 = c_0 = 0)
//     dh = dh_carry + dhs[t],  c_t and c_{t-1} read from the bf16 cs
//     dgates as in lstm_last_bwd.cu (bwd_cell, lstm_gates.cuh)
//     dx_proj[t] = bf16(dgates),  dh_carry <- bf16(dgates) . W_hh (f32 accumulation),
//     dc_carry <- dc * f
// dW_hh = sum over t >= 1 of dx_proj[t]^T . hs[t-1] is one large product
// outside the kernels (ops/lstm_scan_kernel.py), as on the TPU (:201-206).
//
// Bound on an H100: about even.  Per (row, step) from step 1 on the forward
// does 2 * H * 4H operations (none at step 0, where h_0 = 0) and moves
// 4H + 2H bf16 values (x_proj in, hs and cs out): at H = 512 that is 2 MFLOP
// against 6 KiB, ~340 FLOP/byte, near the card's ~295 ridge.  The backward
// does twice the operations (recompute and dh) and moves 4H + 4H + 3H values.
//
// Design.  The forward and backward of lstm_last_fwd.cu / lstm_last_bwd.cu
// with the x part of the gate product gone (D = 0 in lstm_gates.cuh) and
// x_proj[t] added in the epilogue; W_hh (2 MiB at H = 512) streams from L2.
//   * lstm_scan_step_kernel, one launch per step: a block owns BM rows x BN
//     units and all four gate columns of its units, so the cell update stays
//     in the thread that holds the four accumulators; c is f32 in place.
//   * lstm_scan_bwd_gate_kernel, per step: the same gate product and the
//     backward cell math; writes dx_proj[t] and updates dc in place.
//   * lstm_bwd_product_kernel (lstm_product.cuh, shared with lstm_last_bwd.cu)
//     with no W_ih part and every row active: dh_carry = dx_proj[t] . W_hh over
//     K = 4H, from step 1 on (the dh of step 0 is never read, so the wrapper
//     does not launch it at t = 0).
// Any B; H a multiple of 8.  Rows and units past B and H are masked.
//
// The f32 mode (the *_f32 entries; the TPU kernels take their inputs' dtype):
// the same three launches for f32 x_proj, w_hh, hs, cs, dhs and dx_proj, with
// the rounding points dropped, every product in true f32 FFMA on the CUDA
// cores (lstm_f32.cuh::gate_product_f32 and lstm_bwd_product_kernel_f32;
// no TF32), bound by FP32 operations; H a multiple of 4.  Any other H
// reaches the kernels zero-padded by the wrapper (ops/lstm_scan_kernel.py).

#include "lstm_f32.cuh"

namespace {

using namespace oket_lstm;

// Every row of [0, B) is active at every step: s_len[r] = t + 1, and 0 past B.
__device__ __forceinline__ void all_rows(long long B, long long row0, int t, int* s_len) {
    for (int r = threadIdx.x; r < BM; r += NT) s_len[r] = row0 + r < B ? t + 1 : 0;
    __syncthreads();
}

struct ScanArgs {
    GateArgs g;            // D = 0; h_prev = hs[t-1], unread at t == 0
    const uint16_t* xp;    // [B, 4H] x_proj[t]
    float* c;              // [B, H] f32 cell state, updated in place
    uint16_t* hs_t;        // [B, H] out: bf16(h_t)
    uint16_t* cs_t;        // [B, H] out: bf16(c_t)
};

__global__ void __launch_bounds__(NT) lstm_scan_step_kernel(const ScanArgs p) {
    __shared__ __align__(16) TileA As[2];
    __shared__ __align__(16) TileW Bs[2];
    __shared__ int s_len[BM];

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;
    const int t = p.g.t, H = p.g.H;
    all_rows(p.g.B, row0, t, s_len);

    float acc[2][4][2][4];
    gate_product(p.g, row0, j0, s_len, As, Bs, acc);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = wm * WM + mi * 16 + gid + ((e >> 1) << 3);
                const int j = j0 + wn * WN + ni * 8 + tig * 2 + (e & 1);
                if (s_len[r] == 0 || j >= H) continue;
                const uint16_t* xp = p.xp + (size_t)(row0 + r) * 4 * H + j;
                const float gi = sigmoidf(acc[mi][0][ni][e] + bf16_to_f32(xp[0]));
                const float gf = sigmoidf(acc[mi][1][ni][e] + bf16_to_f32(xp[H]));
                const float gg = tanhf(acc[mi][2][ni][e] + bf16_to_f32(xp[2 * H]));
                const float go = sigmoidf(acc[mi][3][ni][e] + bf16_to_f32(xp[3 * H]));
                const size_t o = (size_t)(row0 + r) * H + j;
                const float c_prev = t > 0 ? p.c[o] : 0.f;
                const float c_new = gf * c_prev + gi * gg;
                p.c[o] = c_new;
                p.hs_t[o] = f32_to_bf16(go * tanhf(c_new));
                p.cs_t[o] = f32_to_bf16(c_new);
            }
}

struct ScanBwdArgs {
    GateArgs g;               // D = 0; h_prev = hs[t-1], unread at t == 0
    const uint16_t* xp;       // [B, 4H] x_proj[t]
    const uint16_t* cs_t;     // [B, H] bf16(c_t)
    const uint16_t* cs_prev;  // [B, H] bf16(c_{t-1}); unread at t == 0
    const uint16_t* dhs_t;    // [B, H] the cotangent of hs[t]
    const float* dh;          // [B, H] dh carry from step t+1 (0 at t = L-1)
    float* dc;                // [B, H] dc carry in, dc * f out
    uint16_t* dxp;            // [B, 4H] out: bf16(dgates) of step t
};

__global__ void __launch_bounds__(NT) lstm_scan_bwd_gate_kernel(const ScanBwdArgs p) {
    __shared__ __align__(16) TileA As[2];
    __shared__ __align__(16) TileW Bs[2];
    __shared__ int s_len[BM];

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;
    const int t = p.g.t, H = p.g.H;
    all_rows(p.g.B, row0, t, s_len);

    float acc[2][4][2][4];
    gate_product(p.g, row0, j0, s_len, As, Bs, acc);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = wm * WM + mi * 16 + gid + ((e >> 1) << 3);
                const int j = j0 + wn * WN + ni * 8 + tig * 2 + (e & 1);
                if (s_len[r] == 0 || j >= H) continue;
                const size_t row = (size_t)(row0 + r);
                const uint16_t* xp = p.xp + row * 4 * H + j;
                const float pre[4] = {acc[mi][0][ni][e] + bf16_to_f32(xp[0]), acc[mi][1][ni][e] + bf16_to_f32(xp[H]),
                                      acc[mi][2][ni][e] + bf16_to_f32(xp[2 * H]),
                                      acc[mi][3][ni][e] + bf16_to_f32(xp[3 * H])};
                const size_t o = row * H + j;
                const float c_t = bf16_to_f32(p.cs_t[o]);
                const float c_prev = t > 0 ? bf16_to_f32(p.cs_prev[o]) : 0.f;
                const float dh = p.dh[o] + bf16_to_f32(p.dhs_t[o]);
                float d[4];
                p.dc[o] = bwd_cell(pre, c_t, c_prev, dh, p.dc[o], d);
                uint16_t* dxp = p.dxp + row * 4 * H + j;
#pragma unroll
                for (int g = 0; g < 4; ++g) dxp[(size_t)g * H] = f32_to_bf16(d[g]);
            }
}

GateArgs recurrent_args(const void* h_prev, const void* w_hh, long long B, int H, int t) {
    GateArgs g;
    g.x = nullptr;
    g.h_prev = static_cast<const uint16_t*>(h_prev);
    g.w_ih = nullptr;
    g.w_hh = static_cast<const uint16_t*>(w_hh);
    g.B = B;
    g.D = 0;
    g.H = H;
    g.t = t;
    return g;
}

dim3 step_grid(long long B, int H) { return dim3((unsigned)((B + BM - 1) / BM), (unsigned)((H + BN - 1) / BN)); }

// ------------------------------------------------------------------ f32 mode

struct ScanArgsF32 {
    GateArgsF32 g;    // h_prev = hs[t-1], unread at t == 0
    const float* xp;  // [B, 4H] x_proj[t]
    float* c;         // [B, H] cell state, updated in place
    float* hs_t;      // [B, H] out: h_t
    float* cs_t;      // [B, H] out: c_t
};

__global__ void __launch_bounds__(NT) lstm_scan_step_kernel_f32(const ScanArgsF32 p) {
    __shared__ __align__(16) TileAF As[2];
    __shared__ __align__(16) TileWF Bs[2];
    __shared__ int s_len[BM];

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;
    const int t = p.g.t, H = p.g.H;
    all_rows(p.g.B, row0, t, s_len);

    float acc[FRM][4][FUN];
    gate_product_f32(p.g, row0, j0, s_len, As, Bs, acc);

#pragma unroll
    for (int i = 0; i < FRM; ++i) {
        const int r = f32_row(i);
        if (s_len[r] == 0) continue;
#pragma unroll
        for (int u = 0; u < FUN; ++u) {
            const int j = j0 + f32_unit(u);
            if (j >= H) continue;
            const float* xp = p.xp + (size_t)(row0 + r) * 4 * H + j;
            const float gi = sigmoidf(acc[i][0][u] + xp[0]);
            const float gf = sigmoidf(acc[i][1][u] + xp[H]);
            const float gg = tanhf(acc[i][2][u] + xp[2 * H]);
            const float go = sigmoidf(acc[i][3][u] + xp[3 * H]);
            const size_t o = (size_t)(row0 + r) * H + j;
            const float c_prev = t > 0 ? p.c[o] : 0.f;
            const float c_new = gf * c_prev + gi * gg;
            p.c[o] = c_new;
            p.hs_t[o] = go * tanhf(c_new);
            p.cs_t[o] = c_new;
        }
    }
}

struct ScanBwdArgsF32 {
    GateArgsF32 g;         // h_prev = hs[t-1], unread at t == 0
    const float* xp;       // [B, 4H] x_proj[t]
    const float* cs_t;     // [B, H] c_t
    const float* cs_prev;  // [B, H] c_{t-1}; unread at t == 0
    const float* dhs_t;    // [B, H] the cotangent of hs[t]
    const float* dh;       // [B, H] dh carry from step t+1 (0 at t = L-1)
    float* dc;             // [B, H] dc carry in, dc * f out
    float* dxp;            // [B, 4H] out: dgates of step t
};

__global__ void __launch_bounds__(NT) lstm_scan_bwd_gate_kernel_f32(const ScanBwdArgsF32 p) {
    __shared__ __align__(16) TileAF As[2];
    __shared__ __align__(16) TileWF Bs[2];
    __shared__ int s_len[BM];

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;
    const int t = p.g.t, H = p.g.H;
    all_rows(p.g.B, row0, t, s_len);

    float acc[FRM][4][FUN];
    gate_product_f32(p.g, row0, j0, s_len, As, Bs, acc);

#pragma unroll
    for (int i = 0; i < FRM; ++i) {
        const int r = f32_row(i);
        if (s_len[r] == 0) continue;
#pragma unroll
        for (int u = 0; u < FUN; ++u) {
            const int j = j0 + f32_unit(u);
            if (j >= H) continue;
            const size_t row = (size_t)(row0 + r);
            const float* xp = p.xp + row * 4 * H + j;
            const float pre[4] = {acc[i][0][u] + xp[0], acc[i][1][u] + xp[H], acc[i][2][u] + xp[2 * H],
                                  acc[i][3][u] + xp[3 * H]};
            const size_t o = row * H + j;
            const float c_prev = t > 0 ? p.cs_prev[o] : 0.f;
            float d[4];
            p.dc[o] = bwd_cell(pre, p.cs_t[o], c_prev, p.dh[o] + p.dhs_t[o], p.dc[o], d);
            float* dxp = p.dxp + row * 4 * H + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) dxp[(size_t)g * H] = d[g];
        }
    }
}

GateArgsF32 recurrent_args_f32(const void* h_prev, const void* w_hh, long long B, int H, int t) {
    GateArgsF32 g;
    g.h_prev = static_cast<const float*>(h_prev);
    g.w_hh = static_cast<const float*>(w_hh);
    g.B = B;
    g.H = H;
    g.t = t;
    return g;
}

}  // namespace

// Forward step t over rows [0, B): x_proj[t] [B, 4H], h_prev = hs[t-1] (any
// valid pointer at t == 0), w_hh [4H, H], the f32 cell state c [B, H] (in
// place), hs[t] and cs[t] out.  Pointers are 16-byte aligned device pointers,
// H % 8 == 0; the stream is a cudaStream_t.  Returns the cudaError_t of the launch.
extern "C" int oket_lstm_scan_step_bf16(const void* xp, const void* h_prev, const void* w_hh, void* c, void* hs_t,
                                        void* cs_t, long long B, int H, int t, void* stream) {
    ScanArgs p;
    p.g = recurrent_args(h_prev, w_hh, B, H, t);
    p.xp = static_cast<const uint16_t*>(xp);
    p.c = static_cast<float*>(c);
    p.hs_t = static_cast<uint16_t*>(hs_t);
    p.cs_t = static_cast<uint16_t*>(cs_t);
    lstm_scan_step_kernel<<<step_grid(B, H), NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// Backward step t, part 1 (gate recompute and cell math): dx_proj[t] out, the
// dc carry in place; dh is the carry written by part 2 of step t+1.
extern "C" int oket_lstm_scan_bwd_gate_bf16(const void* xp, const void* h_prev, const void* w_hh, const void* cs_t,
                                            const void* cs_prev, const void* dhs_t, const void* dh, void* dc,
                                            void* dxp, long long B, int H, int t, void* stream) {
    ScanBwdArgs p;
    p.g = recurrent_args(h_prev, w_hh, B, H, t);
    p.xp = static_cast<const uint16_t*>(xp);
    p.cs_t = static_cast<const uint16_t*>(cs_t);
    p.cs_prev = static_cast<const uint16_t*>(cs_prev);
    p.dhs_t = static_cast<const uint16_t*>(dhs_t);
    p.dh = static_cast<const float*>(dh);
    p.dc = static_cast<float*>(dc);
    p.dxp = static_cast<uint16_t*>(dxp);
    lstm_scan_bwd_gate_kernel<<<step_grid(B, H), NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// Backward step t, part 2 (t > 0): dh carry [B, H] = dx_proj[t] . W_hh, f32.
extern "C" int oket_lstm_scan_bwd_product_bf16(const void* dxp, const void* w_hh, void* dh, long long B, int H, int t,
                                               void* stream) {
    ProdArgs p;
    p.dg = static_cast<const uint16_t*>(dxp);
    p.w_hh = static_cast<const uint16_t*>(w_hh);
    p.w_ih = nullptr;
    p.lens = nullptr;
    p.dh = static_cast<float*>(dh);
    p.demb = nullptr;
    p.B = B;
    p.D = 0;
    p.H = H;
    p.t = t;
    return launch_bwd_product(p, stream);
}

// The f32 mode: the same three entries for f32 x_proj, w_hh, hs, cs, dhs and
// dx_proj (c, dh and dc f32, as in the bf16 entries); H % 4 == 0.
extern "C" int oket_lstm_scan_step_f32(const void* xp, const void* h_prev, const void* w_hh, void* c, void* hs_t,
                                       void* cs_t, long long B, int H, int t, void* stream) {
    ScanArgsF32 p;
    p.g = recurrent_args_f32(h_prev, w_hh, B, H, t);
    p.xp = static_cast<const float*>(xp);
    p.c = static_cast<float*>(c);
    p.hs_t = static_cast<float*>(hs_t);
    p.cs_t = static_cast<float*>(cs_t);
    lstm_scan_step_kernel_f32<<<step_grid(B, H), NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int oket_lstm_scan_bwd_gate_f32(const void* xp, const void* h_prev, const void* w_hh, const void* cs_t,
                                           const void* cs_prev, const void* dhs_t, const void* dh, void* dc,
                                           void* dxp, long long B, int H, int t, void* stream) {
    ScanBwdArgsF32 p;
    p.g = recurrent_args_f32(h_prev, w_hh, B, H, t);
    p.xp = static_cast<const float*>(xp);
    p.cs_t = static_cast<const float*>(cs_t);
    p.cs_prev = static_cast<const float*>(cs_prev);
    p.dhs_t = static_cast<const float*>(dhs_t);
    p.dh = static_cast<const float*>(dh);
    p.dc = static_cast<float*>(dc);
    p.dxp = static_cast<float*>(dxp);
    lstm_scan_bwd_gate_kernel_f32<<<step_grid(B, H), NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int oket_lstm_scan_bwd_product_f32(const void* dxp, const void* w_hh, void* dh, long long B, int H, int t,
                                              void* stream) {
    ProdArgsF32 p;
    p.dg = static_cast<const float*>(dxp);
    p.w_hh = static_cast<const float*>(w_hh);
    p.dh = static_cast<float*>(dh);
    p.B = B;
    p.H = H;
    p.t = t;
    return launch_bwd_product_f32(p, stream);
}
