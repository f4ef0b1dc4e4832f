// Length-aware fused LSTM forward in f32, one time step per launch: the f32
// mode of lstm_last_fwd.cu (kernels 1 and 5 of PERF.md's table).
//
// Replaces, for f32 inputs, the TPU kernels
// open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::_fused_fwd_last
// (kernel body _fused_fwd_last_kernel :479-522) and ::_fused_fwd (kernel body
// _fused_fwd_kernel :272-302), which take their inputs' dtype: torch gate
// order (i, f, g, o),
//   gates = x_t . W_ih^T + bias + h_{t-1} . W_hh^T   (f32 operands, f32 FFMA)
//   c_t = f * c_{t-1} + i * g,  h_t = o * tanh(c_t)   (f32)
// and each row's output is h at its step max(len, 1) (last-state mode, `last`
// given), with the hs / cs residuals in training (h_next = hs[t], cs_out =
// cs[t]), or h and c at every step a row reaches (every-state mode: `last`
// null; the positions a row never reaches hold unread garbage, as on the TPU,
// :266-269).  What the bf16 kernel computes, with its rounding points
// dropped: a rounding to f32 is the identity.
//
// Bound on an H100: FP32 operations, 2 * (D + H) * 4H per active (row, step)
// (no h product at t == 0) on the CUDA cores; at D = H = 512 that is ~4 MFLOP
// against 2 KiB of token embedding read.
//
// Design.  The one-launch-per-step form the bf16 kernel had before its
// Hopper redesign, with lstm_f32.cuh::gate_product_f32 as the gate product:
// stream order is the grid-wide barrier between steps, the weights (8 MiB at
// H = 512) stream from L2, a
// block owns BM rows x BN hidden units and all four gate columns of its units
// so the cell update and the last-state select stay in the thread that holds
// the four accumulators, rows are sorted by descending length so a block
// whose rows are all finished exits before loading anything, c is updated in
// place (one owner per cell).  The gate math keeps the accurate expf / tanhf
// (lstm_gates.cuh::sigmoidf), as the plain version's torch.sigmoid / tanh.
// Any B; D and H multiples of 4 (16-byte copies; the wrapper checks this and
// the 16-byte alignment of each base pointer).

#include "lstm_f32.cuh"

namespace {

using namespace oket_lstm;

struct StepArgsF32 {
    GateArgsF32 g;
    const float* bias;  // [4H]
    const int* lens;    // [B]
    float* c;           // [B, H]
    float* h_next;      // [B, H]
    float* cs_out;      // [B, H] c_t, or null
    float* last;        // [B, H], or null (every-state mode)
};

__global__ void __launch_bounds__(NT) lstm_last_step_kernel_f32(const StepArgsF32 p) {
    __shared__ __align__(16) TileAF As[2];
    __shared__ __align__(16) TileWF Bs[2];
    __shared__ int s_len[BM];

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;
    const int t = p.g.t, H = p.g.H;
    if (!load_lengths(p.lens, p.g.B, row0, t, s_len)) return;

    float acc[FRM][4][FUN];
    gate_product_f32(p.g, row0, j0, s_len, As, Bs, acc);

    // epilogue: the four gates of one (row, unit) cell sit in one thread
#pragma unroll
    for (int i = 0; i < FRM; ++i) {
        const int r = f32_row(i);
        const int len = s_len[r];
        if (len <= t) continue;
#pragma unroll
        for (int u = 0; u < FUN; ++u) {
            const int j = j0 + f32_unit(u);
            if (j >= H) continue;
            const float gi = sigmoidf(acc[i][0][u] + p.bias[j]);
            const float gf = sigmoidf(acc[i][1][u] + p.bias[H + j]);
            const float gg = tanhf(acc[i][2][u] + p.bias[2 * H + j]);
            const float go = sigmoidf(acc[i][3][u] + p.bias[3 * H + j]);
            const size_t o = (size_t)(row0 + r) * H + j;
            const float c_prev = t > 0 ? p.c[o] : 0.f;
            const float c_new = gf * c_prev + gi * gg;
            const float h = go * tanhf(c_new);
            p.c[o] = c_new;
            p.h_next[o] = h;
            if (p.cs_out) p.cs_out[o] = c_new;
            if (p.last && len == t + 1) p.last[o] = h;
        }
    }
}

}  // namespace

// One recurrence step t over rows [0, B): x = emb[t] [B, D], h_prev = h_{t-1}
// [B, H] (unread at t == 0), gate-major w_ih [4H, D] and w_hh [4H, H], bias
// [4H], lens [B] sorted descending, the cell state c [B, H] (in place),
// h_next [B, H] out, cs_out and last [B, H] out or null.  All f32 but lens.
// Pointers are 16-byte aligned device pointers, D % 4 == H % 4 == 0; the
// stream is a cudaStream_t.  Returns the cudaError_t of the launch.
extern "C" int oket_lstm_last_step_f32(const void* x, const void* h_prev, const void* w_ih, const void* w_hh,
                                       const void* bias, const void* lens, void* c, void* h_next, void* cs_out,
                                       void* last, long long B, int D, int H, int t, void* stream) {
    StepArgsF32 p;
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
    p.c = static_cast<float*>(c);
    p.h_next = static_cast<float*>(h_next);
    p.cs_out = static_cast<float*>(cs_out);
    p.last = static_cast<float*>(last);
    const dim3 grid((unsigned)((B + BM - 1) / BM), (unsigned)((H + BN - 1) / BN));
    lstm_last_step_kernel_f32<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
