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
// so the kernel is bound by tensor-core operations, not by device memory.
//
// Design.  The TPU kernel keeps both weight matrices resident in VMEM for the
// whole recurrence; at H = 512 they are 4 MiB in bf16, far above the 227 KB of
// shared memory a block has.  So the recurrence is split into one launch per
// step (stream order is the grid-wide barrier between steps) and the weights
// stream from L2 (4 MiB fits the 50 MB L2 many times over):
//   * a block owns BM rows x BN hidden units and computes all four gate
//     columns {j, H+j, 2H+j, 3H+j} of its units (lstm_gates.cuh), so the gate
//     math, the cell update and the last-state select stay inside the thread
//     that holds the four accumulators;
//   * rows are sorted by descending length, so the rows active at step t are a
//     prefix: a block with no active row exits before loading anything, and
//     inactive rows inside an active block are zero-filled and not written;
//   * h is written as bf16 (the value the next step's product consumes is
//     exactly bf16(h)), c is f32 and updated in place (a (row, unit) cell has
//     one owner per step);
//   * for training and the every-state mode, the caller passes h_next = hs[t]
//     and cs_out = cs[t]: the hs / cs residuals of the TPU forward
//     (:510-511), in bf16, which the backward (lstm_last_bwd.cu) reads.
//     Serving passes two alternating h buffers and no cs_out, and writes
//     nothing more.
// Any B; D and H multiples of 8 (every tile row is whole 16-byte copies; the
// wrapper checks this and the 16-byte alignment of each base pointer).  Rows,
// units and K tails are masked.

#include "lstm_gates.cuh"

namespace {

using namespace oket_lstm;

struct StepArgs {
    GateArgs g;
    const float* bias;  // [4H]
    const int* lens;    // [B]
    float* c;           // [B, H]
    uint16_t* h_next;   // [B, H]
    uint16_t* cs_out;   // [B, H] bf16(c_t), or null
    uint16_t* last;     // [B, H], or null (every-state mode)
};

__global__ void __launch_bounds__(NT) lstm_last_step_kernel(const StepArgs p) {
    __shared__ __align__(16) TileA As[2];
    __shared__ __align__(16) TileW Bs[2];
    __shared__ int s_len[BM];

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;
    const int t = p.g.t, H = p.g.H;
    if (!load_lengths(p.lens, p.g.B, row0, t, s_len)) return;

    float acc[2][4][2][4];
    gate_product(p.g, row0, j0, s_len, As, Bs, acc);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;
    // epilogue: the four gates of one (row, unit) cell sit in one thread
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
                const float gi = sigmoidf(acc[mi][0][ni][e] + p.bias[j]);
                const float gf = sigmoidf(acc[mi][1][ni][e] + p.bias[H + j]);
                const float gg = tanhf(acc[mi][2][ni][e] + p.bias[2 * H + j]);
                const float go = sigmoidf(acc[mi][3][ni][e] + p.bias[3 * H + j]);
                const size_t o = (size_t)(row0 + r) * H + j;
                const float c_prev = t > 0 ? p.c[o] : 0.f;
                const float c_new = gf * c_prev + gi * gg;
                const uint16_t h = f32_to_bf16(go * tanhf(c_new));
                p.c[o] = c_new;
                p.h_next[o] = h;
                if (p.cs_out) p.cs_out[o] = f32_to_bf16(c_new);
                if (p.last && len == t + 1) p.last[o] = h;
            }
}

}  // namespace

// One recurrence step t over rows [0, B).  Pointers are 16-byte aligned device
// pointers, D % 8 == H % 8 == 0; cs_out and last may be null; the stream is a
// cudaStream_t.  Returns the cudaError_t of the launch.
extern "C" int oket_lstm_last_step_bf16(const void* x, const void* h_prev, const void* w_ih,
                                        const void* w_hh, const void* bias, const void* lens, void* c,
                                        void* h_next, void* cs_out, void* last, long long B, int D,
                                        int H, int t, void* stream) {
    StepArgs p;
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
    p.c = static_cast<float*>(c);
    p.h_next = static_cast<uint16_t*>(h_next);
    p.cs_out = static_cast<uint16_t*>(cs_out);
    p.last = static_cast<uint16_t*>(last);
    const dim3 grid((unsigned)((B + BM - 1) / BM), (unsigned)((H + BN - 1) / BN));
    lstm_last_step_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
