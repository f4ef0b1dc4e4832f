// Length-aware fused LSTM forward, one time step per launch, bf16 in / f32 state.
//
// Replaces the forward half of the TPU kernel
// open_knowledge_graph_embeddings_tpu/ops/pallas/lstm_kernel.py::_fused_fwd_last
// (kernel body _fused_fwd_last_kernel): torch gate order (i, f, g, o),
//   gates = x_t . W_ih^T + bias + bf16(h_{t-1}) . W_hh^T   (f32 accumulation)
//   c_t = f * c_{t-1} + i * g,  h_t = o * tanh(c_t)        (f32)
// and each row's output is bf16(h) at its step max(len, 1).
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
//     columns {j, H+j, 2H+j, 3H+j} of its units, so the gate math, the cell
//     update and the last-state select stay inside the thread that holds the
//     four accumulators;
//   * K runs over the x part (D) and then the h part (H) into one f32
//     accumulator; tiles of A (x or h rows) and of the gate-major weights are
//     staged through shared memory with cp.async, double buffered, and
//     multiplied with mma.sync m16n8k16 (bf16 in, f32 accumulate);
//   * rows are sorted by descending length, so the rows active at step t are a
//     prefix: a block with no active row exits before loading anything, and
//     inactive rows inside an active block are zero-filled and not written;
//   * h lives in two bf16 buffers that alternate between steps (the value the
//     next step's product consumes is exactly bf16(h)), c is f32 and updated in
//     place (a (row, unit) cell has one owner per step);
//   * the hs / cs residuals of the TPU forward feed only its backward and are
//     not written here.
// Any B; D and H multiples of 8 (every tile row is whole 16-byte copies; the
// wrapper checks this and the 16-byte alignment of each base pointer).  Rows,
// units and K tails are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // rows per block
constexpr int BN = 32;       // hidden units per block (x4 gates = 128 weight rows)
constexpr int BK = 32;       // K tile
constexpr int NT = 256;      // 8 warps: 4 along rows x 2 along units
constexpr int LDS = BK + 8;  // smem row stride (80 B: 16-byte aligned, conflict-free fragments)
constexpr int WM = 32;       // rows per warp
constexpr int WN = 16;       // units per warp

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
    uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

struct StepArgs {
    const uint16_t* x;       // [B, D] this step's token embeddings
    const uint16_t* h_prev;  // [B, H] bf16(h_{t-1}); unread at t == 0
    const uint16_t* w_ih;    // [4H, D]
    const uint16_t* w_hh;    // [4H, H]
    const float* bias;       // [4H]
    const int* lens;         // [B]
    float* c;                // [B, H]
    uint16_t* h_next;        // [B, H]
    uint16_t* last;          // [B, H]
    long long B;
    int D, H, t;
};

// Stage K tile `kt` (x part first, then h part) of A and of the weights.
__device__ __forceinline__ void load_tile(const StepArgs& p, int kt, int nk0, long long row0, int j0,
                                          const int* s_len, uint16_t (*As)[LDS], uint16_t (*Bs)[LDS]) {
    const bool hpart = kt >= nk0;
    const int k0 = (hpart ? kt - nk0 : kt) * BK;
    const int K = hpart ? p.H : p.D;
    const uint16_t* a = hpart ? p.h_prev : p.x;
    const uint16_t* w = hpart ? p.w_hh : p.w_ih;
    constexpr int CH = BK / 8;  // 16-byte chunks per tile row
    // Each source address is formed before the select: the kernel ran slower
    // on an H100 with the address arithmetic inside the select.

    for (int i = threadIdx.x; i < BM * CH; i += NT) {
        const int r = i / CH, kc = (i % CH) * 8, k = k0 + kc;
        const uint16_t* src = a + (size_t)(row0 + r) * K + k;
        const bool ok = s_len[r] > p.t && k < K;  // rows past B have s_len 0
        cp_async16(&As[r][kc], ok ? src : a, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < 4 * BN * CH; i += NT) {
        const int n = i / CH, kc = (i % CH) * 8, k = k0 + kc;
        const int g = n / BN, j = j0 + n % BN;
        const uint16_t* src = w + ((size_t)g * p.H + j) * K + k;
        const bool ok = j < p.H && k < K;
        cp_async16(&Bs[n][kc], ok ? src : w, ok ? 16 : 0);
    }
}

__global__ void __launch_bounds__(NT) lstm_last_step_kernel(const StepArgs p) {
    __shared__ __align__(16) uint16_t As[2][BM][LDS];
    __shared__ __align__(16) uint16_t Bs[2][4 * BN][LDS];
    __shared__ int s_len[BM];

    const long long row0 = (long long)blockIdx.x * BM;
    const int j0 = blockIdx.y * BN;

    int any = 0;
    for (int r = threadIdx.x; r < BM; r += NT) {
        const long long row = row0 + r;
        const int len = row < p.B ? max(p.lens[row], 1) : 0;
        s_len[r] = len;
        any |= len > p.t;
    }
    if (!__syncthreads_or(any)) return;

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int wm = warp & 3, wn = warp >> 2;

    float acc[2][4][2][4];  // [m16 tile][gate][n8 tile][fragment]
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mi][g][ni][e] = 0.f;

    const int nk0 = (p.D + BK - 1) / BK;
    const int nk = nk0 + (p.t > 0 ? (p.H + BK - 1) / BK : 0);  // h_0 = 0: no h part at t == 0

    load_tile(p, 0, nk0, row0, j0, s_len, As[0], Bs[0]);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt & 1;
        if (kt + 1 < nk) load_tile(p, kt + 1, nk0, row0, j0, s_len, As[s ^ 1], Bs[s ^ 1]);
        cp_async_commit();
        cp_async_wait_1();
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[2][4], b[4][2][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int r = wm * WM + mi * 16 + gid;
                a[mi][0] = ld_pair(&As[s][r][kk + tig * 2]);
                a[mi][1] = ld_pair(&As[s][r + 8][kk + tig * 2]);
                a[mi][2] = ld_pair(&As[s][r][kk + tig * 2 + 8]);
                a[mi][3] = ld_pair(&As[s][r + 8][kk + tig * 2 + 8]);
            }
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
                for (int ni = 0; ni < 2; ++ni) {
                    const int n = g * BN + wn * WN + ni * 8 + gid;
                    b[g][ni][0] = ld_pair(&Bs[s][n][kk + tig * 2]);
                    b[g][ni][1] = ld_pair(&Bs[s][n][kk + tig * 2 + 8]);
                }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int g = 0; g < 4; ++g)
#pragma unroll
                    for (int ni = 0; ni < 2; ++ni) mma_bf16(acc[mi][g][ni], a[mi], b[g][ni]);
        }
        __syncthreads();
    }

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
                if (len <= p.t || j >= p.H) continue;
                const float gi = sigmoidf(acc[mi][0][ni][e] + p.bias[j]);
                const float gf = sigmoidf(acc[mi][1][ni][e] + p.bias[p.H + j]);
                const float gg = tanhf(acc[mi][2][ni][e] + p.bias[2 * p.H + j]);
                const float go = sigmoidf(acc[mi][3][ni][e] + p.bias[3 * p.H + j]);
                const size_t o = (size_t)(row0 + r) * p.H + j;
                const float c_prev = p.t > 0 ? p.c[o] : 0.f;
                const float c_new = gf * c_prev + gi * gg;
                const uint16_t h = __bfloat16_as_ushort(__float2bfloat16(go * tanhf(c_new)));
                p.c[o] = c_new;
                p.h_next[o] = h;
                if (len == p.t + 1) p.last[o] = h;
            }
}

}  // namespace

// One recurrence step t over rows [0, B).  Pointers are 16-byte aligned device
// pointers, D % 8 == H % 8 == 0; the stream is a cudaStream_t.  Returns the cudaError_t of the launch.
extern "C" int oket_lstm_last_step_bf16(const void* x, const void* h_prev, const void* w_ih,
                                        const void* w_hh, const void* bias, const void* lens, void* c,
                                        void* h_next, void* last, long long B, int D, int H, int t,
                                        void* stream) {
    StepArgs p;
    p.x = static_cast<const uint16_t*>(x);
    p.h_prev = static_cast<const uint16_t*>(h_prev);
    p.w_ih = static_cast<const uint16_t*>(w_ih);
    p.w_hh = static_cast<const uint16_t*>(w_hh);
    p.bias = static_cast<const float*>(bias);
    p.lens = static_cast<const int*>(lens);
    p.c = static_cast<float*>(c);
    p.h_next = static_cast<uint16_t*>(h_next);
    p.last = static_cast<uint16_t*>(last);
    p.B = B;
    p.D = D;
    p.H = H;
    p.t = t;
    const dim3 grid((unsigned)((B + BM - 1) / BM), (unsigned)((H + BN - 1) / BN));
    lstm_last_step_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}
