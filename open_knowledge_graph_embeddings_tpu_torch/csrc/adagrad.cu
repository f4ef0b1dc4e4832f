// The two Adagrad updates of the training step, in f32 with torch semantics:
// the dense update of every leaf of a regime group in one launch, and the
// row-sparse update (lazy weight decay) of every sparse table of a group in
// one launch.  For each leaf (table) the step count and the learning rate
// are computed here, from the step the optimizer state holds:
//     step' = step + 1                               (written to step_out)
//     clr   = lr / (1 + (step' - 1) * lr_decay)      (one rounded division)
//     g'    = g + weight_decay * p
//     acc'  = acc + g'^2
//     p'    = p - clr * g' / (sqrt(acc') + eps)
// With a given clr (the one-leaf entries' TPU signature) no step is read or
// written.  Every operation is a correctly rounded __f*_rn intrinsic, which
// nvcc never contracts into an FMA, in the order of the plain versions
// (ops/adagrad_kernel.py, ops/scatter_adagrad_kernel.py): the results are
// bit-equal to them on the card.  step_in is never written: another block
// reading it after a write would compute another learning rate, so the new
// step goes to a separate step_out that block 0 writes.
//
// Replaces the TPU kernels
//   open_knowledge_graph_embeddings_tpu/ops/pallas/adagrad_kernel.py::adagrad_update_pallas
//     (pallas_call :52, body _kernel :28): one leaf a call;
//   open_knowledge_graph_embeddings_tpu/ops/pallas/scatter_adagrad_kernel.py::scatter_adagrad_pallas
//     (pallas_call :137, body _make_kernel :52): one table a call, whole
//     8-row HBM tiles staged by DMA; here single rows, by compact uid.
//
// Bound on an H100: bytes, 5 x 4 B per updated element (g, p, acc read;
// p, acc written) at 3.35 TB/s; the flagship's dense group (4 x [2048, 512],
// 4 x [2048], 4 x [512]: 4,204,544 elements, 84.1 MB) ~0.025 ms; the row
// update 20 B per valid element plus the plan's uid and valid bytes.  The
// training step is host-bound, so one launch from Python a group, with the
// leaves' pointers in one __grid_constant__ parameter (no host-to-device
// copy), replaces a launch and five scalar ops per leaf.
//
// Design.  Dense: a persistent grid of a few 256-thread blocks per SM walks
// the leaves' concatenated units, a 16-byte chunk of a leaf whose n is a
// multiple of 4 and whose three pointers are 16-byte aligned, else one
// element (the scalar path); each thread issues UNROLL float4 loads of g, p
// and acc before the math (48 KB in flight a block).  A thread's units only
// grow, so it finds each unit's leaf by walking forward.  Rows: one warp per
// (table, plan entry), persistent warps striding over the tables'
// concatenated entries; the warp reads valid and uid once, a padding entry
// (valid false: its uid is row 0, a real row) returns at once and never
// touches row 0; a 512-wide row is 128 float4, 4 a lane of each of g, p and
// acc issued before the math; any other width or an unaligned row takes
// the scalar path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 32;  // leaves a dense launch takes (ops/adagrad_kernel.py MAX_LEAVES)
constexpr int MAX_TABLES = 8;   // tables a row launch takes (ops/scatter_adagrad_kernel.py MAX_TABLES)
constexpr int THREADS = 256;
constexpr int UNROLL = 4;       // dense units a thread loads before its math
constexpr int TILE = THREADS * UNROLL;
constexpr int ROW_VEC = 4;      // float4 a lane loads of each row tensor before its math

struct Hyper {
    const float* clr;  // given learning rate, or null: per leaf from its step
    float lr, lr_decay, wd, eps;
};

struct DenseArgs {
    const float* g[MAX_LEAVES];
    float* p[MAX_LEAVES];
    float* acc[MAX_LEAVES];
    const float* step_in[MAX_LEAVES];
    float* step_out[MAX_LEAVES];
    long long begin[MAX_LEAVES + 1];  // first unit of each leaf
    unsigned vec;                     // bit i: leaf i walks 16-byte units
    int n;
    Hyper hp;
};

struct RowArgs {
    const float* g[MAX_TABLES];  // [U, d] gradients of the plan's rows
    const void* uids[MAX_TABLES];
    const unsigned char* valid[MAX_TABLES];
    float* p[MAX_TABLES];
    float* acc[MAX_TABLES];
    const float* step_in[MAX_TABLES];
    float* step_out[MAX_TABLES];
    long long begin[MAX_TABLES + 1];  // first plan entry of each table
    int d[MAX_TABLES];
    unsigned uid64;  // bit i: table i's uids are int64 (else int32)
    unsigned vec;    // bit i: table i's rows are whole float4
    int n;
    Hyper hp;
};

__device__ __forceinline__ float learning_rate(const Hyper& hp, const float* step_in) {
    if (hp.clr) return *hp.clr;
    const float step = __fadd_rn(*step_in, 1.0f);
    return __fdiv_rn(hp.lr, __fadd_rn(1.0f, __fmul_rn(__fsub_rn(step, 1.0f), hp.lr_decay)));
}

// Block-wide: the learning rate of each of the n leaves (tables) into
// shared memory; block 0 writes each new step.
__device__ __forceinline__ void prologue(const Hyper& hp, const float* const* step_in, float* const* step_out,
                                         int n, float* clr) {
    if (threadIdx.x < n) {
        clr[threadIdx.x] = learning_rate(hp, step_in[threadIdx.x]);
        if (blockIdx.x == 0 && !hp.clr) step_out[threadIdx.x][0] = __fadd_rn(step_in[threadIdx.x][0], 1.0f);
    }
    __syncthreads();
}

__device__ __forceinline__ void update(float g, float& p, float& acc, float clr, float wd, float eps) {
    g = __fadd_rn(g, __fmul_rn(wd, p));
    acc = __fadd_rn(acc, __fmul_rn(g, g));
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(clr, g), __fadd_rn(__fsqrt_rn(acc), eps)));
}

__device__ __forceinline__ void update4(const float4& g, float4& p, float4& acc, float clr, const Hyper& hp) {
    update(g.x, p.x, acc.x, clr, hp.wd, hp.eps);
    update(g.y, p.y, acc.y, clr, hp.wd, hp.eps);
    update(g.z, p.z, acc.z, clr, hp.wd, hp.eps);
    update(g.w, p.w, acc.w, clr, hp.wd, hp.eps);
}

__global__ void __launch_bounds__(THREADS) adagrad_dense_kernel(const __grid_constant__ DenseArgs a) {
    __shared__ float clr[MAX_LEAVES];
    prologue(a.hp, a.step_in, a.step_out, a.n, clr);
    const long long total = a.begin[a.n];
    int leaf = 0;
    for (long long base = (long long)blockIdx.x * TILE; base < total; base += (long long)gridDim.x * TILE) {
        float4 g[UNROLL], p[UNROLL], s[UNROLL];
        int lf[UNROLL];
        long long off[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            const long long u = base + j * THREADS + threadIdx.x;
            lf[j] = -1;
            if (u >= total) continue;
            while (u >= a.begin[leaf + 1]) ++leaf;
            lf[j] = leaf;
            off[j] = u - a.begin[leaf];
            if (a.vec >> leaf & 1u) {
                g[j] = reinterpret_cast<const float4*>(a.g[leaf])[off[j]];
                p[j] = reinterpret_cast<const float4*>(a.p[leaf])[off[j]];
                s[j] = reinterpret_cast<const float4*>(a.acc[leaf])[off[j]];
            } else {
                g[j].x = a.g[leaf][off[j]];
                p[j].x = a.p[leaf][off[j]];
                s[j].x = a.acc[leaf][off[j]];
            }
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            const int i = lf[j];
            if (i < 0) continue;
            if (a.vec >> i & 1u) {
                update4(g[j], p[j], s[j], clr[i], a.hp);
                reinterpret_cast<float4*>(a.acc[i])[off[j]] = s[j];
                reinterpret_cast<float4*>(a.p[i])[off[j]] = p[j];
            } else {
                update(g[j].x, p[j].x, s[j].x, clr[i], a.hp.wd, a.hp.eps);
                a.acc[i][off[j]] = s[j].x;
                a.p[i][off[j]] = p[j].x;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS) adagrad_rows_kernel(const __grid_constant__ RowArgs a) {
    __shared__ float clr[MAX_TABLES];
    prologue(a.hp, a.step_in, a.step_out, a.n, clr);
    const int lane = threadIdx.x & 31;
    const long long total = a.begin[a.n];
    const long long warps = (long long)gridDim.x * (THREADS / 32);
    int t = 0;
    for (long long e = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32; e < total; e += warps) {
        while (e >= a.begin[t + 1]) ++t;
        const long long u = e - a.begin[t];
        if (!a.valid[t][u]) continue;  // padding: its uid is row 0, which a valid entry may own
        const long long row = (a.uid64 >> t & 1u) ? static_cast<const long long*>(a.uids[t])[u]
                                                  : (long long)static_cast<const int*>(a.uids[t])[u];
        const int d = a.d[t];
        const float c = clr[t];
        const float* g = a.g[t] + u * d;
        float* p = a.p[t] + row * d;
        float* s = a.acc[t] + row * d;
        if (a.vec >> t & 1u) {
            const int d4 = d / 4;
            for (int c0 = 0; c0 < d4; c0 += 32 * ROW_VEC) {
                float4 gv[ROW_VEC], pv[ROW_VEC], sv[ROW_VEC];
#pragma unroll
                for (int j = 0; j < ROW_VEC; ++j) {
                    const int col = c0 + j * 32 + lane;
                    if (col >= d4) continue;
                    gv[j] = reinterpret_cast<const float4*>(g)[col];
                    pv[j] = reinterpret_cast<const float4*>(p)[col];
                    sv[j] = reinterpret_cast<const float4*>(s)[col];
                }
#pragma unroll
                for (int j = 0; j < ROW_VEC; ++j) {
                    const int col = c0 + j * 32 + lane;
                    if (col >= d4) continue;
                    update4(gv[j], pv[j], sv[j], c, a.hp);
                    reinterpret_cast<float4*>(s)[col] = sv[j];
                    reinterpret_cast<float4*>(p)[col] = pv[j];
                }
            }
        } else {
            for (int col = lane; col < d; col += 32) {
                float pc = p[col], sc = s[col];
                update(g[col], pc, sc, c, a.hp.wd, a.hp.eps);
                s[col] = sc;
                p[col] = pc;
            }
        }
    }
}

bool aligned16(long long ptr) { return (ptr & 15) == 0; }

Hyper hyper(const float* clr, float lr, float lr_decay, float wd, float eps) {
    Hyper hp;
    hp.clr = clr;
    hp.lr = lr;
    hp.lr_decay = lr_decay;
    hp.wd = wd;
    hp.eps = eps;
    return hp;
}

}  // namespace

// The dense update of n leaves in one launch.  leaves: n x 6 int64 on the
// host, per leaf {g, p, acc, step_in, step_out, numel} (f32 device
// pointers; step_in and step_out one float each, unused with clr).  clr: a
// device float, or null to compute each leaf's from its step.  The grid is
// at most max_blocks.  Returns the launch's cudaError (cudaErrorInvalidValue
// for n outside 1..32).
extern "C" int oket_adagrad_dense(const long long* leaves, int n, const float* clr, float lr, float lr_decay,
                                  float wd, float eps, int max_blocks, void* stream) {
    if (n < 1 || n > MAX_LEAVES || max_blocks < 1) return cudaErrorInvalidValue;
    DenseArgs a;
    a.n = n;
    a.vec = 0;
    a.hp = hyper(clr, lr, lr_decay, wd, eps);
    a.begin[0] = 0;
    for (int i = 0; i < n; ++i) {
        const long long* l = leaves + 6 * i;
        a.g[i] = reinterpret_cast<const float*>(l[0]);
        a.p[i] = reinterpret_cast<float*>(l[1]);
        a.acc[i] = reinterpret_cast<float*>(l[2]);
        a.step_in[i] = reinterpret_cast<const float*>(l[3]);
        a.step_out[i] = reinterpret_cast<float*>(l[4]);
        const bool vec = l[5] % 4 == 0 && aligned16(l[0]) && aligned16(l[1]) && aligned16(l[2]);
        a.vec |= (unsigned)vec << i;
        a.begin[i + 1] = a.begin[i] + (vec ? l[5] / 4 : l[5]);
    }
    const long long tiles = (a.begin[n] + TILE - 1) / TILE;
    const int grid = (int)(tiles < max_blocks ? (tiles > 0 ? tiles : 1) : max_blocks);
    adagrad_dense_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return cudaGetLastError();
}

// The row update of n tables in one launch.  tables: n x 10 int64 on the
// host, per table {g_rows [U, d], uids [U], valid [U] (bool), p [V, d],
// acc [V, d], step_in, step_out, U, d, uids are int64}.  Otherwise as
// oket_adagrad_dense (n outside 1..8 is cudaErrorInvalidValue).
extern "C" int oket_adagrad_rows(const long long* tables, int n, const float* clr, float lr, float lr_decay,
                                 float wd, float eps, int max_blocks, void* stream) {
    if (n < 1 || n > MAX_TABLES || max_blocks < 1) return cudaErrorInvalidValue;
    RowArgs a;
    a.n = n;
    a.uid64 = 0;
    a.vec = 0;
    a.hp = hyper(clr, lr, lr_decay, wd, eps);
    a.begin[0] = 0;
    for (int i = 0; i < n; ++i) {
        const long long* t = tables + 10 * i;
        a.g[i] = reinterpret_cast<const float*>(t[0]);
        a.uids[i] = reinterpret_cast<const void*>(t[1]);
        a.valid[i] = reinterpret_cast<const unsigned char*>(t[2]);
        a.p[i] = reinterpret_cast<float*>(t[3]);
        a.acc[i] = reinterpret_cast<float*>(t[4]);
        a.step_in[i] = reinterpret_cast<const float*>(t[5]);
        a.step_out[i] = reinterpret_cast<float*>(t[6]);
        a.d[i] = (int)t[8];
        a.uid64 |= (unsigned)(t[9] != 0) << i;
        const bool vec = t[8] % 4 == 0 && aligned16(t[0]) && aligned16(t[3]) && aligned16(t[4]);
        a.vec |= (unsigned)vec << i;
        a.begin[i + 1] = a.begin[i] + t[7];
    }
    const long long blocks = (a.begin[n] + THREADS / 32 - 1) / (THREADS / 32);
    const int grid = (int)(blocks < max_blocks ? (blocks > 0 ? blocks : 1) : max_blocks);
    adagrad_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return cudaGetLastError();
}
