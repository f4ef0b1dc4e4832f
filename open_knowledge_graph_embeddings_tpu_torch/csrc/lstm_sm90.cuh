// Hopper (sm_90a) building blocks of the port's CUDA kernels, in inline PTX:
// mbarriers and the ring of TMA slots they guard (Ring, make_ring), TMA tile
// loads (cp.async.bulk.tensor) and their tensor maps, wgmma descriptors,
// fences, the bf16 product m64n128k16 (each operand K-major or MN-major) and
// the TF32 product m64n128k8 (A from registers or from shared memory) with
// f32 accumulators, the TF32 split of an f32 value, named barriers,
// setmaxnreg and the block-wide search of a step's active rows; on the host
// the tensor maps and the dynamic shared memory opt-in.  Used by the bf16
// gate loop of lstm_bf16.cuh (kernel 1 and the bf16 backward), the 3xTF32
// gate loop of lstm_tf32.cuh (the f32 forward and backward) and both dW
// launches of lstm_last_bwd.cu.
//
// Shared-memory tiles are K-major with the 128-byte swizzle: each tile row
// is 128 bytes of K (64 bf16 or 32 f32), rows grouped by 8 into 1024-byte
// atoms, and the 16-byte chunk c of row r stored at chunk c ^ (r % 8).  A
// k16 bf16 step and a k8 TF32 step are both 32 bytes of a row, so the
// descriptor walk along K is the same for both.  TMA writes that
// layout (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma reads it (descriptor layout
// type 1), both from the address bits, so every tile starts on a 1024-byte
// boundary.  A bf16 operand can also be MN-major (wgmma_desc_mn): each
// tile row is then 128 bytes of M or N (64 rows of A or columns of B) at one
// k, in the same atoms.  Tensor maps are encoded on the host with the
// driver's cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint,
// so the ctypes-loaded library needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace oket_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to the
// other threads of the block (after a __syncthreads).
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA data.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.  A wait
// that outlasts 2^22 tries (each may suspend for microseconds: seconds in
// all, where a working pipeline waits microseconds) traps, so a broken
// pipeline fails its launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done, tries = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
        if (++tries == (1u << 22)) __trap();
    } while (!done);
}

// ------------------------------------------------------------------ the ring

// A ring of STAGES slots of STAGE_BYTES in dynamic shared memory, filled by
// TMA in order: a full mbarrier per slot (one arrival, the producer's, with
// the slot's bytes expected) and an empty one (`readers` arrivals: the
// consumer warps that read the slot), and two turn barriers (a warpgroup's
// four warps each) for consumers that take tiles in turns.  The slots start
// on a 1024-byte boundary (the swizzle's atom) and the barriers follow
// them; SMEM bytes of dynamic shared memory hold it all.
template <int STAGE_BYTES_, int STAGES_>
struct Ring {
    static constexpr int STAGE_BYTES = STAGE_BYTES_;
    static constexpr int STAGES = STAGES_;
    // the slots, their barriers and the turns, and slack to align the slots
    static constexpr int SMEM = STAGES * STAGE_BYTES + (2 * STAGES + 2) * 8 + 1024;
    uint8_t* slots;
    uint64_t* full;
    uint64_t* empty;
    uint64_t* turn;

    __device__ __forceinline__ uint8_t* slot(int s) const { return slots + s * STAGE_BYTES; }
};

// Lays the ring R out in `smem_raw`; thread 0 initialises its barriers (and
// fences every barrier it has initialised before, for the async proxy); the
// caller then synchronises the block.
template <typename R>
__device__ __forceinline__ R make_ring(uint8_t* smem_raw, int readers) {
    R r;
    r.slots = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    r.full = reinterpret_cast<uint64_t*>(r.slots + R::STAGES * R::STAGE_BYTES);
    r.empty = r.full + R::STAGES;
    r.turn = r.empty + R::STAGES;
    if (threadIdx.x == 0) {
        for (int s = 0; s < R::STAGES; ++s) {
            mbar_init(&r.full[s], 1);
            mbar_init(&r.empty[s], readers);
        }
        mbar_init(&r.turn[0], 4);
        mbar_init(&r.turn[1], 4);
        mbar_fence_init();
    }
    return r;
}

// -------------------------------------------------------------- active rows

// Rows active at step t (max(len, 1) > t) of a persistent LSTM step kernel: a
// prefix [0, n) of the lengths, which are sorted descending.  All THREADS
// threads of the block take part: each round probes THREADS evenly spaced
// rows of the interval still in doubt at once, so B = 32768 takes two rounds
// of one load per thread.
template <int THREADS>
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

// ----------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
        "[%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// --------------------------------------------------------------------- wgmma

// Descriptor of a K-major, 128-byte-swizzled tile at `p` (1024-byte aligned,
// or advanced from such a base by a multiple of 32 bytes along K): start
// address >> 4, leading offset 1 (unused for swizzled K-major), stride 1024
// bytes between 8-row atoms, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
    const uint64_t addr = smem_u32(p);
    return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

// Orders this thread's earlier generic-proxy writes to shared memory before
// later async-proxy reads of it (a wgmma operand written by the threads).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Register `d` is made visible to the compiler's ordering around the async
// product (so no read of an accumulator moves above wgmma_wait).
template <int R>
__device__ __forceinline__ void wgmma_fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of an MN-major, 128-byte-swizzled tile at `p` (1024-byte
// aligned), of either operand: rows of 128 bytes, one k and 64 columns of B
// (or 64 rows of A) each, 8 k-rows to a 1024-byte atom.  The stride byte
// offset steps along K from one 8-row atom to the next (1024 bytes, the
// atoms of a 64-wide block being consecutive); the leading byte offset steps
// along N (or M) from one 64-wide block to the next, `lbo` bytes apart (A's
// 64 rows are one block, so A never reads it).  A k16 step is two atoms, so
// the walk along K advances the start address by 2048 bytes.
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* p, uint32_t lbo) {
    const uint64_t addr = smem_u32(p);
    return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) | ((uint64_t)(1024 >> 4) << 32) |
           (1ull << 62);
}

// d[64 x 128] += A[64 x 16] . B[128 x 16]^T, bf16 operands from shared memory
// (A K-major, or with TRANS_A = 1 MN-major, as [16 x 64] with the 64 rows
// contiguous; B K-major, or with TRANS_B = 1 MN-major, as [16 x 128] with
// the 128 columns contiguous: wgmma's transposed forms, which 16-bit types
// have), f32 accumulators in the wgmma register layout: register 4 * n8 + e
// of thread (warp w, lane l) of the warpgroup holds row 16 w + l / 4 + 8
// (e / 2), column 8 n8 + 2 (l % 4) + e % 2.  With scale_d = 0 the product
// overwrites d instead (d = A . B^T).
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d[64 x 128] += A[64 x 8] . B[128 x 8]^T, TF32 operands: A from registers
// (a[i] the f32 bit pattern of row 16 w + l / 4 + 8 (i % 2), column
// l % 4 + 4 (i / 2) of thread (warp w, lane l) of the warpgroup), B K-major
// from shared memory; the tensor core reads the top 19 bits of each f32
// (sign, exponent, 10 mantissa bits) and ignores the rest.  The
// accumulator layout is wgmma_m64n128k16's.  With scale_d = 0 the product
// overwrites d instead (d = A . B^T).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                     int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d[64 x 128] += A[64 x 8] . B[128 x 8]^T, TF32 operands both K-major from
// shared memory (descriptors as wgmma_desc's); otherwise as
// wgmma_m64n128k8_tf32.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
        "}, %64, %65, p, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

// x = hi + lo + (a rest below 2^-22 |x|): hi = x rounded to nearest (ties
// away) at TF32's 10 mantissa bits, lo = the remainder x - hi (exact in
// f32) rounded the same way.  The tensor core truncates an f32 operand to
// those bits, so hi is rounded explicitly, or it would lose the bit that lo
// carries.  3xTF32 sums lo.hi' + hi.lo' + hi.hi', f32-accurate.  The
// rounding is cvt.rna.tf32.f32's for finite x, in two integer instructions:
// adding half a TF32 ulp (0x1000) to the bit pattern carries into bit 13
// exactly when the dropped bits are at least half an ulp, and the mask
// drops them.  ptxas expands cvt.rna.tf32.f32 with a compare and a select
// per value for Inf and NaN, which the operands here are not; on an H100
// this form gave the dW launch the same bits, faster.
__device__ __forceinline__ uint32_t tf32_round(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_round(x);
    lo = tf32_round(x - __uint_as_float(hi));
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------- host side

// cudaFuncSetAttribute for the `bytes` of dynamic shared memory of
// `Kernel`, once per device.  Returns the cudaError_t, 0 on success.
template <auto Kernel, int bytes>
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once; null if the driver
// has none.
static EncodeTiledFn encode_tiled_fn() {
    static EncodeTiledFn fn = nullptr;
    static bool looked = false;
    if (!looked) {
        looked = true;
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) ==
                cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
            q == cudaDriverEntryPointSuccess)
#endif
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// The last tensor map made for one operand of a kernel, with what it was
// made for.
struct CachedMap {
    const void* base = nullptr;
    uint64_t dims[3] = {0, 0, 0};
    uint32_t box[3] = {0, 0, 0};
    CUtensorMap map;
};

// A tensor map of elements of `type` (`bytes` each) over the contiguous 3-D
// array at `base` (dims[0] the contiguous dimension), read in boxes of
// `box`, 128-byte swizzled, the elements outside the array read as zero;
// made anew only when `m` was made for another array or box, so the steps
// of a recurrence, which pass the same arrays, encode nothing.  Null if the
// driver cannot encode it.
static const CUtensorMap* tiled_map(CachedMap& m, CUtensorMapDataType type, int bytes, const void* base,
                                    const uint64_t (&dims)[3], const uint32_t (&box)[3]) {
    bool same = m.base == base;
    for (int i = 0; i < 3; ++i) same = same && m.dims[i] == dims[i] && m.box[i] == box[i];
    if (same) return &m.map;
    m.base = nullptr;
    EncodeTiledFn fn = encode_tiled_fn();
    if (!fn) return nullptr;
    const cuuint64_t d[3] = {dims[0], dims[1], dims[2]}, s[2] = {dims[0] * bytes, dims[0] * dims[1] * bytes};
    const cuuint32_t b[3] = {box[0], box[1], box[2]}, e[3] = {1, 1, 1};
    if (fn(&m.map, type, 3, const_cast<void*>(base), d, s, b, e,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return nullptr;
    m.base = base;
    for (int i = 0; i < 3; ++i) {
        m.dims[i] = dims[i];
        m.box[i] = box[i];
    }
    return &m.map;
}

static const CUtensorMap* bf16_map(CachedMap& m, const void* base, const uint64_t (&dims)[3],
                                   const uint32_t (&box)[3]) {
    return tiled_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, box);
}

static const CUtensorMap* f32_map(CachedMap& m, const void* base, const uint64_t (&dims)[3],
                                  const uint32_t (&box)[3]) {
    return tiled_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, box);
}

}  // namespace oket_sm90
