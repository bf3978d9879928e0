// NW traceback: the pointer walk from the end cell over the packed
// diagonal-layout pointers of nw_fill.cu, one pair per block.
//
// Replaces the Pallas TPU kernel text_alignment_tpu/align/nw_pallas.py
// traceback_ops_pallas_batched (_make_tb_kernel; traceback_ops_pallas is
// its B = 1 case). Contract of nw_jax._traceback_ops:
//   mpt = packed[Nt-1 + No-1, Nt-1] & 3, xpt = Nt-1, ypt = No-1, k = 0
//   while xpt > 0 and ypt > 0:
//     ops[k++] = mpt
//     nxt = (packed[xpt+ypt, xpt] >> 2*mpt) & 3
//     xpt -= mpt != 2;  ypt -= mpt != 1;  mpt = nxt
// Output: one int32 row per pair, [k, xpt, ypt, ops[0..P)] with
// P = L + NoP; only ops[:k] are written, and the two last slots, which the
// walk never reaches (k <= P - 3), carry the pair's window count and miss
// count (ops[P-2], ops[P-1]; nw_kernel.traceback_stats).
//
// What bounds it: the walk is a chain of up to Nt + No dependent byte
// loads, not bytes. Its floor is k times one dependent step in shared
// memory (a load and the few operations that give the next offset); the
// step's position depends only on the op before it, so two steps overlap
// and a step costs about half a load's latency plus the arithmetic. Every
// load that leaves shared memory, and every stall for a window, adds a
// device-memory latency to the chain.
//
// Design (cursor (d, i) = (xpt + ypt, xpt); a step lowers d by 1 or 2 and
// i by 0 or 1):
//   windows  a window is TH x TW = 256 diagonals x 128 lanes (32 KB) of the
//            pair's pointers, copied into shared memory by ONE TMA 2-D copy
//            over the (B*D, L) byte tensor, completing on an mbarrier. Its
//            lane origin is a multiple of 16 (L is a multiple of 128, so
//            every row starts 16-byte aligned); the copy fills zeros past
//            the tensor's edge, and rows past D are never read (d < D).
//            256 x 128 because a diagonal step uses two rows per lane, so
//            a mostly diagonal path gets ~100 steps from a window, and
//            two windows (64 KB) let three blocks share an SM: a 2400^2
//            grid launch of ~327 pairs runs in one wave on 132 SMs.
//   overlap  two window buffers. When the cursor enters a window the walker
//            thread issues the copy of the next one into the other buffer
//            and walks on; the copy lands while it walks. The next window
//            is predicted: the path is extended from the cursor with the
//            slope of the last hop (d and i moved since the previous
//            switch) to the edge where it leaves the current window, and
//            the next window's top-right corner is put MD = 48 diagonals
//            and MI = 24 lanes above and right of that exit point (but
//            never above or right of the cursor), so an exit near the
//            prediction lands inside it, and windows overlap.
//   walk     one thread. From a cursor inside a window, ws = min((d - d0)
//            >> 1, i - i0) + 1 steps provably read inside it, and
//            min(xpt, ypt) steps provably keep the walk active; with S the
//            smaller, the walker runs S / U whole blocks of U = 16 unrolled
//            steps with no test in between and tests the window edge only
//            after them. When fewer than U safe steps are left it switches:
//            to the prefetched window if that holds the cursor with at
//            least min(U, steps to the end) safe steps (a hit), otherwise
//            (a miss: a gap run bent the path) to a window staged on demand
//            with the cursor as its top-right corner. Single steps run only
//            where the walk ends inside the window. A step's move is one
//            byte permute of two constants (below); the op stores to device
//            memory hang off the chain (nothing waits for them).
// Shared memory: 2 x 32 KB + two mbarriers, one warp a block (only lane 0
// works). Compiled with -DTA_TB_STOP=n for chip_nw_ablation.py: 1 stages
// every window on demand (no prefetch), 2 stages only the first window and
// walks the rest over stale bytes (the walk without staging), 3 stages the
// windows of a diagonal path one after another and does not walk (staging
// only); the variants' outputs are wrong, only their times mean anything.
// -DTA_TB_PROFILE counts cycles (below).
//
// ta_nw_tb_chase times the walk's step alone: the same step, U at a time,
// over a window of seeded pointers in shared memory, for chip_smoke.py's
// and chip_nw_ablation.py's chain floor.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#define TA_TB_TH 256
#define TA_TB_TW 128
#define TA_TB_LOG_TW 7
#define TA_TB_U 16
#define TA_TB_MD 48
#define TA_TB_MI 24
#define TA_TB_ALIGN 16
#define TA_TB_WIN (TA_TB_TH * TA_TB_TW)
#define TA_TB_SMEM (2 * TA_TB_WIN + 64)

#ifndef TA_TB_STOP
#define TA_TB_STOP 0
#endif

static_assert(TA_TB_TW == 1 << TA_TB_LOG_TW, "TW is a power of two");
static_assert(TA_TB_TH >= 2 * TA_TB_U + TA_TB_MD && TA_TB_TW >= TA_TB_U +
              TA_TB_MI + TA_TB_ALIGN, "a window holds a block past margins");

__device__ __forceinline__ uint32_t ta_smem(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ta_bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(ta_smem(bar))
                 : "memory");
}

// One TMA copy of the window at lane i0, global row row0, into dst.
__device__ __forceinline__ void ta_stage(const CUtensorMap* map, uint8_t* dst,
                                         uint64_t* bar, int i0, int row0) {
    // the walk's reads of this buffer come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
        "%1; }" ::"r"(ta_smem(bar)), "r"(TA_TB_WIN)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(ta_smem(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(i0), "r"(row0),
        "r"(ta_smem(bar))
        : "memory");
}

__device__ __forceinline__ void ta_wait(uint64_t* bar, uint32_t phase) {
    uint32_t done;
    do {
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
            "[%1], %2; selp.u32 %0, 1, 0, p; }"
            : "=r"(done)
            : "r"(ta_smem(bar)), "r"(phase)
            : "memory");
    } while (!done);
}

// Steps that provably read inside the window (d0, i0) from cursor (d, i),
// 0 when the cursor is outside it.
__device__ __forceinline__ int ta_safe(int d, int i, int d0, int i0) {
    if (d < d0 || i < i0 || d >= d0 + TA_TB_TH || i >= i0 + TA_TB_TW)
        return 0;
    return min((d - d0) >> 1, i - i0) + 1;
}

// The window whose top-right corner is (td, ti): lane origin a multiple of
// TA_TB_ALIGN rounded up (the corner stays inside), both origins >= 0.
__device__ __forceinline__ void ta_anchor(int td, int ti, int& d0, int& i0) {
    d0 = max(td - TA_TB_TH + 1, 0);
    i0 = max((ti - TA_TB_TW + TA_TB_ALIGN) & ~(TA_TB_ALIGN - 1), 0);
}

// One step: read the cell under the cursor, emit the op, move, take the
// next op. r = buffer * WIN + (d - d0) * TW + (i - i0) indexes the two
// window buffers. The move lowers r by (dx + dy) * TW + dx = 257, 129, 128
// or 257 for op 0, 1, 2 or 3: one byte permute of two constants picks it
// (selector nibbles op, op + 4 and two zero bytes), three operations on the
// chain where compares and selects took six. The next step's read does not
// wait for this step's byte, only for the op before it, so two steps
// overlap.
static_assert(TA_TB_TW == 128, "the byte-permute table is for TW = 128");

// prmt.b32 itself: __byte_perm masks the selector first, one more operation
// on the chain; every selector nibble here is below 8 (no sign mode).
__device__ __forceinline__ int ta_prmt(uint32_t a, uint32_t b, uint32_t s) {
    uint32_t v;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(v) : "r"(a), "r"(b), "r"(s));
    return (int)v;
}
#define TA_TB_STEP(r, i, mpt, out)                                          \
    {                                                                       \
        const int c_ = smem[r];                                             \
        (out) = (mpt);                                                      \
        (r) -= ta_prmt(0x01808101u, 0x01000001u,                            \
                       (uint32_t)(mpt) * 0x11u + 0x5540u);                  \
        (i) -= (mpt) != 2;                                                  \
        (mpt) = (c_ >> (2 * (mpt))) & 3;                                    \
    }

// -DTA_TB_PROFILE (chip_nw_ablation.py): clock64() cycles spent waiting
// for copies, walking, and in total, written to ops[k], ops[k + 1] and
// ops[k + 2] (past the walk's ops, and over the two counts when k = P - 3),
// and where there is room the cycles spent predicting and issuing
// prefetches and the number of walk segments, to ops[k + 3], ops[k + 4].
#ifdef TA_TB_PROFILE
#define TA_TB_CLOCK(t) const long long t = clock64()
#define TA_TB_SINCE(acc, t) (acc) += clock64() - (t)
#else
#define TA_TB_CLOCK(t)
#define TA_TB_SINCE(acc, t)
#endif

__global__ void __launch_bounds__(32)
ta_nw_traceback_kernel(const __grid_constant__ CUtensorMap map,
                       const int* __restrict__ nts,
                       const int* __restrict__ nos, int* __restrict__ wire,
                       int D) {
    extern __shared__ __align__(1024) uint8_t smem[];
    if (threadIdx.x != 0) return;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * TA_TB_WIN);
    const int b = blockIdx.x;
    const int P = D + 1;
    const int rowb = b * D;  // the pair's first row in the (B*D, L) tensor
    int* wb = wire + (size_t)b * (3 + P);
    int* ops = wb + 3;
#ifdef TA_TB_PROFILE
    long long t_wait = 0, t_walk = 0, t_stage = 0;
    int n_seg = 0;
    TA_TB_CLOCK(t_start);
#endif

    int i = nts[b] - 1;
    int d = i + nos[b] - 1;
    int k = 0, windows = 0, misses = 0;
    if (i > 0 && d - i > 0) {
        ta_bar_init(&bar[0]);
        ta_bar_init(&bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        // buffer cur holds window (cd0, ci0); buffer cur ^ 1 gets window
        // (nd0, ni0), a copy in flight while pend; bit w of phases is the
        // parity buffer w's barrier completes next
        int cur = 0, cd0, ci0, nd0 = 0, ni0 = 0, phases = 0;
        bool pend = false;
        ta_anchor(d, i, cd0, ci0);
        ta_stage(&map, smem, &bar[0], ci0, rowb + cd0);
        ++windows;
        int pd = d + 2, pi = i + 1;  // no hop yet: assume a diagonal slope
        {
            TA_TB_CLOCK(t);
            ta_wait(&bar[0], 0);
            TA_TB_SINCE(t_wait, t);
        }
        phases = 1;
        int mpt = smem[((d - cd0) << TA_TB_LOG_TW) + i - ci0] & 3;
        bool enter = true;
        for (;;) {
            if (enter) {
                TA_TB_CLOCK(te);
                enter = false;
#if TA_TB_STOP == 0
                // predict where the cursor leaves window cur; prefetch the
                // window above-right of that point into the other buffer
                const int dd = max(pd - d, 1), di = max(pi - i, 0);
                const int ed = d - cd0 + 1, ei = i - ci0 + 1;
                int xd, xi;
                if (di == 0 || ed * di <= ei * dd) {
                    xd = cd0 - 1;
                    xi = i - ed * di / dd;
                } else {
                    xi = ci0 - 1;
                    xd = d - ei * dd / di;
                }
                const int nb = cur ^ 1;
                ta_anchor(min(xd + TA_TB_MD, d), min(xi + TA_TB_MI, i), nd0,
                          ni0);
                ta_stage(&map, smem + nb * TA_TB_WIN, &bar[nb], ni0,
                         rowb + nd0);
                pend = true;
                ++windows;
#endif
                pd = d;
                pi = i;
                TA_TB_SINCE(t_stage, te);
            }
            const int term = min(i, d - i);
            if (term <= 0) break;
            // the cursor entered window cur and only moves down and left,
            // never past its edge by more than the last move: ws >= 0
            const int ws = min((d - cd0) >> 1, i - ci0) + 1;
            const int S = min(ws, term);
            if (S < TA_TB_U && ws <= term) {
                // fewer than U safe steps left in window cur: take the
                // prefetched window or stage one on demand
                const int nb = cur ^ 1;
                bool hit = false;
                if (pend) {
                    TA_TB_CLOCK(t);
                    ta_wait(&bar[nb], (phases >> nb) & 1);
                    TA_TB_SINCE(t_wait, t);
                    phases ^= 1 << nb;
                    pend = false;
                    hit = ta_safe(d, i, nd0, ni0) >= min(TA_TB_U, term);
                }
                if (!hit) {
                    ta_anchor(d, i, nd0, ni0);
#if TA_TB_STOP != 2
                    ta_stage(&map, smem + nb * TA_TB_WIN, &bar[nb], ni0,
                             rowb + nd0);
                    TA_TB_CLOCK(t);
                    ta_wait(&bar[nb], (phases >> nb) & 1);
                    TA_TB_SINCE(t_wait, t);
                    phases ^= 1 << nb;
                    ++windows;
#endif
                    ++misses;
                }
                cur = nb;
                cd0 = nd0;
                ci0 = ni0;
                enter = true;
                continue;
            }
#if TA_TB_STOP == 3
            // staging only: jump to where a diagonal path would leave
            d -= 2 * S;
            i -= S;
            continue;
#endif
            // S >= U: whole blocks only, the rest after a switch; S < U
            // (the walk ends inside this window): single steps
            TA_TB_CLOCK(t);
            const int base = cur * TA_TB_WIN - ci0;
            int r = base + ((d - cd0) << TA_TB_LOG_TW) + i;
            int* out = ops + k;
            if (S >= TA_TB_U) {
                for (int n = S / TA_TB_U; n > 0; --n) {
#pragma unroll
                    for (int u = 0; u < TA_TB_U; ++u)
                        TA_TB_STEP(r, i, mpt, out[u]);
                    out += TA_TB_U;
                }
            } else {
                for (int n = S; n > 0; --n) {
                    TA_TB_STEP(r, i, mpt, out[0]);
                    ++out;
                }
            }
            k = (int)(out - ops);
            d = cd0 + ((r - base - i) >> TA_TB_LOG_TW);
            TA_TB_SINCE(t_walk, t);
#ifdef TA_TB_PROFILE
            ++n_seg;
#endif
        }
        // no copy may land in shared memory after the block exits
        if (pend) ta_wait(&bar[cur ^ 1], (phases >> (cur ^ 1)) & 1);
    }
    wb[0] = k;
    wb[1] = i;
    wb[2] = d - i;
    ops[P - 2] = windows;
    ops[P - 1] = misses;
#ifdef TA_TB_PROFILE
    ops[k] = (int)t_wait;
    ops[k + 1] = (int)t_walk;
    ops[k + 2] = (int)(clock64() - t_start);
    if (k + 4 < P) {
        ops[k + 3] = (int)t_stage;
        ops[k + 4] = n_seg;
    }
#endif
}

__global__ void __launch_bounds__(256)
ta_nw_tb_chase_kernel(int* __restrict__ sink, int blocks) {
    extern __shared__ __align__(1024) uint8_t smem[];
    // two copies of one window of seeded pointers (each 2-bit field 0, 1
    // or 2): a block that starts in the upper copy never leaves the buffer
    for (int t = threadIdx.x; t < TA_TB_WIN; t += blockDim.x) {
        uint32_t h = (uint32_t)t * 2654435761u;
        h ^= h >> 15;
        h *= 2246822519u;
        h ^= h >> 13;
        const uint8_t v = (uint8_t)((h % 3) | ((h / 3 % 3) << 2) |
                                    ((h / 9 % 3) << 4));
        smem[t] = v;
        smem[t + TA_TB_WIN] = v;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    int r = 2 * TA_TB_WIN - 1, i = 0, mpt = 0;
    int* out = sink;
    for (int n = 0; n < blocks; ++n) {
        if (r < TA_TB_U * (2 * TA_TB_TW + 1)) r += TA_TB_WIN;
#pragma unroll
        for (int u = 0; u < TA_TB_U; ++u) TA_TB_STEP(r, i, mpt, out[u]);
        out = (n & 1023) == 1023 ? sink : out + TA_TB_U;
    }
    sink[0] = r + i + mpt;
}

typedef CUresult (*TaEncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which PyTorch has loaded.
static TaEncodeTiled ta_encode_tiled() {
    static TaEncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
        if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
        if (h != nullptr)
            fn = (TaEncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
    }
    return fn;
}

// B pairs: packed (B, D, L) uint8, nts/nos (B,) int32 the matrix sizes
// (sentinels included), wire (B, 3 + D + 1) int32.
extern "C" int ta_nw_traceback_batched(const uint8_t* packed, const int* nts,
                                       const int* nos, int* wire, int B,
                                       int D, int L, int device,
                                       void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0 || D <= 0 || L <= 0 || L % TA_TB_TW != 0 ||
        (long long)B * D >= (1LL << 31) ||
        reinterpret_cast<uintptr_t>(packed) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    TaEncodeTiled encode = ta_encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap map;
    const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)B * D};
    const cuuint64_t strides[1] = {(cuuint64_t)L};
    const cuuint32_t box[2] = {TA_TB_TW, TA_TB_TH};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)packed, dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute((const void*)ta_nw_traceback_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TA_TB_SMEM);
    if (e != cudaSuccess) return (int)e;
    ta_nw_traceback_kernel<<<B, 32, TA_TB_SMEM, (cudaStream_t)stream>>>(
        map, nts, nos, wire, D);
    return (int)cudaGetLastError();
}

// steps = blocks * TA_TB_U steps of the walk in shared memory, one thread;
// sink: 1024 * TA_TB_U int32 of device memory for the op stores.
extern "C" int ta_nw_tb_chase(int* sink, int blocks, int device,
                              void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute((const void*)ta_nw_tb_chase_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TA_TB_SMEM);
    if (e != cudaSuccess) return (int)e;
    ta_nw_tb_chase_kernel<<<1, 256, TA_TB_SMEM, (cudaStream_t)stream>>>(
        sink, blocks);
    return (int)cudaGetLastError();
}
