// Center-finding tail of the batched line normalizer.
//
// Replaces the Pallas TPU kernel text_alignment_tpu/models/lineest_pallas.py
// tail_from_sm (body _tail_body, launched by _jit_tail). Per strip b of
// true size (h, w) inside the padded (Hp, Wp) batch, from the h-gauss output
// sm and the ink mask temp:
//   1. u  = windowed mean over rows of sm (zeroed outside (h, w)), window
//           s = max(int(0.5 h), 1) starting at i - s/2, zero padded;
//   2. u2 = windowed mean over columns of u, window w, as a difference of
//           prefix sums of the row centred on its mean (the centring keeps
//           the f32 prefix from cancelling at large x, which would flip the
//           argmax below);
//   3. a[x] = first row i < h maximising sm + 0.001 u2 (0 for x >= w);
//   4. a reflect-extended (scipy 'reflect', period 2w, any w), smoothed by
//      the strip's sigma = 0.3 h gaussian taps k2 and truncated to int:
//      center[x]. In float64, in scipy correlate1d's order for symmetric
//      taps (centre term, then left + right pairs from the outermost in,
//      no FMA contraction): on a plateau of argmax k the sum is
//      k * sum(k2), whose truncation to k or k - 1 follows its last bit,
//      so only scipy's arithmetic gives scipy's center there;
//   5. dsum = sum |i - center[x]| and dcnt = count over ink pixels.
// Semantics are those of the XLA tail, lineest_jax.normalize_batch_device
// (text_alignment_tpu/models/lineest_jax.py:514-565).
//
// What bounds it: the bytes, one read of sm (~Hp*Wp*4 a strip, 576 KB at
// Hp = 96, Wp = 1536) and of the ink mask, for a (Wp,) result a strip. The
// stages need the strip along different axes, so the work is three passes,
// every one a grid of at least one CTA an SM at the folio's batch:
//   A. per (strip, 32-column tile): the tile's column slab in shared
//      memory, each output row's window summed from there into u, a
//      thread's TA_ROW_GROUP consecutive rows from one walk over their
//      joined windows (a load of the slab serves them all; each window
//      still sums in ascending order); also zeroes the argmax keys and
//      dsum/dcnt the later passes accumulate;
//   B. per (strip, row): the row of u in shared memory, its mean, a block
//      prefix scan, the window edges, v = sm + 0.001 u2, and for each
//      column x < w one atomicMax of the 64-bit key (order-preserving
//      bits of v, Hp - 1 - i) into keys[b, x]: the largest key is the
//      first maximum, and a max is the same in any order, so the argmax
//      never goes through device memory as a (Hp, Wp) array;
//   C. per (strip, TA_CENTER_T-column tile): the tile's argmax row and a
//      halo of r_b columns each side decoded from the keys into shared
//      memory, each element's reflect source computed once; each column
//      smoothed from there (one thread a column, only the taps up to the
//      strip's outermost nonzero one: every tap beyond is an exact zero,
//      whose term (+finite) x 0 = +0 leaves a sum >= 0 as it was); then
//      the MAD over the tile's ink, read 16 bytes a load (the first loads
//      issued before the smoothing), reduced in the CTA and added with
//      one atomicAdd a counter (integer sums, exact in any order).
// The band and prefix products the Pallas body ran on the MXU are the
// kernel's own loops here.
//
// Layouts: sm (B, Hp, Wp) f32, temp (B, Hp, Wp) u8, hs/ws (B,) i32,
// k2 (B, K2) f64 with K2 = 2 r2 + 1, scratch (B, Hp, Wp) f32 (u), keys
// (B, Wp) u64, center (B, Wp) i32, dsum/dcnt (B,) i32. Rows i >= h of
// scratch are never written or read.
//
// The plain version (models/lineest_kernel.py tail_reference) sums every
// window, mean and prefix in the order these passes do, so the two agree
// bit for bit on the card. csrc/lineest_full.cu runs the same passes
// through ta_lineest_tail (lineest_tail.cuh).

#include <cuda_runtime.h>

#include "lineest_tail.cuh"

#define TA_TILE_W 32
#define TA_TILE_Y 8
#define TA_ROW_GROUP 4  // consecutive output rows a thread of pass A sums
#define TA_ROW_THREADS 256
#define TA_CENTER_T 128  // columns, and threads, a CTA of pass C
#define TA_CENTER_WARPS (TA_CENTER_T / 32)
#define TA_CENTER_LOADS (TA_CENTER_T / 16)  // 16-byte loads a tile row
#define TA_MAD_ROWS (TA_CENTER_T / TA_CENTER_LOADS)  // rows a step of the MAD
#define TA_MAD_AHEAD 4  // MAD steps whose ink loads precede the smoothing

// A: u[b, i, x] for i < h; zeroes keys[b, x] and dsum[b], dcnt[b]
__global__ void ta_tail_row_mean(const float* __restrict__ sm,
                                 const int* __restrict__ hs,
                                 const int* __restrict__ ws,
                                 float* __restrict__ u,
                                 unsigned long long* __restrict__ keys,
                                 int* __restrict__ dsum,
                                 int* __restrict__ dcnt, int Hp, int Wp) {
    extern __shared__ float col[];  // Hp * TA_TILE_W
    const int b = blockIdx.y;
    const int h = hs[b], w = ws[b];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int x = blockIdx.x * TA_TILE_W + tx;
    if (ty == 0 && x < Wp) keys[(size_t)b * Wp + x] = 0ull;
    if (blockIdx.x == 0 && tx == 0 && ty == 0) {
        dsum[b] = 0;
        dcnt[b] = 0;
    }
    const float* smb = sm + (size_t)b * Hp * Wp;
#pragma unroll 4
    for (int i = ty; i < Hp; i += TA_TILE_Y)
        col[i * TA_TILE_W + tx] =
            (i < h && x < w) ? smb[(size_t)i * Wp + x] : 0.0f;
    __syncthreads();
    if (x >= Wp) return;
    // rows i0 + k, k < TA_ROW_GROUP, from one walk over their joined
    // windows: row i0 + k adds the slab rows lo + d, d in [k, k + s - 1],
    // inside [0, Hp), ascending from 0, one load of col a row for all of
    // them; every row takes the rows d in [TA_ROW_GROUP - 1, s - 1], so only
    // the walk's first and last TA_ROW_GROUP - 1 rows test
    const int s = max((int)(0.5f * (float)h), 1);
    for (int i0 = ty * TA_ROW_GROUP; i0 < h;
         i0 += TA_TILE_Y * TA_ROW_GROUP) {
        const int lo = i0 - s / 2;
        const int d1 = min(TA_ROW_GROUP - 1 + s - 1, Hp - 1 - lo);
        const float* cl = col + tx;
        float acc[TA_ROW_GROUP];
#pragma unroll
        for (int k = 0; k < TA_ROW_GROUP; ++k) acc[k] = 0.0f;
        int d = max(-lo, 0);
        for (; d <= d1 && d < TA_ROW_GROUP - 1; ++d) {
            const float v = cl[(lo + d) * TA_TILE_W];
#pragma unroll
            for (int k = 0; k < TA_ROW_GROUP; ++k)
                if (d >= k && d < k + s) acc[k] += v;
        }
#pragma unroll 4
        for (; d <= min(d1, s - 1); ++d) {
            const float v = cl[(lo + d) * TA_TILE_W];
#pragma unroll
            for (int k = 0; k < TA_ROW_GROUP; ++k) acc[k] += v;
        }
        for (; d <= d1; ++d) {
            const float v = cl[(lo + d) * TA_TILE_W];
#pragma unroll
            for (int k = 0; k < TA_ROW_GROUP; ++k)
                if (d >= k && d < k + s) acc[k] += v;
        }
#pragma unroll
        for (int k = 0; k < TA_ROW_GROUP; ++k)
            if (i0 + k < h)
                u[((size_t)b * Hp + i0 + k) * Wp + x] = acc[k] / (float)s;
    }
}

// The argmax key of value v at row i: the high word orders as v does (the
// float's bits, sign-flipped for v >= 0 and inverted for v < 0; -0.0 is
// taken as +0.0, which compares equal to it), the low word Hp - 1 - i puts
// the first row ahead among equal values. Every finite v gives a high word
// > 0, so a key of 0 means "no row".
__device__ __forceinline__ unsigned long long ta_argmax_key(float v, int i,
                                                            int Hp) {
    unsigned bits = __float_as_uint(v == 0.0f ? 0.0f : v);
    bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
    return ((unsigned long long)bits << 32) | (unsigned)(Hp - 1 - i);
}

// B: keys[b, x] = max(keys[b, x], key(sm + 0.001 * u2, i)) for row (b, i),
// i < h, and every x < w
__global__ void ta_tail_col_mean(const float* __restrict__ sm,
                                 const float* __restrict__ u,
                                 const int* __restrict__ hs,
                                 const int* __restrict__ ws,
                                 unsigned long long* __restrict__ keys,
                                 int Hp, int Wp) {
    extern __shared__ float S[];  // Wp
    __shared__ float part[TA_ROW_THREADS];
    const int b = blockIdx.y, i = blockIdx.x;
    if (i >= hs[b]) return;
    const int w = ws[b];
    const int tid = threadIdx.x, nt = TA_ROW_THREADS;
    const float* row = u + ((size_t)b * Hp + i) * Wp;
    const float* smrow = sm + ((size_t)b * Hp + i) * Wp;

    float acc = 0.0f;
    for (int x = tid; x < Wp; x += nt) {
        const float v = row[x];
        S[x] = v;
        acc += v;
    }
    part[tid] = acc;
    __syncthreads();
    for (int k = nt / 2; k > 0; k >>= 1) {
        if (tid < k) part[tid] += part[tid + k];
        __syncthreads();
    }
    const float mu = part[0] / (float)Wp;
    __syncthreads();

    // inclusive prefix of (u - mu): each thread scans a contiguous chunk,
    // thread 0 scans the chunk totals, each chunk adds its offset
    const int chunk = (Wp + nt - 1) / nt;
    const int a0 = min(tid * chunk, Wp), a1 = min(a0 + chunk, Wp);
    float run = 0.0f;
    for (int x = a0; x < a1; ++x) {
        run = __fadd_rn(run, __fsub_rn(S[x], mu));
        S[x] = run;
    }
    part[tid] = run;
    __syncthreads();
    if (tid == 0) {
        float off = 0.0f;
        for (int k = 0; k < nt; ++k) {
            const float t = part[k];
            part[k] = off;
            off += t;
        }
    }
    __syncthreads();
    const float off = part[tid];
    for (int x = a0; x < a1; ++x) S[x] += off;
    __syncthreads();

    const int s = max(w, 1);
    const int c1 = s - 1 - s / 2;
    const int c2 = s / 2 + 1;
    const float last = S[Wp - 1];
    unsigned long long* kb = keys + (size_t)b * Wp;
    for (int x = tid; x < min(w, Wp); x += nt) {
        const float hi = (x + c1 <= Wp - 1) ? S[x + c1] : last;
        const float lo = (x >= c2) ? S[x - c2] : 0.0f;
        const float n_in =
            (float)(min(x + c1, Wp - 1) - max(x - s / 2, 0) + 1);
        // rounded steps in the plain version's order (no FMA contraction)
        const float u2 =
            __fadd_rn(__fsub_rn(hi, lo), __fmul_rn(n_in, mu)) / (float)s;
        atomicMax(kb + x, ta_argmax_key(
                              __fadd_rn(smrow[x], __fmul_rn(0.001f, u2)), i,
                              Hp));
    }
}

// MAD terms of 16 ink bytes q of row i at tile columns g .. g + ng - 1
__device__ __forceinline__ void ta_mad16(uint4 q, int i, int g, int ng,
                                         const int* cen, int& ls, int& lc) {
    const unsigned wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 16; ++k)
        if (k < ng && ((wd[k >> 2] >> (8 * (k & 3))) & 0xffu)) {
            ls += abs(i - cen[g + k]);
            lc += 1;
        }
}

// C: per (column tile, strip): the argmax row with its halo, the reflect +
// k2 smoothing, center, and the tile's MAD sums added into dsum, dcnt
__global__ void __launch_bounds__(TA_CENTER_T)
    ta_tail_center(const unsigned long long* __restrict__ keys,
                   const unsigned char* __restrict__ temp,
                   const int* __restrict__ hs, const int* __restrict__ ws,
                   const double* __restrict__ k2, int Hp, int Wp, int K2,
                   int* __restrict__ center, int* __restrict__ dsum,
                   int* __restrict__ dcnt) {
    extern __shared__ double sh[];
    const int r2 = K2 / 2;
    double* tap = sh;                         // r2 + 1: tap[j] = k2[b, r2 - j]
    double* a = tap + r2 + 1;                 // TA_CENTER_T + 2 r2
    int* cen = (int*)(a + TA_CENTER_T + 2 * r2);  // TA_CENTER_T
    __shared__ int red[1 + 2 * TA_CENTER_WARPS];
    const int b = blockIdx.y, x0 = blockIdx.x * TA_CENTER_T;
    const int h = hs[b], w = ws[b];
    const int tid = threadIdx.x;
    if (tid == 0) red[0] = 0;

    // the MAD reads the ink of columns x0 + g .. x0 + g + ng - 1, rows
    // i0, i0 + TA_MAD_ROWS, ... below h, 16 bytes a load where the rows
    // allow; the first TA_MAD_AHEAD loads are issued now, under the
    // smoothing
    const unsigned char* tb = temp + (size_t)b * Hp * Wp + x0;
    const bool wide = (Wp & 15) == 0 && ((size_t)temp & 15) == 0;
    const int g = (tid % TA_CENTER_LOADS) * 16, i0 = tid / TA_CENTER_LOADS;
    const int tw = min(TA_CENTER_T, w - x0), ng = min(16, tw - g);
    uint4 ahead[TA_MAD_AHEAD];
#pragma unroll
    for (int r = 0; r < TA_MAD_AHEAD; ++r) {
        const int i = i0 + r * TA_MAD_ROWS;
        ahead[r] = (wide && ng > 0 && i < h)
                       ? *(const uint4*)(tb + (size_t)i * Wp + g)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    // the taps, and the strip's radius r_b: its outermost nonzero tap
    int rb = 0;
    for (int j = tid; j <= r2; j += TA_CENTER_T) {
        const double t = k2[(size_t)b * K2 + r2 - j];
        tap[j] = t;
        if (t != 0.0) rb = j;
    }
    atomicMax(&red[0], rb);
    __syncthreads();
    rb = red[0];

    // a[k] = argmax row at column x0 - r_b + k through scipy's reflect
    // (d c b a | a b c d | d c b a), period 2w, any x
    const int period = 2 * max(w, 1);
    const unsigned long long* kb = keys + (size_t)b * Wp;
    for (int k = tid; k < TA_CENTER_T + 2 * rb; k += TA_CENTER_T) {
        int m = (x0 - rb + k) % period;
        if (m < 0) m += period;
        const int src = min(max(m < w ? m : period - 1 - m, 0), Wp - 1);
        double v = 0.0;
        if (src < w) {
            const unsigned long long key = kb[src];
            if (key != 0ull) v = (double)(Hp - 1 - (int)(unsigned)key);
        }
        a[k] = v;
    }
    __syncthreads();

    const int x = x0 + tid;
    if (x < Wp) {
        const double* ac = a + rb + tid;
        double acc = __dmul_rn(ac[0], tap[0]);
        for (int j = rb; j >= 1; --j)
            acc = __dadd_rn(acc,
                            __dmul_rn(__dadd_rn(ac[-j], ac[j]), tap[j]));
        const int c = (int)acc;  // truncation toward zero
        cen[tid] = c;
        center[(size_t)b * Wp + x] = c;
    }
    __syncthreads();

    // MAD over the tile's columns x < w and rows i < h
    int ls = 0, lc = 0;
    if (tw > 0) {
        if (wide) {
#pragma unroll
            for (int r = 0; r < TA_MAD_AHEAD; ++r)
                ta_mad16(ahead[r], i0 + r * TA_MAD_ROWS, g, ng, cen, ls, lc);
#pragma unroll 2
            for (int i = i0 + TA_MAD_AHEAD * TA_MAD_ROWS; ng > 0 && i < h;
                 i += TA_MAD_ROWS)
                ta_mad16(*(const uint4*)(tb + (size_t)i * Wp + g), i, g, ng,
                         cen, ls, lc);
        } else {
            for (int idx = tid; idx < h * tw; idx += TA_CENTER_T) {
                const int i = idx / tw, xl = idx - i * tw;
                if (tb[(size_t)i * Wp + xl] != 0) {
                    ls += abs(i - cen[xl]);
                    lc += 1;
                }
            }
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        ls += __shfl_down_sync(0xffffffffu, ls, o);
        lc += __shfl_down_sync(0xffffffffu, lc, o);
    }
    if ((tid & 31) == 0) {
        red[1 + 2 * (tid >> 5)] = ls;
        red[2 + 2 * (tid >> 5)] = lc;
    }
    __syncthreads();
    if (tid == 0) {
        int s = 0, c = 0;
        for (int k = 0; k < TA_CENTER_WARPS; ++k) {
            s += red[1 + 2 * k];
            c += red[2 + 2 * k];
        }
        if (c != 0) {
            atomicAdd(&dsum[b], s);
            atomicAdd(&dcnt[b], c);
        }
    }
}

// The three launches' grids, threads and dynamic shared bytes.
struct TaTailPlan {
    dim3 grid[3], block[3];
    size_t dyn[3];
};

static TaTailPlan ta_tail_plan(int B, int Hp, int Wp, int K2) {
    TaTailPlan p;
    const int r2 = K2 / 2;
    p.grid[0] = dim3((Wp + TA_TILE_W - 1) / TA_TILE_W, B);
    p.block[0] = dim3(TA_TILE_W, TA_TILE_Y);
    p.dyn[0] = (size_t)Hp * TA_TILE_W * sizeof(float);
    p.grid[1] = dim3(Hp, B);
    p.block[1] = dim3(TA_ROW_THREADS);
    p.dyn[1] = (size_t)Wp * sizeof(float);
    p.grid[2] = dim3((Wp + TA_CENTER_T - 1) / TA_CENTER_T, B);
    p.block[2] = dim3(TA_CENTER_T);
    p.dyn[2] = ((size_t)r2 + 1 + TA_CENTER_T + 2 * (size_t)r2) *
                   sizeof(double) +
               TA_CENTER_T * sizeof(int);
    return p;
}

// out[5 k .. 5 k + 4] = grid x, grid y, threads, shared bytes (dynamic +
// the compiler's static) and registers a thread of launch k = A, B, C; the
// wrapper checks the shared bytes against what one block can use,
// chip_smoke prints the rest. Returns a CUDA error code (0 on success).
extern "C" int ta_lineest_tail_plan(int B, int Hp, int Wp, int K2,
                                    int device, int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const TaTailPlan p = ta_tail_plan(B, Hp, Wp, K2);
    const void* fns[3] = {(const void*)ta_tail_row_mean,
                          (const void*)ta_tail_col_mean,
                          (const void*)ta_tail_center};
    for (int k = 0; k < 3; ++k) {
        cudaFuncAttributes a;
        if ((e = cudaFuncGetAttributes(&a, fns[k]))) return (int)e;
        out[5 * k] = (int)p.grid[k].x;
        out[5 * k + 1] = (int)p.grid[k].y;
        out[5 * k + 2] = (int)(p.block[k].x * p.block[k].y);
        out[5 * k + 3] = (int)(p.dyn[k] + a.sharedSizeBytes);
        out[5 * k + 4] = a.numRegs;
    }
    return 0;
}

// a launch above the default 48 KB of dynamic shared memory must ask for it
static cudaError_t ta_smem_attr(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int ta_lineest_tail(const float* sm, const unsigned char* temp,
                               const int* hs, const int* ws, const double* k2,
                               int B, int Hp, int Wp, int K2, float* scratch,
                               unsigned long long* keys, int* center,
                               int* dsum, int* dcnt, int device,
                               void* stream) {
    // this library links its own CUDA runtime: select PyTorch's device
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0 || Hp <= 0 || Wp <= 0 || K2 <= 0 || (K2 & 1) == 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const TaTailPlan p = ta_tail_plan(B, Hp, Wp, K2);

    if ((e = ta_smem_attr((const void*)ta_tail_row_mean, p.dyn[0])))
        return (int)e;
    ta_tail_row_mean<<<p.grid[0], p.block[0], p.dyn[0], st>>>(
        sm, hs, ws, scratch, keys, dsum, dcnt, Hp, Wp);
    if ((e = cudaGetLastError())) return (int)e;

    if ((e = ta_smem_attr((const void*)ta_tail_col_mean, p.dyn[1])))
        return (int)e;
    ta_tail_col_mean<<<p.grid[1], p.block[1], p.dyn[1], st>>>(
        sm, scratch, hs, ws, keys, Hp, Wp);
    if ((e = cudaGetLastError())) return (int)e;

    if ((e = ta_smem_attr((const void*)ta_tail_center, p.dyn[2])))
        return (int)e;
    ta_tail_center<<<p.grid[2], p.block[2], p.dyn[2], st>>>(
        keys, temp, hs, ws, k2, Hp, Wp, K2, center, dsum, dcnt);
    return (int)cudaGetLastError();
}
