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
// What bounds it: a strip is one pass of ~Hp*Wp*4 bytes of sm (576 KB at
// Hp = 96, Wp = 1536), more than one block's shared memory, and the three
// stages need the strip along different axes. So the work is three passes,
// each reading device memory once and keeping its working set on chip:
//   A. column-parallel, per (strip, 32-column tile): the tile's column
//      slab in shared memory, each output row's window summed from there;
//   B. row-parallel, per (strip, row): the row in shared memory, its mean,
//      a block prefix scan, the window edges, sm + 0.001 u2, in place;
//   C. per strip: the column argmax, the reflect + k2 smoothing from the
//      (Wp,) argmax row and the taps in shared memory, the center and the
//      MAD sums (one thread per column, exact integer sums).
// The band and prefix products the Pallas body ran on the MXU are the
// kernel's own loops here.
//
// Layouts: sm (B, Hp, Wp) f32, temp (B, Hp, Wp) u8, hs/ws (B,) i32,
// k2 (B, K2) f64 with K2 = 2 r2 + 1, scratch (B, Hp, Wp) f32,
// center (B, Wp) i32, dsum/dcnt (B,) i32. Rows i >= h of scratch are never
// written or read.
//
// The plain version (models/lineest_kernel.py tail_reference) sums every
// window, mean and prefix in the order these passes do, so the two agree
// bit for bit on the card. csrc/lineest_full.cu runs the same passes
// through ta_lineest_tail (lineest_tail.cuh).

#include <cuda_runtime.h>

#include "lineest_tail.cuh"

#define TA_TILE_W 32
#define TA_TILE_Y 8
#define TA_ROW_THREADS 256
#define TA_STRIP_THREADS 512

// A: u[b, i, x] for i < h
__global__ void ta_tail_row_mean(const float* __restrict__ sm,
                                 const int* __restrict__ hs,
                                 const int* __restrict__ ws,
                                 float* __restrict__ u, int Hp, int Wp) {
    extern __shared__ float col[];  // Hp * TA_TILE_W
    const int b = blockIdx.y;
    const int h = hs[b], w = ws[b];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int x = blockIdx.x * TA_TILE_W + tx;
    const float* smb = sm + (size_t)b * Hp * Wp;
    for (int i = ty; i < Hp; i += TA_TILE_Y)
        col[i * TA_TILE_W + tx] =
            (i < h && x < w) ? smb[(size_t)i * Wp + x] : 0.0f;
    __syncthreads();
    if (x >= Wp) return;
    const int s = max((int)(0.5f * (float)h), 1);
    for (int i = ty; i < h; i += TA_TILE_Y) {
        const int lo = i - s / 2;
        const int j1 = min(lo + s - 1, Hp - 1);
        float acc = 0.0f;
        for (int j = max(lo, 0); j <= j1; ++j) acc += col[j * TA_TILE_W + tx];
        u[((size_t)b * Hp + i) * Wp + x] = acc / (float)s;
    }
}

// B: scratch row (b, i) <- sm + 0.001 * u2, for i < h
__global__ void ta_tail_col_mean(const float* __restrict__ sm,
                                 float* __restrict__ u,
                                 const int* __restrict__ hs,
                                 const int* __restrict__ ws, int Hp, int Wp) {
    extern __shared__ float S[];  // Wp
    __shared__ float part[TA_ROW_THREADS];
    const int b = blockIdx.y, i = blockIdx.x;
    if (i >= hs[b]) return;
    const int w = ws[b];
    const int tid = threadIdx.x, nt = blockDim.x;
    float* row = u + ((size_t)b * Hp + i) * Wp;
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
    for (int x = tid; x < Wp; x += nt) {
        const float hi = (x + c1 <= Wp - 1) ? S[x + c1] : last;
        const float lo = (x >= c2) ? S[x - c2] : 0.0f;
        const float n_in =
            (float)(min(x + c1, Wp - 1) - max(x - s / 2, 0) + 1);
        // rounded steps in the plain version's order (no FMA contraction)
        const float u2 =
            __fadd_rn(__fsub_rn(hi, lo), __fmul_rn(n_in, mu)) / (float)s;
        row[x] = __fadd_rn(smrow[x], __fmul_rn(0.001f, u2));
    }
}

// scipy 'reflect' (d c b a | a b c d | d c b a), period 2w, for any x
__device__ __forceinline__ int ta_reflect(int x, int w, int Wp) {
    const int period = 2 * max(w, 1);
    int m = x % period;
    if (m < 0) m += period;
    const int src = (m < w) ? m : period - 1 - m;
    return min(max(src, 0), Wp - 1);
}

// C: argmax, reflect + k2 smoothing, center, MAD sums; one block per strip
__global__ void ta_tail_center(const float* __restrict__ smc,
                               const unsigned char* __restrict__ temp,
                               const int* __restrict__ hs,
                               const int* __restrict__ ws,
                               const double* __restrict__ k2, int Hp,
                               int Wp, int K2, int* __restrict__ center,
                               int* __restrict__ dsum,
                               int* __restrict__ dcnt) {
    extern __shared__ double sh[];
    double* tap = sh;                   // K2
    float* a = (float*)(tap + K2);      // Wp
    __shared__ int red[2];
    const int b = blockIdx.x;
    const int h = hs[b], w = ws[b];
    const int r2 = K2 / 2;
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int k = tid; k < K2; k += nt) tap[k] = k2[(size_t)b * K2 + k];
    if (tid == 0) {
        red[0] = 0;
        red[1] = 0;
    }
    const float* base = smc + (size_t)b * Hp * Wp;
    for (int x = tid; x < Wp; x += nt) {
        int best_i = 0;
        float best = 0.0f;
        for (int i = 0; i < h; ++i) {
            const float v = base[(size_t)i * Wp + x];
            if (i == 0 || v > best) {  // first max wins
                best = v;
                best_i = i;
            }
        }
        a[x] = (x < w) ? (float)best_i : 0.0f;
    }
    __syncthreads();

    const unsigned char* tb = temp + (size_t)b * Hp * Wp;
    int ls = 0, lc = 0;
    for (int x = tid; x < Wp; x += nt) {
        double acc = __dmul_rn((double)a[ta_reflect(x, w, Wp)], tap[r2]);
        for (int j = r2; j >= 1; --j) {
            const double pair = __dadd_rn((double)a[ta_reflect(x - j, w, Wp)],
                                          (double)a[ta_reflect(x + j, w, Wp)]);
            acc = __dadd_rn(acc, __dmul_rn(pair, tap[r2 - j]));
        }
        const int c = (int)acc;  // truncation toward zero
        center[(size_t)b * Wp + x] = c;
        if (x < w) {
            for (int i = 0; i < h; ++i) {
                if (tb[(size_t)i * Wp + x] != 0) {
                    ls += abs(i - c);
                    lc += 1;
                }
            }
        }
    }
    atomicAdd(&red[0], ls);
    atomicAdd(&red[1], lc);
    __syncthreads();
    if (tid == 0) {
        dsum[b] = red[0];
        dcnt[b] = red[1];
    }
}

static cudaError_t ta_smem_attr(const void* fn, size_t bytes) {
    return cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int ta_lineest_tail(const float* sm, const unsigned char* temp,
                               const int* hs, const int* ws, const double* k2,
                               int B, int Hp, int Wp, int K2, float* scratch,
                               int* center, int* dsum, int* dcnt, int device,
                               void* stream) {
    // this library links its own CUDA runtime: select PyTorch's device
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0 || Hp <= 0 || Wp <= 0 || K2 <= 0 || (K2 & 1) == 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;

    const size_t smem_a = (size_t)Hp * TA_TILE_W * sizeof(float);
    if ((e = ta_smem_attr((const void*)ta_tail_row_mean, smem_a)))
        return (int)e;
    dim3 grid_a((Wp + TA_TILE_W - 1) / TA_TILE_W, B);
    ta_tail_row_mean<<<grid_a, dim3(TA_TILE_W, TA_TILE_Y), smem_a, st>>>(
        sm, hs, ws, scratch, Hp, Wp);
    if ((e = cudaGetLastError())) return (int)e;

    const size_t smem_b = (size_t)Wp * sizeof(float);
    if ((e = ta_smem_attr((const void*)ta_tail_col_mean, smem_b)))
        return (int)e;
    ta_tail_col_mean<<<dim3(Hp, B), TA_ROW_THREADS, smem_b, st>>>(
        sm, scratch, hs, ws, Hp, Wp);
    if ((e = cudaGetLastError())) return (int)e;

    const size_t smem_c = (size_t)K2 * sizeof(double) + (size_t)Wp * sizeof(float);
    if ((e = ta_smem_attr((const void*)ta_tail_center, smem_c)))
        return (int)e;
    ta_tail_center<<<B, TA_STRIP_THREADS, smem_c, st>>>(
        scratch, temp, hs, ws, k2, Hp, Wp, K2, center, dsum, dcnt);
    return (int)cudaGetLastError();
}
