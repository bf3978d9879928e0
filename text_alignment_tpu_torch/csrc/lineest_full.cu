// The whole center chain of the batched line normalizer, from the ink mask.
//
// Replaces the Pallas TPU kernel text_alignment_tpu/models/lineest_pallas.py
// center_from_temp (body _make_full_kernel, launched by _jit_full, fed the
// Toeplitz tiles of hgauss_tiles). Per strip b of true size (h, w) inside the
// padded (Hp, Wp) batch, from the ink mask temp alone:
//   V. sm1[i, q] = sum_j w0[i, j] * temp[j, q], the axis-0 gaussian as the
//      strip's (Hp, Hp) bank, summed over j ascending (the products
//      w0 * {0, 1} are exact, so each term is w0[i, j] or 0);
//   H. sm[i, p]  = sum_t sm1[i, p - r + t] * k1[t], the axis-1 gaussian as a
//      zero-padded correlation with the strip's K1 = 2 r + 1 taps, summed
//      over t ascending (q = p - r .. p + r), each product and sum rounded on
//      its own (__fmul_rn, __fadd_rn: no FMA contraction);
//   then the tail of csrc/lineest_tail.cu (ta_lineest_tail, shared through
//   lineest_tail.cuh) on sm: center (B, Wp) i32, dsum and dcnt (B,) i32.
// The plain version (models/lineest_kernel.py center_full_reference) sums in
// the same orders, so the two agree bit for bit on the card.
//
// Only the strip's own rows i < h and columns p < w are computed. The tail
// reads sm nowhere else (its passes mask rows >= h and columns >= w, and the
// argmax of a column >= w is dropped), and the terms skipped inside are
// exact zeros on the batches the normalizer builds, where the ink mask is
// zero outside each strip's (h, w): a row j >= h adds w0 * 0, a column
// q >= w of sm1 is 0 (so it pads the h-gauss like the columns past Wp), and
// x * 0 and acc + 0 leave every sum as it was (all terms are >= 0). The
// kernel writes zeros to sm's columns [w, Wp) of rows i < h and leaves rows
// i >= h unwritten.
//
// What bounds it: the h-gauss, 2 h w n1 operations a strip (n1 the strip's
// nonzero taps, ~8 h + 1), in float32 outside the tensor cores; the bytes
// are the mask and the bank, ~0.2 MB a strip. The TPU kernel put both
// gaussians on its MXU as banked 128 x 128 Toeplitz tiles; here V and H are
// one launch, a CTA per (pair of rows, strip b):
//   - V builds the two rows of sm1 in shared memory from those rows of the
//     bank (Hp floats each) and the strip's mask, read from L2 a byte a
//     pixel once for both rows (the mask is read h / 2 times a strip, the
//     pass's largest byte stream), j ascending, so sm1 never goes through
//     device memory;
//   - H keeps 8 consecutive outputs a thread in registers with two
//     windows of 8 inputs used in turn, and takes the taps 8 at a time as
//     two float4 broadcasts: per 8 taps, 8 input loads and 2 tap loads feed
//     64 multiplies and 64 adds, with no register moves; the row is stored
//     skewed (one pad word every 8) so that the lanes' strided loads hit
//     32 distinct banks; each thread visits only the taps that reach its
//     outputs' columns [0, w) among the strip's nonzero taps (radius
//     int(4 h + 0.5)), rounded out to pairs of 8 with zero taps or zero
//     inputs.
// Then the tail of csrc/lineest_tail.cu (three passes) on sm: four launches.
//
// Layouts: temp (B, Hp, Wp) u8 (ink where != 0), w0 (B, Hp, Hp) f32,
// k1 (B, K1) f32 with K1 odd, hs/ws (B,) i32, k2 (B, K2) f64, sm (B, Hp, Wp)
// f32, scratch (B, Hp, Wp) f32 and keys (B, Wp) u64 (the tail's), center
// (B, Wp) i32, dsum/dcnt (B,) i32.

#include <cuda_runtime.h>

#include "lineest_tail.cuh"

#define TA_FULL_OUT 8           // outputs a thread, consecutive columns
#define TA_FULL_TAPS 8          // taps a step of the h-gauss loop
#define TA_FULL_VCOLS 4         // v-gauss columns a thread at a time
#define TA_FULL_MAX_THREADS 256 // threads a row
#define TA_FULL_ROWS 2          // rows a CTA: one read of the mask for both
// TA_FULL_NO_V / TA_FULL_NO_H (chip_ablation.py only) skip the v-gauss or
// the h-gauss; the outputs are then wrong, only the time means anything.

// the skewed index of the padded row: one pad word after every 8
#define TA_SKEW(i) ((i) + ((i) >> 3))

// taps in shared memory: K1 rounded up to 8, and 8 more zeros for the
// h-gauss loop's even step count
__host__ __device__ inline int ta_full_taps_padded(int K1) {
    return (K1 + TA_FULL_TAPS - 1) / TA_FULL_TAPS * TA_FULL_TAPS +
           TA_FULL_TAPS;
}

// entries of the padded sm1 row: index p + t for output p < Wp, tap t <
// K1p, and the window of 3 * TA_FULL_TAPS the loop reads past it
__host__ __device__ inline int ta_full_row_len(int Wp, int K1p) {
    return Wp + K1p + 3 * TA_FULL_TAPS;
}

// 8 taps on 8 outputs: acc[k] += x[k + s] * t[s], s ascending, x = u ++ v,
// each product and sum rounded on its own
__device__ __forceinline__ void ta_full_step(float (&acc)[TA_FULL_OUT],
                                             const float (&u)[TA_FULL_TAPS],
                                             const float (&v)[TA_FULL_TAPS],
                                             float4 ta, float4 tb) {
    const float t[TA_FULL_TAPS] = {ta.x, ta.y, ta.z, ta.w,
                                   tb.x, tb.y, tb.z, tb.w};
#pragma unroll
    for (int s = 0; s < TA_FULL_TAPS; ++s)
#pragma unroll
        for (int k = 0; k < TA_FULL_OUT; ++k) {
            const float x = k + s < TA_FULL_TAPS ? u[k + s]
                                                 : v[k + s - TA_FULL_TAPS];
            acc[k] = __fadd_rn(acc[k], __fmul_rn(x, t[s]));
        }
}

// sm[b, i, :] for i < h; one CTA per (pair of rows i0, i0 + 1, strip b),
// blockDim.x = TA_FULL_ROWS * nt threads, nt per row in H
__global__ void ta_full_vh(const unsigned char* __restrict__ temp,
                           const float* __restrict__ w0,
                           const float* __restrict__ k1,
                           const int* __restrict__ hs,
                           const int* __restrict__ ws, int Hp, int Wp, int K1,
                           float* __restrict__ sm) {
    extern __shared__ float4 sh4[];
    __shared__ int bounds[2];
    const int K1p = ta_full_taps_padded(K1), L = ta_full_row_len(Wp, K1p);
    const int XS = TA_SKEW(L) + 1;
    float* tap = (float*)sh4;  // K1p, zero past K1; 16-byte aligned
    float* wrow = tap + K1p;   // TA_FULL_ROWS x Hp: the rows of the bank
    float* xs = wrow + TA_FULL_ROWS * Hp;  // TA_FULL_ROWS x XS: sm1 rows
    const int i0 = blockIdx.x * TA_FULL_ROWS, b = blockIdx.y;
    const int h = min(hs[b], Hp), w = min(ws[b], Wp);
    if (i0 >= h || w <= 0) return;  // rows the tail never reads
    const int r = K1 / 2;
    const int tid = threadIdx.x, nt = blockDim.x;
    if (tid == 0) {
        bounds[0] = K1;
        bounds[1] = -1;
    }
    __syncthreads();
    const float* kb = k1 + (size_t)b * K1;
    int lo = K1, hi = -1;
    for (int t = tid; t < K1p; t += nt) {
        const float v = t < K1 ? kb[t] : 0.0f;
        tap[t] = v;
        if (v != 0.0f) {
            lo = min(lo, t);
            hi = max(hi, t);
        }
    }
    atomicMin(&bounds[0], lo);
    atomicMax(&bounds[1], hi);
    const float* wb = w0 + ((size_t)b * Hp + i0) * Hp;
    for (int j = tid; j < TA_FULL_ROWS * Hp; j += nt)
        wrow[j] = i0 + j / Hp < Hp ? wb[j] : 0.0f;
    for (int idx = tid; idx < TA_FULL_ROWS * L; idx += nt) {
        const int q = idx % L - r;  // zeros outside [0, w)
        if (q < 0 || q >= w) xs[idx / L * XS + TA_SKEW(idx % L)] = 0.0f;
    }
    __syncthreads();

#ifndef TA_FULL_NO_V
    // V: sm1[i, q] = sum over j < h, ascending, of (ink ? w0[i, j] : 0),
    // for both rows from one read of the mask
    const unsigned char* tb = temp + (size_t)b * Hp * Wp;
    for (int q0 = tid; q0 < w; q0 += nt * TA_FULL_VCOLS) {
        float acc[TA_FULL_ROWS][TA_FULL_VCOLS];
#pragma unroll
        for (int g = 0; g < TA_FULL_ROWS; ++g)
#pragma unroll
            for (int m = 0; m < TA_FULL_VCOLS; ++m) acc[g][m] = 0.0f;
#pragma unroll 8
        for (int j = 0; j < h; ++j) {
            const unsigned char* trow = tb + (size_t)j * Wp;
#pragma unroll
            for (int m = 0; m < TA_FULL_VCOLS; ++m) {
                const int q = q0 + m * nt;
                const bool ink = q < w && trow[q] != 0;
#pragma unroll
                for (int g = 0; g < TA_FULL_ROWS; ++g)
                    acc[g][m] = __fadd_rn(acc[g][m],
                                          ink ? wrow[g * Hp + j] : 0.0f);
            }
        }
#pragma unroll
        for (int m = 0; m < TA_FULL_VCOLS; ++m) {
            const int q = q0 + m * nt;
            if (q < w)
#pragma unroll
                for (int g = 0; g < TA_FULL_ROWS; ++g)
                    xs[g * XS + TA_SKEW(q + r)] = acc[g][m];
        }
    }
#endif
    __syncthreads();

    // H: sm[i, p] = sum over t ascending of sm1[i, p - r + t] * k1[t], for
    // p < w; output p + k at tap t reads xs[p + k + t]. A thread walks its
    // window in steps of 8 taps, two at a time, loading 8 inputs a step
    // into the register window it no longer needs; p0 and the first tap are
    // multiples of 8, so the skewed index of the window's start grows by 9
    // a step and the tap loads are aligned float4 broadcasts.
    lo = bounds[0];
    hi = bounds[1];
    const int nr = nt / TA_FULL_ROWS, g = tid / nr, i = i0 + g;
    if (i >= h) return;
    const float* xrow = xs + g * XS;
    float* out = sm + ((size_t)b * Hp + i) * Wp;
    for (int p0 = (tid % nr) * TA_FULL_OUT; p0 < w;
         p0 += nr * TA_FULL_OUT) {
        float acc[TA_FULL_OUT];
#pragma unroll
        for (int k = 0; k < TA_FULL_OUT; ++k) acc[k] = 0.0f;
#ifndef TA_FULL_NO_H
        // the taps that reach columns [0, w) from outputs p0 .. p0 + 7,
        // rounded out to whole pairs of steps with zero taps
        const int t_end = min(hi, r - p0 + w - 1);
        const int t_beg = max(lo, r - p0 - (TA_FULL_OUT - 1)) &
                          ~(TA_FULL_TAPS - 1);
        if (t_beg <= t_end) {
            const int steps = ((t_end - t_beg) / TA_FULL_TAPS + 2) & ~1;
            const float* xp = xrow + TA_SKEW(p0 + t_beg);
            const float4* tp = (const float4*)(tap + t_beg);
            float u[TA_FULL_TAPS], v[TA_FULL_TAPS];
#pragma unroll
            for (int m = 0; m < TA_FULL_TAPS; ++m) u[m] = xp[m];
            for (int st = 0; st < steps; st += 2) {
#pragma unroll
                for (int m = 0; m < TA_FULL_TAPS; ++m) v[m] = xp[9 + m];
                ta_full_step(acc, u, v, tp[0], tp[1]);
#pragma unroll
                for (int m = 0; m < TA_FULL_TAPS; ++m) u[m] = xp[18 + m];
                ta_full_step(acc, v, u, tp[2], tp[3]);
                xp += 18;
                tp += 4;
            }
        }
#endif
#pragma unroll
        for (int k = 0; k < TA_FULL_OUT; ++k)
            if (p0 + k < w) out[p0 + k] = acc[k];
    }
    for (int p = w + tid % nr; p < Wp; p += nr) out[p] = 0.0f;
}

// Dynamic shared memory of the fused pass (the wrapper checks it, and the
// tail's, against what one block can use before launching).
extern "C" size_t ta_lineest_full_smem(int Hp, int Wp, int K1) {
    const int K1p = ta_full_taps_padded(K1);
    return ((size_t)K1p + TA_FULL_ROWS * (size_t)Hp +
            TA_FULL_ROWS * ((size_t)TA_SKEW(ta_full_row_len(Wp, K1p)) + 1)) *
           sizeof(float);
}

extern "C" int ta_lineest_full(const unsigned char* temp, const float* w0,
                               const float* k1, const int* hs, const int* ws,
                               const double* k2, int B, int Hp, int Wp,
                               int K1, int K2, float* scratch, float* sm,
                               unsigned long long* keys, int* center,
                               int* dsum, int* dcnt, int device,
                               void* stream) {
    // this library links its own CUDA runtime: select PyTorch's device
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0 || Hp <= 0 || Wp <= 0 || K1 <= 0 || (K1 & 1) == 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;

    const size_t smem = ta_lineest_full_smem(Hp, Wp, K1);
    e = cudaFuncSetAttribute((const void*)ta_full_vh,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    // a row: one thread per 8 outputs, a whole number of warps, at most 256
    int threads = (Wp + TA_FULL_OUT - 1) / TA_FULL_OUT;
    threads = ((threads + 31) / 32) * 32;
    if (threads > TA_FULL_MAX_THREADS) threads = TA_FULL_MAX_THREADS;
    const dim3 grid((Hp + TA_FULL_ROWS - 1) / TA_FULL_ROWS, B);
    ta_full_vh<<<grid, TA_FULL_ROWS * threads, smem, st>>>(
        temp, w0, k1, hs, ws, Hp, Wp, K1, sm);
    if ((e = cudaGetLastError())) return (int)e;

    return ta_lineest_tail(sm, temp, hs, ws, k2, B, Hp, Wp, K2, scratch,
                           keys, center, dsum, dcnt, device, stream);
}
