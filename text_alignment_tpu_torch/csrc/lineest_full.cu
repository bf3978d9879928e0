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
// the same orders, so the two agree bit for bit on the card. Terms the kernel
// skips (taps outside the strip's nonzero range, columns outside [0, Wp))
// are exact zeros there: acc + 0 = acc.
//
// What bounds it: the h-gauss, 2 Hp Wp K1 operations a strip (227 M at
// Hp = 96, Wp = 1536, K1 = 769), in float32 outside the tensor cores; the
// bytes are ~1.3 MB a strip. The TPU kernel put the correlation on its MXU
// as banked 128 x 128 Toeplitz tiles; here the taps are read directly:
//   - one block per (strip, row) holds the row, zero padded by r each side,
//     and the taps in shared memory; each thread keeps 8 consecutive outputs
//     in registers and slides a window of 8 inputs, so each tap costs one
//     shared load for the tap (a broadcast) and one for the input, for 8
//     multiply-adds; the row is stored skewed (one pad word every 8) so the
//     lanes' strided loads hit 32 distinct banks;
//   - only the strip's nonzero taps are visited (radius int(4 h + 0.5)).
// One strip's sm (590 KB at Hp = 96, Wp = 1536) is more than one block's
// 227 KB of shared memory, so V and H write their outputs to scratch tensors
// the wrapper allocates (they stay in the 50 MB L2 at folio sizes), and the
// tail reads sm from there; the tail reuses the sm1 scratch for its own.
//
// Layouts: temp (B, Hp, Wp) u8 (ink where != 0), w0 (B, Hp, Hp) f32,
// k1 (B, K1) f32 with K1 odd, hs/ws (B,) i32, k2 (B, K2) f64, sm1 and sm
// (B, Hp, Wp) f32 scratch, center (B, Wp) i32, dsum/dcnt (B,) i32.

#include <cuda_runtime.h>

#include "lineest_tail.cuh"

#define TA_VG_TILE 32
#define TA_VG_ROWS 8
#define TA_HG_OUT 8
#define TA_HG_MAX_THREADS 256

// the skewed index of the padded row: one pad word after every 8
#define TA_SKEW(i) ((i) + ((i) >> 3))

// V: sm1[b, i, x] for every row i and column x
__global__ void ta_full_vgauss(const unsigned char* __restrict__ temp,
                               const float* __restrict__ w0, int Hp, int Wp,
                               float* __restrict__ sm1) {
    extern __shared__ float vsh[];
    float* w = vsh;                                         // Hp * Hp
    unsigned char* t = (unsigned char*)(w + (size_t)Hp * Hp);  // Hp * TILE
    const int b = blockIdx.y;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TA_VG_TILE + tx, nt = TA_VG_TILE * TA_VG_ROWS;
    const int x = blockIdx.x * TA_VG_TILE + tx;
    const float* wb = w0 + (size_t)b * Hp * Hp;
    for (int k = tid; k < Hp * Hp; k += nt) w[k] = wb[k];
    const unsigned char* tb = temp + (size_t)b * Hp * Wp;
    for (int j = ty; j < Hp; j += TA_VG_ROWS)
        t[j * TA_VG_TILE + tx] = (x < Wp) ? tb[(size_t)j * Wp + x] : 0;
    __syncthreads();
    if (x >= Wp) return;
    for (int i = ty; i < Hp; i += TA_VG_ROWS) {
        const float* wr = w + (size_t)i * Hp;
        float acc = 0.0f;
        for (int j = 0; j < Hp; ++j)
            acc = __fadd_rn(acc, t[j * TA_VG_TILE + tx] ? wr[j] : 0.0f);
        sm1[((size_t)b * Hp + i) * Wp + x] = acc;
    }
}

// H: sm[b, i, :] from sm1[b, i, :]; one block per (row, strip)
__global__ void ta_full_hgauss(const float* __restrict__ sm1,
                               const float* __restrict__ k1, int Hp, int Wp,
                               int K1, float* __restrict__ sm) {
    extern __shared__ float hsh[];
    __shared__ int bounds[2];
    const int r = K1 / 2;
    const int L = Wp + 2 * r + TA_HG_OUT;  // padded row length
    float* tap = hsh;                      // K1
    float* xs = hsh + K1;                  // TA_SKEW(L) + 1, skewed
    const int i = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, nt = blockDim.x;
    if (tid == 0) {
        bounds[0] = K1;
        bounds[1] = -1;
    }
    __syncthreads();
    const float* kb = k1 + (size_t)b * K1;
    int lo = K1, hi = -1;
    for (int t = tid; t < K1; t += nt) {
        const float v = kb[t];
        tap[t] = v;
        if (v != 0.0f) {
            lo = min(lo, t);
            hi = max(hi, t);
        }
    }
    atomicMin(&bounds[0], lo);
    atomicMax(&bounds[1], hi);
    const float* row = sm1 + ((size_t)b * Hp + i) * Wp;
    for (int idx = tid; idx < L; idx += nt) {
        const int q = idx - r;
        xs[TA_SKEW(idx)] = (q >= 0 && q < Wp) ? row[q] : 0.0f;
    }
    __syncthreads();
    lo = bounds[0];
    hi = bounds[1];
    float* out = sm + ((size_t)b * Hp + i) * Wp;
    for (int p0 = tid * TA_HG_OUT; p0 < Wp; p0 += nt * TA_HG_OUT) {
        // output p0 + k at tap t reads sm1[p0 + k - r + t] = xs[p0 + k + t]
        float acc[TA_HG_OUT], xw[TA_HG_OUT];
#pragma unroll
        for (int k = 0; k < TA_HG_OUT; ++k) {
            acc[k] = 0.0f;
            xw[k] = xs[TA_SKEW(p0 + k + lo)];
        }
        for (int t = lo; t <= hi; ++t) {
            const float T = tap[t];
#pragma unroll
            for (int k = 0; k < TA_HG_OUT; ++k)
                acc[k] = __fadd_rn(acc[k], __fmul_rn(xw[k], T));
#pragma unroll
            for (int k = 0; k < TA_HG_OUT - 1; ++k) xw[k] = xw[k + 1];
            xw[TA_HG_OUT - 1] = xs[TA_SKEW(p0 + TA_HG_OUT + t)];
        }
#pragma unroll
        for (int k = 0; k < TA_HG_OUT; ++k)
            if (p0 + k < Wp) out[p0 + k] = acc[k];
    }
}

static cudaError_t ta_full_smem_attr(const void* fn, size_t bytes) {
    return cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Dynamic shared memory of the two passes (the wrapper checks them against
// what one block can use before launching).
extern "C" size_t ta_lineest_full_smem(int Hp, int Wp, int K1) {
    const size_t v = (size_t)Hp * Hp * sizeof(float) + (size_t)Hp * TA_VG_TILE;
    const int L = Wp + 2 * (K1 / 2) + TA_HG_OUT;
    const size_t h = ((size_t)K1 + TA_SKEW(L) + 1) * sizeof(float);
    return v > h ? v : h;
}

extern "C" int ta_lineest_full(const unsigned char* temp, const float* w0,
                               const float* k1, const int* hs, const int* ws,
                               const double* k2, int B, int Hp, int Wp,
                               int K1, int K2, float* sm1, float* sm,
                               int* center, int* dsum, int* dcnt, int device,
                               void* stream) {
    // this library links its own CUDA runtime: select PyTorch's device
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0 || Hp <= 0 || Wp <= 0 || K1 <= 0 || (K1 & 1) == 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;

    const size_t smem_v =
        (size_t)Hp * Hp * sizeof(float) + (size_t)Hp * TA_VG_TILE;
    if ((e = ta_full_smem_attr((const void*)ta_full_vgauss, smem_v)))
        return (int)e;
    dim3 grid_v((Wp + TA_VG_TILE - 1) / TA_VG_TILE, B);
    ta_full_vgauss<<<grid_v, dim3(TA_VG_TILE, TA_VG_ROWS), smem_v, st>>>(
        temp, w0, Hp, Wp, sm1);
    if ((e = cudaGetLastError())) return (int)e;

    const int L = Wp + 2 * (K1 / 2) + TA_HG_OUT;
    const size_t smem_h = ((size_t)K1 + TA_SKEW(L) + 1) * sizeof(float);
    if ((e = ta_full_smem_attr((const void*)ta_full_hgauss, smem_h)))
        return (int)e;
    // one thread per 8 outputs, a whole number of warps, at most 256
    int threads = (Wp + TA_HG_OUT - 1) / TA_HG_OUT;
    threads = ((threads + 31) / 32) * 32;
    if (threads > TA_HG_MAX_THREADS) threads = TA_HG_MAX_THREADS;
    ta_full_hgauss<<<dim3(Hp, B), threads, smem_h, st>>>(sm1, k1, Hp, Wp, K1,
                                                         sm);
    if ((e = cudaGetLastError())) return (int)e;

    // the tail on sm, with the sm1 buffer as its scratch
    return ta_lineest_tail(sm, temp, hs, ws, k2, B, Hp, Wp, K2, sm1, center,
                           dsum, dcnt, device, stream);
}
