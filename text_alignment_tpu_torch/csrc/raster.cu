// Rotate + erode + project over a bit-packed page: the folio's raster step
// between the cleanup chain (ta_cc_clean) and the line finder's CC table
// (ta_cc_table).
//
// Replaces no Pallas kernel: it replaces the XLA ops of the JAX package's
// text_alignment_tpu/ops/device.py rotate_erode_project (a page-sized
// gather for the rotation, two run-length maps for the k = 2 erosion, a row
// sum), which the port first carried over as torch ops. Contract (the plain
// version, ops/device.rotate_erode_project_reference):
//   rot[y2][x2] = src[sy][sx] for the Q16 inverse map of ops/fixedpoint.py
//     (doubled centred offsets, arithmetic shift by 17), white where
//     (sy, sx) falls outside the H x W page or x2 >= W2;
//   ero = filter_short_runs(2) then filter_narrow_runs(2) of rot, black,
//     which at k = 2 is native/raster.cpp's ta_erode2: keep a black pixel
//     with a black vertical neighbour (v), then keep a pixel of v with a
//     horizontal neighbour in v, rows and columns past the page white;
//   proj[y2] = the black pixels of ero's row y2.
// Pages are (rows, ceil(width / 32)) int32 little-endian bit rows (bit b of
// word k is column 32 k + b), the layout of the CC kernels.
//
// What bounds it on this card is not bytes (0.4 MB in, 0.8 MB and the
// projection out: 0.4 us at 3.35 TB/s) nor operations (a few tens of
// integer operations a pixel) but the launches and the page-sized
// intermediates of the torch chain it replaces (int64 index maps of ~26 MB
// each). The design keeps the page packed from end to end in one launch:
//   a CTA a band of ta_raster_band_rows(Wq2) output rows rotates its rows
//   and one halo row above and below into shared memory as packed words,
//   a warp a word: lane b maps column 32 k + b through the inverse map,
//   reads its source bit from the packed input (L1 and L2 serve the
//   neighbouring lanes, which read the same or adjacent words), and
//   __ballot_sync packs the 32 bits into the word;
//   then each word of the band's rows is written out and eroded
//   vertically against the words above and below it (c & (up | down)),
//   and a warp a row erodes horizontally with the carries of the
//   neighbouring words (c & ((c << 1 | left >> 31) | (c >> 1 | right << 31)))
//   and counts the row with __popc and a warp sum.
// Nothing page-sized goes back to device memory between the steps, and
// every output is an exact integer function of the input: the plain
// version's bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define TA_RASTER_THREADS 256
#define TA_RASTER_WARPS (TA_RASTER_THREADS / 32)
#define TA_RASTER_BAND_MAX 16
#define TA_RASTER_SMEM 49152    // bytes of shared memory a CTA, no opt-in
#define TA_RASTER_Q 16          // ops/fixedpoint.py SCALE_BITS
#define TA_RASTER_FULL 0xFFFFFFFFu

// Output rows a CTA: at most TA_RASTER_BAND_MAX, and as many as keep the
// band's (band + 2) rotated rows and band eroded rows of Wq2 words within
// TA_RASTER_SMEM; 0 where not even one row fits.
extern "C" int ta_raster_band_rows(int Wq2) {
    if (Wq2 < 1) return 0;
    const int band = (TA_RASTER_SMEM / (4 * Wq2) - 2) / 2;
    return band < 1 ? 0 : band > TA_RASTER_BAND_MAX ? TA_RASTER_BAND_MAX
                                                    : band;
}

__global__ void __launch_bounds__(TA_RASTER_THREADS)
ta_raster_rotate_erode_kernel(const uint32_t* __restrict__ src, int H, int W,
                              int Wq, uint32_t* __restrict__ rot,
                              uint32_t* __restrict__ ero,
                              int* __restrict__ proj, int H2, int W2,
                              int Wq2, int band, int cfix, int sfix) {
    extern __shared__ uint32_t ta_raster_smem[];
    uint32_t* R = ta_raster_smem;             // rows r0 - 1 .. r0 + nrows
    uint32_t* V = R + (size_t)(band + 2) * Wq2;  // rows r0 .. r0 + nrows - 1
    const int r0 = blockIdx.x * band;
    const int nrows = min(band, H2 - r0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    // rotate, a warp a word: lane b is column 32 k + b
    const long long S = 1ll << TA_RASTER_Q;
    const long long bx = (long long)(W - 1) * S + S;
    const long long by = (long long)(H - 1) * S + S;
    const int nw = (nrows + 2) * Wq2;
    for (int w = warp; w < nw; w += TA_RASTER_WARPS) {
        const int i = w / Wq2, k = w - i * Wq2;
        const int y2 = r0 - 1 + i, x2 = 32 * k + lane;
        unsigned bit = 0u;
        if (y2 >= 0 && y2 < H2 && x2 < W2) {
            const long long dx2 = 2ll * x2 - (W2 - 1);
            const long long dy2 = 2ll * y2 - (H2 - 1);
            const long long sx =
                ((long long)cfix * dx2 + (long long)sfix * dy2 + bx) >>
                (TA_RASTER_Q + 1);
            const long long sy =
                (-(long long)sfix * dx2 + (long long)cfix * dy2 + by) >>
                (TA_RASTER_Q + 1);
            if (sy >= 0 && sy < H && sx >= 0 && sx < W)
                bit = (__ldg(src + sy * Wq + (sx >> 5)) >> (sx & 31)) & 1u;
        }
        const unsigned word = __ballot_sync(TA_RASTER_FULL, bit);
        if (lane == 0) R[w] = word;
    }
    __syncthreads();

    // the band's rotated words out, and the vertical pass
    const size_t base = (size_t)r0 * Wq2;
    for (int w = threadIdx.x; w < nrows * Wq2; w += TA_RASTER_THREADS) {
        const uint32_t c = R[w + Wq2];
        rot[base + w] = c;
        V[w] = c & (R[w] | R[w + 2 * Wq2]);
    }
    __syncthreads();

    // the horizontal pass and the row's count, a warp a row
    for (int i = warp; i < nrows; i += TA_RASTER_WARPS) {
        const uint32_t* v = V + (size_t)i * Wq2;
        uint32_t* out = ero + base + (size_t)i * Wq2;
        unsigned cnt = 0u;
        for (int k = lane; k < Wq2; k += 32) {
            const uint32_t c = v[k];
            const uint32_t left = k > 0 ? v[k - 1] : 0u;
            const uint32_t right = k + 1 < Wq2 ? v[k + 1] : 0u;
            const uint32_t e =
                c & ((c << 1 | left >> 31) | (c >> 1 | right << 31));
            out[k] = e;
            cnt += __popc(e);
        }
        for (int o = 16; o > 0; o >>= 1)
            cnt += __shfl_xor_sync(TA_RASTER_FULL, cnt, o);
        if (lane == 0) proj[r0 + i] = (int)cnt;
    }
}

// src (H, Wq) int32, the H x W page; rot, ero (H2, ceil(W2 / 32)) int32 and
// proj (H2,) int32 out. One launch on the stream, no host sync.
extern "C" int ta_raster_rotate_erode(const int* src, int* rot, int* ero,
                                      int* proj, int H, int Wq, int W,
                                      int H2, int W2, int cfix, int sfix,
                                      int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const int Wq2 = (W2 + 31) / 32;
    const int band = ta_raster_band_rows(Wq2);
    if (H < 1 || W < 1 || Wq < (W + 31) / 32 || H2 < 1 || W2 < 1 ||
        band < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(2 * band + 2) * Wq2 * sizeof(uint32_t);
    ta_raster_rotate_erode_kernel<<<(H2 + band - 1) / band,
                                    TA_RASTER_THREADS, smem,
                                    (cudaStream_t)stream>>>(
        (const uint32_t*)src, H, W, Wq, (uint32_t*)rot, (uint32_t*)ero, proj,
        H2, W2, Wq2, band, cfix, sfix);
    return (int)cudaGetLastError();
}
