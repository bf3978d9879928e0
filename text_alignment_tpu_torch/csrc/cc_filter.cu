// Connected components over a bit-packed page: the CC filter pass, the
// separator-masked CC stats table and the three-pass cleanup chain.
//
// Replaces the Pallas TPU kernel text_alignment_tpu/ops/cc_pallas.py
// _make_filter_kernel, behind its three entry points: _jit_filter /
// _run_filter (one filter pass, ta_cc_filter), _jit_table / cc_table_packed
// (the table, ta_cc_table) and _jit_clean / preproc_clean_packed (the
// chain, ta_cc_clean). Contract (the plain version in ops/cc.py):
//   runs = maximal horizontal runs of the working polarity (black, or white
//     in WHITE mode) inside the page (columns < W), in scan order; only the
//     first R are kept, and ok[0] = (n <= R), ok[1] = n;
//   runs of adjacent rows whose spans, widened by one, overlap are
//     connected (8-connectivity); a component's root is its smallest run;
//   filter: paint the runs of kept components on a zero page (BLACK keeps
//     area > t, WHITE area <= t and ORs the input in, TALL keeps nrows <= t
//     or area <= t with by_area);
//   table: (rmin, rmax, cmin, cmax, area) of the roots with area > t in
//     scan order, at most max_ccs rows, ok[0] &= count <= max_ccs,
//     ok[1] = min(count, max_ccs).
//
// The TPU kernel is a sequential scan-line union-find on the scalar unit.
// Carried over loop by loop it would be one GPU thread walking ~40k runs
// through dependent device-memory loads. This computes the same function
// in parallel, in seven short launches on one stream:
//   count   one warp per row builds the start masks word by word and counts
//           the row's runs with __popc;
//   scan    one block turns the counts into rowptr (exclusive prefix), so
//           run ids are in scan order, and writes ok;
//   decode  one warp per row writes each run's x0, x1 and row from
//           rowptr[y] on, nothing at or past R;
//   init    one thread per run: parent = self, stats cleared;
//   union   one thread per run finds the previous row's runs overlapping
//           [x0 - 1, x1 + 1] (binary search) and unites them lock-free: the
//           larger root is linked under the smaller with atomicCAS
//           (Playne and Hawick's union-find, IEEE TPDS 2018), so the final
//           root is the component's smallest run, the Pallas kernel's
//           union-by-min-index root;
//   stats   one thread per run flattens its parent to the root and adds its
//           area, row span (and column span) there with integer atomics,
//           exact in any order;
//   paint   one warp per row zeroes the row and ORs its kept runs in
//           (filter), or one block compacts the roots in order with a block
//           scan over run index (table): atomic slot allocation would
//           scramble the scan order.
// What bounds it on this card: the bytes of the packed page in and out
// (0.4 MB each way for a 2000 x 1600 page) and of the run tables (16 bytes
// a run read and written a few times: ~2.5 MB at 40k runs) take well under
// a microsecond each at 3.35 TB/s; in practice launch latency (seven
// launches a pass, 21 for the chain) and the atomics on the roots bound it.
// The design keeps every launch a single pass over rows or runs with no
// host synchronisation, so the passes queue back to back on the stream, and
// sizes the per-run grids from the capacity R (the run count lives on the
// card), so nothing waits for the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define TA_CC_THREADS 256          // per-row and per-run kernels
#define TA_CC_ROWS (TA_CC_THREADS / 32)
#define TA_CC_SCAN_THREADS 1024    // the single-block scans
#define TA_CC_FULL 0xFFFFFFFFu

enum { TA_CC_BLACK = 0, TA_CC_WHITE = 1, TA_CC_TALL = 2 };

struct TaCCScratch {
    int *rowptr, *x0, *x1, *ry, *parent, *area, *ymin, *ymax, *xmin, *xmax;
};

// scratch (int32): rowptr[H + 1] | x0, x1, ry, parent, area, ymin, ymax,
// xmin, xmax [R each]
extern "C" size_t ta_cc_scratch_ints(int H, int R) {
    return (size_t)H + 1 + 9 * (size_t)R;
}

static TaCCScratch ta_cc_carve(int* s, int H, int R) {
    TaCCScratch c;
    c.rowptr = s;
    int* p = s + H + 1;
    int** slots[9] = {&c.x0, &c.x1, &c.ry, &c.parent, &c.area, &c.ymin,
                      &c.ymax, &c.xmin, &c.xmax};
    for (int k = 0; k < 9; ++k) *slots[k] = p + (size_t)k * R;
    return c;
}

// word k of row y in the working polarity, columns >= W cleared
__device__ __forceinline__ uint32_t ta_cc_word(const int* page, int y, int k,
                                               int Wq, int W, int white) {
    if (k < 0 || k >= Wq) return 0u;
    const int rem = W - 32 * k;
    if (rem <= 0) return 0u;
    uint32_t w = (uint32_t)page[(size_t)y * Wq + k];
    if (white) w = ~w;
    return rem < 32 ? (w & ((1u << rem) - 1u)) : w;
}

// run start and end bits of word k (runs cross word boundaries)
__device__ __forceinline__ void ta_cc_events(const int* page, int y, int k,
                                             int Wq, int W, int white,
                                             uint32_t& s, uint32_t& e) {
    const uint32_t w = ta_cc_word(page, y, k, Wq, W, white);
    if (w == 0u) {
        s = e = 0u;
        return;
    }
    const uint32_t p = ta_cc_word(page, y, k - 1, Wq, W, white);
    const uint32_t n = ta_cc_word(page, y, k + 1, Wq, W, white);
    s = w & ~((w << 1) | (p >> 31));
    e = w & ~((w >> 1) | (n << 31));
}

__device__ __forceinline__ int ta_cc_warp_inclusive(int x, int lane) {
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(TA_CC_FULL, x, o);
        if (lane >= o) x += t;
    }
    return x;
}

// inclusive scan over a block of TA_CC_SCAN_THREADS; *total gets the sum
__device__ int ta_cc_block_inclusive(int v, int* warp_sums, int* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    int x = ta_cc_warp_inclusive(v, lane);
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
        const int nw = blockDim.x >> 5;
        int s = lane < nw ? warp_sums[lane] : 0;
        s = ta_cc_warp_inclusive(s, lane);
        warp_sums[lane] = s;
    }
    __syncthreads();
    x += wid > 0 ? warp_sums[wid - 1] : 0;
    *total = warp_sums[(blockDim.x >> 5) - 1];
    __syncthreads();
    return x;
}

__device__ __forceinline__ int ta_cc_find(const int* parent, int x) {
    const volatile int* p = parent;
    int q;
    while ((q = p[x]) != x) x = q;
    return x;
}

__device__ void ta_cc_unite(int* parent, int a, int b) {
    while (true) {
        a = ta_cc_find(parent, a);
        b = ta_cc_find(parent, b);
        if (a == b) return;
        if (a < b) {
            const int t = a;
            a = b;
            b = t;
        }
        // a is (was) a root: link it under the smaller root b
        const int old = atomicCAS(&parent[a], a, b);
        if (old == a) return;
    }
}

__global__ void __launch_bounds__(TA_CC_THREADS)
ta_cc_count_kernel(const int* __restrict__ page, int H, int Wq, int W,
                   int white, int* __restrict__ rowptr) {
    const int y = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (y >= H) return;  // whole warps only
    int c = 0;
    for (int k0 = 0; k0 < Wq; k0 += 32) {
        uint32_t s, e;
        ta_cc_events(page, y, k0 + lane, Wq, W, white, s, e);
        c += __popc(s);
    }
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(TA_CC_FULL, c, o);
    if (lane == 0) rowptr[y + 1] = c;
    if (y == 0 && lane == 0) rowptr[0] = 0;
}

__global__ void __launch_bounds__(TA_CC_SCAN_THREADS)
ta_cc_scan_kernel(int* __restrict__ rowptr, int H, int R,
                  int* __restrict__ ok) {
    __shared__ int warp_sums[32];
    int carry = 0;
    for (int base = 0; base < H; base += blockDim.x) {
        const int i = base + threadIdx.x;
        const int v = i < H ? rowptr[i + 1] : 0;
        int total;
        const int x = ta_cc_block_inclusive(v, warp_sums, &total);
        if (i < H) rowptr[i + 1] = carry + x;
        carry += total;
    }
    if (threadIdx.x == 0) {
        ok[0] = carry <= R;
        ok[1] = carry;
    }
}

__global__ void __launch_bounds__(TA_CC_THREADS)
ta_cc_decode_kernel(const int* __restrict__ page, int H, int Wq, int W,
                    int white, int R, TaCCScratch c) {
    const int y = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (y >= H) return;
    const int base = c.rowptr[y];
    int bs = base, be = base;
    for (int k0 = 0; k0 < Wq; k0 += 32) {
        const int k = k0 + lane;
        uint32_t s, e;
        ta_cc_events(page, y, k, Wq, W, white, s, e);
        const int is = ta_cc_warp_inclusive(__popc(s), lane);
        const int ie = ta_cc_warp_inclusive(__popc(e), lane);
        int rs = bs + is - __popc(s), re = be + ie - __popc(e);
        while (s) {
            const int b = __ffs(s) - 1;
            s &= s - 1u;
            if (rs < R) {
                c.x0[rs] = 32 * k + b;
                c.ry[rs] = y;
            }
            ++rs;
        }
        while (e) {
            const int b = __ffs(e) - 1;
            e &= e - 1u;
            if (re < R) c.x1[re] = 32 * k + b;
            ++re;
        }
        bs += __shfl_sync(TA_CC_FULL, is, 31);
        be += __shfl_sync(TA_CC_FULL, ie, 31);
    }
}

__global__ void __launch_bounds__(TA_CC_THREADS)
ta_cc_init_kernel(int H, int R, TaCCScratch c) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= min(c.rowptr[H], R)) return;
    c.parent[i] = i;
    c.area[i] = 0;
    c.ymin[i] = INT_MAX;
    c.ymax[i] = INT_MIN;
    c.xmin[i] = INT_MAX;
    c.xmax[i] = INT_MIN;
}

__global__ void __launch_bounds__(TA_CC_THREADS)
ta_cc_union_kernel(int H, int R, TaCCScratch c) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= min(c.rowptr[H], R)) return;
    const int y = c.ry[i];
    if (y == 0) return;
    const int p1 = c.rowptr[y];  // <= i: the previous row is all kept
    const int lo_x = c.x0[i] - 1, hi_x = c.x1[i] + 1;
    int lo = c.rowptr[y - 1], hi = p1;
    while (lo < hi) {  // first previous-row run ending at or after x0 - 1
        const int mid = (lo + hi) >> 1;
        if (c.x1[mid] < lo_x) lo = mid + 1;
        else hi = mid;
    }
    for (int j = lo; j < p1 && c.x0[j] <= hi_x; ++j) ta_cc_unite(c.parent, i, j);
}

__global__ void __launch_bounds__(TA_CC_THREADS)
ta_cc_stats_kernel(int H, int R, int want_x, TaCCScratch c) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= min(c.rowptr[H], R)) return;
    const int r = ta_cc_find(c.parent, i);
    const int y = c.ry[i], x0 = c.x0[i], x1 = c.x1[i];
    atomicAdd(&c.area[r], x1 - x0 + 1);
    atomicMin(&c.ymin[r], y);
    atomicMax(&c.ymax[r], y);
    if (want_x) {
        atomicMin(&c.xmin[r], x0);
        atomicMax(&c.xmax[r], x1);
    }
    c.parent[i] = r;  // flatten: every run now points at its root
}

__global__ void __launch_bounds__(TA_CC_THREADS)
ta_cc_paint_kernel(const int* __restrict__ page, int H, int Wq, int R,
                   int thresh, int mode, int by_area, TaCCScratch c,
                   int* __restrict__ out) {
    const int y = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (y >= H) return;
    int* orow = out + (size_t)y * Wq;
    for (int k = lane; k < Wq; k += 32) orow[k] = 0;
    __syncwarp();
    const int nR = min(c.rowptr[H], R);
    const int r1 = min(c.rowptr[y + 1], nR);
    for (int r = min(c.rowptr[y], nR) + lane; r < r1; r += 32) {
        const int root = c.parent[r];
        const int a = c.area[root];
        const int meas = by_area ? a : c.ymax[root] - c.ymin[root] + 1;
        const bool keep = mode == TA_CC_BLACK ? a > thresh
                          : mode == TA_CC_WHITE ? a <= thresh
                                                : meas <= thresh;
        if (!keep) continue;
        const int x0 = c.x0[r], x1 = c.x1[r];
        const int k0 = x0 >> 5, k1 = x1 >> 5;
        for (int k = k0; k <= k1; ++k) {
            uint32_t m = TA_CC_FULL;
            if (k == k0) m &= TA_CC_FULL << (x0 & 31);
            if (k == k1) m &= TA_CC_FULL >> (31 - (x1 & 31));
            atomicOr((unsigned int*)&orow[k], m);
        }
    }
    __syncwarp();
    if (mode == TA_CC_WHITE)
        for (int k = lane; k < Wq; k += 32) orow[k] |= page[(size_t)y * Wq + k];
}

__global__ void __launch_bounds__(TA_CC_SCAN_THREADS)
ta_cc_table_kernel(int H, int R, int thresh, int max_ccs, TaCCScratch c,
                   int* __restrict__ table, int* __restrict__ ok) {
    __shared__ int warp_sums[32];
    const int nR = min(c.rowptr[H], R);
    int carry = 0;
    for (int base = 0; base < nR; base += blockDim.x) {
        const int i = base + threadIdx.x;
        const int flag = i < nR && c.parent[i] == i && c.area[i] > thresh;
        int total;
        const int slot = carry + ta_cc_block_inclusive(flag, warp_sums,
                                                       &total) - flag;
        if (flag && slot < max_ccs) {
            int* row = table + (size_t)slot * 5;
            row[0] = c.ymin[i];
            row[1] = c.ymax[i];
            row[2] = c.xmin[i];
            row[3] = c.xmax[i];
            row[4] = c.area[i];
        }
        carry += total;
    }
    for (int s = min(carry, max_ccs) + threadIdx.x; s < max_ccs;
         s += blockDim.x)
        for (int q = 0; q < 5; ++q) table[(size_t)s * 5 + q] = 0;
    if (threadIdx.x == 0) {
        if (carry > max_ccs) ok[0] = 0;
        ok[1] = min(carry, max_ccs);
    }
}

__global__ void ta_cc_and_kernel(const int* __restrict__ oks,
                                 int* __restrict__ ok) {
    ok[0] = oks[0] & oks[2] & oks[4];
}

// count, scan, decode, init, union, stats: the components of page's runs
static cudaError_t ta_cc_components(const int* page, int H, int Wq, int W,
                                    int white, int R, int want_x,
                                    const TaCCScratch& c, int* ok,
                                    cudaStream_t st) {
    const int row_blocks = (H + TA_CC_ROWS - 1) / TA_CC_ROWS;
    const int run_blocks = (R + TA_CC_THREADS - 1) / TA_CC_THREADS;
    ta_cc_count_kernel<<<row_blocks, TA_CC_THREADS, 0, st>>>(page, H, Wq, W,
                                                             white, c.rowptr);
    ta_cc_scan_kernel<<<1, TA_CC_SCAN_THREADS, 0, st>>>(c.rowptr, H, R, ok);
    ta_cc_decode_kernel<<<row_blocks, TA_CC_THREADS, 0, st>>>(page, H, Wq, W,
                                                              white, R, c);
    ta_cc_init_kernel<<<run_blocks, TA_CC_THREADS, 0, st>>>(H, R, c);
    ta_cc_union_kernel<<<run_blocks, TA_CC_THREADS, 0, st>>>(H, R, c);
    ta_cc_stats_kernel<<<run_blocks, TA_CC_THREADS, 0, st>>>(H, R, want_x, c);
    return cudaGetLastError();
}

static cudaError_t ta_cc_filter_pass(const int* page, int* out, int H, int Wq,
                                     int W, int thresh, int mode, int by_area,
                                     int R, const TaCCScratch& c, int* ok,
                                     cudaStream_t st) {
    cudaError_t e = ta_cc_components(page, H, Wq, W, mode == TA_CC_WHITE, R,
                                     0, c, ok, st);
    if (e != cudaSuccess) return e;
    const int row_blocks = (H + TA_CC_ROWS - 1) / TA_CC_ROWS;
    ta_cc_paint_kernel<<<row_blocks, TA_CC_THREADS, 0, st>>>(
        page, H, Wq, R, thresh, mode, by_area, c, out);
    return cudaGetLastError();
}

static int ta_cc_bad(int H, int Wq, int W, int R) {
    return H <= 0 || Wq <= 0 || W <= 0 || W > 32 * Wq || W >= (1 << 15) ||
           R <= 0;
}

// One filter pass: page, out (H, Wq) int32; ok (2,) int32; scratch of
// ta_cc_scratch_ints(H, R) int32.
extern "C" int ta_cc_filter(const int* page, int* out, int* ok, int* scratch,
                            int H, int Wq, int W, int thresh, int mode,
                            int by_area, int R, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (ta_cc_bad(H, Wq, W, R) || mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    return (int)ta_cc_filter_pass(page, out, H, Wq, W, thresh, mode, by_area,
                                  R, ta_cc_carve(scratch, H, R), ok,
                                  (cudaStream_t)stream);
}

// The stats table: table (max_ccs, 5) int32, ok (2,) int32.
extern "C" int ta_cc_table(const int* page, int* table, int* ok, int* scratch,
                           int H, int Wq, int W, int thresh, int max_ccs,
                           int R, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (ta_cc_bad(H, Wq, W, R) || max_ccs <= 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const TaCCScratch c = ta_cc_carve(scratch, H, R);
    e = ta_cc_components(page, H, Wq, W, 0, R, 1, c, ok, st);
    if (e != cudaSuccess) return (int)e;
    ta_cc_table_kernel<<<1, TA_CC_SCAN_THREADS, 0, st>>>(H, R, thresh, max_ccs,
                                                         c, table, ok);
    return (int)cudaGetLastError();
}

// The cleanup chain: despeckle (page -> tmp1), despeckle_white ORed with
// its input (tmp1 -> tmp2), remove_tall (tmp2 -> out); oks (6,) int32 the
// passes' ok, ok (1,) int32 their AND. All on the stream, no host sync.
extern "C" int ta_cc_clean(const int* page, int* out, int* tmp1, int* tmp2,
                           int* oks, int* ok, int* scratch, int H, int Wq,
                           int W, int despeckle_amt, int sat_area_thresh,
                           int by_area, int R, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (ta_cc_bad(H, Wq, W, R)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const TaCCScratch c = ta_cc_carve(scratch, H, R);
    e = ta_cc_filter_pass(page, tmp1, H, Wq, W, despeckle_amt, TA_CC_BLACK, 0,
                          R, c, oks, st);
    if (e == cudaSuccess)
        e = ta_cc_filter_pass(tmp1, tmp2, H, Wq, W, despeckle_amt,
                              TA_CC_WHITE, 0, R, c, oks + 2, st);
    if (e == cudaSuccess)
        e = ta_cc_filter_pass(tmp2, out, H, Wq, W, sat_area_thresh,
                              TA_CC_TALL, by_area, R, c, oks + 4, st);
    if (e != cudaSuccess) return (int)e;
    ta_cc_and_kernel<<<1, 1, 0, st>>>(oks, ok);
    return (int)cudaGetLastError();
}
