// Affine-gap Needleman-Wunsch (Gotoh, three matrices) fill as an
// anti-diagonal wavefront, emitting packed traceback pointers.
//
// Replaces the Pallas TPU kernels text_alignment_tpu/align/nw_pallas.py
// _fill_pallas (single pair, _make_nw_kernel) and _fill_pallas_batched
// (_make_nw_kernel_batched, its per_pair and shared_feed modes). The
// recurrence is nw_jax._fill_scan's, in int32 with NEG = -2^30:
//   mat(i,j) = max3(m, x, y)(i-1, j-1) + s(i,j)          diagonal d-2
//   y(i,j)   = max3(m+goy+gey, x+goy+gey, y+gey)(i, j-1)  diagonal d-1
//   x(i,j)   = max3(m+gox+gex, x+gex, y+gox+gex)(i-1, j)  diagonal d-1
// with first-max tie-breaking (the reference's list.index(max(...))), the
// boundary overwrite order row 0: m = x = bge_r0 * j, y = NEG; col 0
// (i > 0): m = y = bge_c0 * i, x = NEG; and every lane outside
// 0 <= j < NoP set to NEG, as the XLA scan masks it. Output (B, D, L)
// uint8, D = L + NoP - 1: packed[b, d, i] = mp | xp << 2 | yp << 4 for the
// cell (i, j = d - i), the diagonal layout the traceback reads.
//
// Inputs (int32, contiguous): t (B, L) transcript ids, t[b, i] the id of
// transcript element i - 1 (lane 0 unused); o (1 or B, NoP) OCR ids,
// o[b, j] the id of OCR element j - 1; params (1 or B, 8)
// [match, mismatch, gox, goy, gex, gey, bge_r0, bge_c0].
//
// What bounds it: the D diagonals are a dependent chain and each diagonal
// costs a few dozen integer ops and shared-memory accesses per lane, so one
// pair is bound by latency and instruction throughput on one SM. Design:
// one block per pair, one __syncthreads() per diagonal.
// Thread t owns the RUN contiguous lanes [t*RUN, (t+1)*RUN): their m, x, y
// of diagonal d-1 and their OCR ids (the OCR stream is carried one lane
// per diagonal, as on the TPU) sit in registers; the lanes are updated from
// the last to the first, so lane r still reads lane r-1's old values. The
// run's first lane takes lane t*RUN-1 from the neighbouring thread by a
// warp shuffle, or, across warps, from a double-buffered edge slot in
// shared memory (written before the diagonal's barrier, read after it).
// Each lane's max3 over diagonal d-2 (the mat candidates of the lane to its
// right) and the transcript ids sit in shared memory, lane-major per run
// position so a warp's accesses fall on distinct banks. A pair of L lanes
// needs 9 L bytes of shared memory plus the edges (L = 16384: 144 KB).
// A long single pair therefore runs on one SM of the card's 132; a tiled
// multi-block wavefront is later work. A thread whose lanes all lie
// outside 0 <= j < NoP on a diagonal skips it, which halves the work of a
// square pair; the bytes of those cells are left unwritten (unspecified,
// as the TPU kernel leaves them). Pointer rows are contiguous in i, so a
// thread's RUN bytes go out as whole 32-bit words.

#include <cuda_runtime.h>
#include <stdint.h>

#define TA_NW_NEG (-(1 << 30))
#define TA_NW_MAX_THREADS 1024

struct TaNwEdge {
    int m, x, y, o, b, a;
};

__device__ __forceinline__ int ta_max3(int a, int b, int c, int* arg) {
    const int v01 = a >= b ? a : b;
    const int p01 = a >= b ? 0 : 1;
    *arg = v01 >= c ? p01 : 2;
    return v01 >= c ? v01 : c;
}

template <int RUN>
__global__ void __launch_bounds__(TA_NW_MAX_THREADS)
ta_nw_fill_kernel(const int* __restrict__ t_ids, const int* __restrict__ o_ids,
                  const int* __restrict__ params, uint8_t* __restrict__ out,
                  int L, int NoP, int o_rows, int p_rows) {
    extern __shared__ int smem[];
    const int T = blockDim.x;            // T * RUN == L
    const int nwarps = (T + 31) / 32;
    int* best = smem;                    // [RUN][T] max3 of diagonal d-2
    int* tid_s = best + L;               // [RUN][T] transcript ids
    TaNwEdge* edge = (TaNwEdge*)(tid_s + L);  // [2][nwarps]
    uint8_t* barg = (uint8_t*)(edge + 2 * nwarps);  // [RUN][T]

    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int i0 = t * RUN;
    const int D = L + NoP - 1;
    const int* pr = params + (size_t)(p_rows == 1 ? 0 : b) * 8;
    const int match = pr[0], mismatch = pr[1];
    const int gox_gex = pr[2] + pr[4], goy_gey = pr[3] + pr[5];
    const int gex = pr[4], gey = pr[5];
    const int bge_r0 = pr[6], bge_c0 = pr[7];
    const int* orow = o_ids + (size_t)(o_rows == 1 ? 0 : b) * NoP;
    const int* trow = t_ids + (size_t)b * L;
    uint8_t* obase = out + (size_t)b * D * L;

    int m[RUN], x[RUN], y[RUN], o[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
        m[r] = x[r] = y[r] = TA_NW_NEG;
        o[r] = 0;
        best[r * T + t] = TA_NW_NEG;
        barg[r * T + t] = 0;
        tid_s[r * T + t] = trow[i0 + r];
    }
    if (lane == 31 || t == T - 1) {
        const TaNwEdge init = {TA_NW_NEG, TA_NW_NEG, TA_NW_NEG, 0, TA_NW_NEG, 0};
        edge[warp] = init;
        edge[nwarps + warp] = init;
    }
    __syncthreads();

    // the last warp may be partial (T = L / RUN need not divide by 32)
    const int in_warp = T - warp * 32;
    const unsigned full = in_warp >= 32 ? 0xffffffffu : ((1u << in_warp) - 1u);
    for (int d = 0; d < D; ++d) {
        // lane i0 - 1 at diagonal d-1 (its max3 at d-2)
        const int lb_own = best[(RUN - 1) * T + t];
        const int la_own = barg[(RUN - 1) * T + t];
        int nm = __shfl_up_sync(full, m[RUN - 1], 1);
        int nx = __shfl_up_sync(full, x[RUN - 1], 1);
        int ny = __shfl_up_sync(full, y[RUN - 1], 1);
        int no = __shfl_up_sync(full, o[RUN - 1], 1);
        int nb = __shfl_up_sync(full, lb_own, 1);
        int na = __shfl_up_sync(full, la_own, 1);
        if (t == 0) {
            nm = nx = ny = nb = TA_NW_NEG;
            na = 0;
            no = d < NoP ? orow[d] : 0;
        } else if (lane == 0) {
            const TaNwEdge e = edge[((d + 1) & 1) * nwarps + warp - 1];
            nm = e.m; nx = e.x; ny = e.y; no = e.o; nb = e.b; na = e.a;
        }

        // a run wholly outside 0 <= j < NoP keeps its state: lanes with
        // j < 0 still hold their initial NEG and OCR id 0, and lanes
        // past NoP feed only cells past NoP (their bytes are unspecified)
        const bool live = d - i0 >= 0 && d - i0 - (RUN - 1) < NoP;
        if (live) {
            uint32_t pw[(RUN + 3) / 4];  // the run's pointer bytes
#pragma unroll
            for (int w = 0; w < (RUN + 3) / 4; ++w) pw[w] = 0;
#pragma unroll
            for (int r = RUN - 1; r >= 0; --r) {
                const int i = i0 + r;
                const int j = d - i;
                const int lm = r > 0 ? m[r > 0 ? r - 1 : 0] : nm;
                const int lx = r > 0 ? x[r > 0 ? r - 1 : 0] : nx;
                const int ly = r > 0 ? y[r > 0 ? r - 1 : 0] : ny;
                const int lo = r > 0 ? o[r > 0 ? r - 1 : 0] : no;
                const int lb = r > 0 ? best[(r - 1) * T + t] : nb;
                const int la = r > 0 ? (int)barg[(r - 1) * T + t] : na;

                const int s = tid_s[r * T + t] == lo ? match : mismatch;
                const int m_int = lb + s;
                int yp, xp, bp;
                const int y_int = ta_max3(m[r] + goy_gey, x[r] + goy_gey,
                                          y[r] + gey, &yp);
                const int x_int = ta_max3(lm + gox_gex, lx + gex, ly + gox_gex,
                                          &xp);
                // this lane's max3 at d-1 feeds lane i+1's mat at d+1
                best[r * T + t] = ta_max3(m[r], x[r], y[r], &bp);
                barg[r * T + t] = (uint8_t)bp;

                int mv, xv, yv;
                if (j < 0 || j >= NoP) {
                    mv = xv = yv = TA_NW_NEG;
                } else if (i == 0) {
                    mv = xv = bge_r0 * j;
                    yv = TA_NW_NEG;
                } else if (j == 0) {
                    mv = yv = bge_c0 * i;
                    xv = TA_NW_NEG;
                } else {
                    mv = m_int;
                    xv = x_int;
                    yv = y_int;
                }
                m[r] = mv;
                x[r] = xv;
                y[r] = yv;
                o[r] = lo;
                pw[r >> 2] |= (uint32_t)(la | (xp << 2) | (yp << 4))
                              << (8 * (r & 3));
            }

            uint8_t* row = obase + (size_t)d * L + i0;
            if (RUN % 4 == 0) {
#pragma unroll
                for (int w = 0; w < RUN / 4; ++w) ((uint32_t*)row)[w] = pw[w];
            } else {
#pragma unroll
                for (int r = 0; r < RUN; ++r)
                    row[r] = (uint8_t)(pw[r >> 2] >> (8 * (r & 3)));
            }
        }

        if (lane == 31 || t == T - 1) {
            const TaNwEdge e = {m[RUN - 1], x[RUN - 1], y[RUN - 1],
                                o[RUN - 1], best[(RUN - 1) * T + t],
                                (int)barg[(RUN - 1) * T + t]};
            edge[(d & 1) * nwarps + warp] = e;
        }
        __syncthreads();
    }
}

extern "C" size_t ta_nw_fill_smem(int L, int threads) {
    const int nwarps = (threads + 31) / 32;
    return (size_t)L * (2 * sizeof(int) + 1) +
           (size_t)2 * nwarps * sizeof(TaNwEdge);
}

template <int RUN>
static int ta_nw_launch(const int* t, const int* o, const int* params,
                        uint8_t* out, int B, int L, int NoP, int o_rows,
                        int p_rows, void* stream) {
    const int threads = L / RUN;
    const size_t smem = ta_nw_fill_smem(L, threads);
    cudaError_t e = cudaFuncSetAttribute(
        ta_nw_fill_kernel<RUN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    ta_nw_fill_kernel<RUN><<<B, threads, smem, (cudaStream_t)stream>>>(
        t, o, params, out, L, NoP, o_rows, p_rows);
    return (int)cudaGetLastError();
}

static int ta_nw_fill_any(const int* t, const int* o, const int* params,
                          uint8_t* out, int B, int L, int NoP, int run,
                          int o_rows, int p_rows, int device, void* stream) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0 || L <= 0 || NoP <= 0 || run <= 0 || L % run ||
        L / run > TA_NW_MAX_THREADS || (o_rows != 1 && o_rows != B) ||
        (p_rows != 1 && p_rows != B))
        return (int)cudaErrorInvalidValue;
    switch (run) {
        case 1: return ta_nw_launch<1>(t, o, params, out, B, L, NoP, o_rows, p_rows, stream);
        case 2: return ta_nw_launch<2>(t, o, params, out, B, L, NoP, o_rows, p_rows, stream);
        case 4: return ta_nw_launch<4>(t, o, params, out, B, L, NoP, o_rows, p_rows, stream);
        case 8: return ta_nw_launch<8>(t, o, params, out, B, L, NoP, o_rows, p_rows, stream);
        case 16: return ta_nw_launch<16>(t, o, params, out, B, L, NoP, o_rows, p_rows, stream);
        case 32: return ta_nw_launch<32>(t, o, params, out, B, L, NoP, o_rows, p_rows, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// One long pair (B = 1): nw_pallas._fill_pallas.
extern "C" int ta_nw_fill(const int* t, const int* o, const int* params,
                          uint8_t* out, int L, int NoP, int run, int device,
                          void* stream) {
    return ta_nw_fill_any(t, o, params, out, 1, L, NoP, run, 1, 1, device,
                          stream);
}

// B pairs of one (L, NoP) bucket: nw_pallas._fill_pallas_batched.
// per_pair: params holds one scoring row per pair (else one shared row);
// shared_feed: every pair reads OCR row 0 (else its own row).
extern "C" int ta_nw_fill_batched(const int* t, const int* o,
                                  const int* params, uint8_t* out, int B,
                                  int L, int NoP, int run, int per_pair,
                                  int shared_feed, int device, void* stream) {
    return ta_nw_fill_any(t, o, params, out, B, L, NoP, run,
                          shared_feed ? 1 : B, per_pair ? B : 1, device,
                          stream);
}
