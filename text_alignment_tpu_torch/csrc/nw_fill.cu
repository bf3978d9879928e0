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
// What bounds it: the D diagonals are a dependent chain, and each diagonal
// costs a few dozen integer ops and shared-memory accesses per lane, so a
// pair is bound by latency and instruction issue, not by bytes. One block
// holding a whole pair put all L lanes of a diagonal on one SM and left the
// card's other SMs idle. Design: the L lanes of a pair are cut into
// P = ceil(L / S) segments of S lanes, one CTA per (pair, segment), so one
// long pair runs on P SMs and a diagonal costs S lanes' work on each.
//
// Inside a CTA (S lanes, T = S / RUN threads, one __syncthreads() per
// diagonal): thread t owns the RUN contiguous lanes [kS + t*RUN, ...): their
// m, x, y of diagonal d-1 and their OCR ids (the OCR stream is carried one
// lane per diagonal, as on the TPU) sit in registers; the lanes are updated
// from the last to the first, so lane r still reads lane r-1's old values.
// The run's first lane takes lane t*RUN-1 from the neighbouring thread by a
// warp shuffle, or, across warps, from a double-buffered edge slot in
// shared memory (written before the diagonal's barrier, read after it).
// Each lane's max3 over diagonal d-2 (the mat candidates of the lane to its
// right) and the transcript ids sit in shared memory, lane-major per run
// position so a warp's accesses fall on distinct banks: 9 S bytes plus the
// edges. A thread whose lanes all lie outside 0 <= j < NoP on a diagonal
// skips it, which halves the work of a square pair; the bytes of those
// cells are left unwritten (unspecified, as the TPU kernel leaves them).
// Pointer rows are contiguous in i, so a thread's RUN bytes go out as whole
// 32-bit words.
//
// Across CTAs: segment k's first lane needs lane kS-1's record (m, x, y, o
// at d-1; max3 and its argmax at d-2), the record a warp edge slot carries
// inside a CTA. Segment k-1's last thread writes that record for every
// diagonal into global scratch (one TaNwEdge a diagonal, no ring) and
// publishes how many diagonals are written every TA_NW_CHUNK diagonals with
// a release store. Segment k's first CH threads fetch the next chunk of
// records into registers on the second-to-last diagonal of the current
// chunk (spinning on an acquire load until the chunk is published) and
// store it into a double-buffered stage in shared memory on the last, so
// the hand-off adds no barrier and its load latency overlaps a diagonal;
// each boundary lags one to two chunks. Segment 0 stages its OCR ids the
// same way, so thread 0 always reads its left neighbour from shared memory.
// Records past the end of segment k-1's diagonals feed only cells with
// j >= NoP and are read as the neutral NEG record. A CTA takes its (pair,
// segment) from an atomic ticket in launch order, segment-major, so it
// waits only on a CTA that already runs: no deadlock for any number of
// CTAs against the SM count, and no cooperative launch. Segment k starts
// at diagonal kS (before it, every lane of it has j < 0 and holds its
// initial state) and stops after its last live diagonal. The last segment
// may be ragged (L need not divide by S): its lanes past L are computed and
// never written. With one CTA a pair of S = L lanes (the SPLIT = false
// instantiations), as the batched grids run, the hand-off code and the
// ragged-lane guards are compiled out, leaving the loop of the one-block
// kernel this design replaced; kept in, they made that loop up to ~40%
// slower a diagonal.

#include <cuda_runtime.h>
#include <stdint.h>

#define TA_NW_NEG (-(1 << 30))
#define TA_NW_MAX_THREADS 1024
#define TA_NW_CHUNK 32  // diagonals per published and staged chunk
#define TA_NW_SMEM_LIMIT 232448

// 8-byte aligned, so a warp edge moves as three 64-bit shared accesses.
struct alignas(8) TaNwEdge {
    int m, x, y, o, b, a;
};

__device__ __forceinline__ int ta_max3(int a, int b, int c, int* arg) {
    const int v01 = a >= b ? a : b;
    const int p01 = a >= b ? 0 : 1;
    *arg = v01 >= c ? p01 : 2;
    return v01 >= c ? v01 : c;
}

__device__ __forceinline__ int ta_ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void ta_st_release(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// Scratch: ints [0] the ticket, [1 + b * P + k] the diagonals segment k of
// pair b has published (zeroed before each launch); then, 16-byte aligned,
// the records edge[b][k][d] of the B * (P - 1) segment boundaries.
__host__ __device__ inline size_t ta_nw_counter_ints(int B, int P) {
    return ((size_t)1 + (size_t)B * P + 3) / 4 * 4;
}

// SPLIT: the pairs run in P > 1 segments, or in one ragged segment (S > L):
// the hand-off code and the guards of lanes past L. Without it each CTA is
// one whole pair of S = L lanes, blockIdx.x, and reads its OCR ids
// directly.
template <int RUN, bool SPLIT>
__global__ void __launch_bounds__(TA_NW_MAX_THREADS)
ta_nw_fill_kernel(const int* __restrict__ t_ids, const int* __restrict__ o_ids,
                  const int* __restrict__ params, uint8_t* __restrict__ out,
                  int B, int L, int NoP, int S, int P, int o_rows, int p_rows,
                  int* counters, TaNwEdge* recs) {
    extern __shared__ __align__(8) int smem[];
    const int T = blockDim.x;            // T * RUN == S
    const int nwarps = (T + 31) / 32;
    int* best = smem;                    // [RUN][T] max3 of diagonal d-2
    int* tid_s = best + S;               // [RUN][T] transcript ids
    TaNwEdge* edge = (TaNwEdge*)(tid_s + S);  // [2][nwarps]
    TaNwEdge* stage = edge + 2 * nwarps;      // [2][CH]
    uint8_t* barg = (uint8_t*)(stage + 2 * TA_NW_CHUNK);  // [RUN][T]
    int* ticket = (int*)(barg + (S + 3) / 4 * 4);  // the CTA's (pair, segment)

    const int t = threadIdx.x;
    if (SPLIT) {
        if (t == 0) *ticket = atomicAdd(counters, 1);
        __syncthreads();
    }
    const int k = SPLIT ? *ticket / B : 0;         // segment
    const int b = SPLIT ? *ticket % B : blockIdx.x;  // pair
    const int lane = t & 31;
    const int warp = t >> 5;
    const int i0 = k * S + t * RUN;
    const int D = L + NoP - 1;
    const int d0 = k * S;
    const int d_end = min(D, d0 + S - 1 + NoP);
    const int rec_end = min(D, d0 - 1 + NoP);  // segment k-1's d_end
    const int* pr = params + (size_t)(p_rows == 1 ? 0 : b) * 8;
    const int match = pr[0], mismatch = pr[1];
    const int gox_gex = pr[2] + pr[4], goy_gey = pr[3] + pr[5];
    const int gex = pr[4], gey = pr[5];
    const int bge_r0 = pr[6], bge_c0 = pr[7];
    const int* orow = o_ids + (size_t)(o_rows == 1 ? 0 : b) * NoP;
    const int* trow = t_ids + (size_t)b * L;
    uint8_t* obase = out + (size_t)b * D * L;
    TaNwEdge* boundary = recs + (size_t)b * (P - 1) * D;
    const TaNwEdge* in_rec = boundary + (size_t)(k - 1) * D;  // k > 0
    TaNwEdge* out_rec = boundary + (size_t)k * D;             // k < P - 1
    const int* in_prog = counters + 1 + b * P + k - 1;
    int* out_prog = counters + 1 + b * P + k;

    // Entry t of a chunk: the first lane's left neighbour at diagonal
    // d = d0 + chunk * CH + t, that is segment k-1's record of d - 1 (the
    // neutral record past its last), or for segment 0 the OCR id of d.
    // Thread t < CH fetches it one diagonal before it stores it.
    const int CH = min(TA_NW_CHUNK, T);
    auto fetch = [&](int chunk) {
        const int d = d0 + chunk * CH + t;
        TaNwEdge e = {TA_NW_NEG, TA_NW_NEG, TA_NW_NEG, 0, TA_NW_NEG, 0};
        if (k == 0) {
            e.o = d < NoP ? __ldg(orow + d) : 0;
        } else if (d - 1 < rec_end) {
            const int need = min(d0 - 1 + (chunk + 1) * CH, rec_end);
            while (ta_ld_acquire(in_prog) < need) {
            }
            const int* src = (const int*)(in_rec + d - 1);
            e.m = __ldcg(src);
            e.x = __ldcg(src + 1);
            e.y = __ldcg(src + 2);
            e.o = __ldcg(src + 3);
            e.b = __ldcg(src + 4);
            e.a = __ldcg(src + 5);
        }
        return e;
    };

    int m[RUN], x[RUN], y[RUN], o[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
        m[r] = x[r] = y[r] = TA_NW_NEG;
        o[r] = 0;
        best[r * T + t] = TA_NW_NEG;
        barg[r * T + t] = 0;
        tid_s[r * T + t] = !SPLIT || i0 + r < L ? trow[i0 + r] : 0;
    }
    if (lane == 31 || t == T - 1) {
        const TaNwEdge init = {TA_NW_NEG, TA_NW_NEG, TA_NW_NEG, 0, TA_NW_NEG, 0};
        edge[warp] = init;
        edge[nwarps + warp] = init;
    }
    TaNwEdge pend;
    if (SPLIT && t < CH) stage[t] = fetch(0);
    __syncthreads();

    // the last warp may be partial (T = S / RUN need not divide by 32)
    const int in_warp = T - warp * 32;
    const unsigned full = in_warp >= 32 ? 0xffffffffu : ((1u << in_warp) - 1u);
    const bool words =
        RUN % 4 == 0 && (!SPLIT || ((L & 3) == 0 && i0 + RUN <= L));
    const int fetch_pos = CH >= 2 ? CH - 2 : 0;
    int q = 0, pos = 0;  // the chunk of diagonal d and its place in it
    for (int d = d0; d < d_end; ++d) {
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
            if (SPLIT) {
                const TaNwEdge e = stage[(q & 1) * CH + pos];
                nm = e.m; nx = e.x; ny = e.y; no = e.o; nb = e.b; na = e.a;
            } else {
                nm = nx = ny = nb = TA_NW_NEG;
                na = 0;
                no = d < NoP ? orow[d] : 0;
            }
        } else if (lane == 0) {
            const TaNwEdge e = edge[((d + 1) & 1) * nwarps + warp - 1];
            nm = e.m; nx = e.x; ny = e.y; no = e.o; nb = e.b; na = e.a;
        }

        // a run wholly outside 0 <= j < NoP keeps its state: lanes with
        // j < 0 still hold their initial NEG and OCR id 0, and lanes
        // past NoP feed only cells past NoP (their bytes are unspecified)
        const bool live = (!SPLIT || i0 < L) && d - i0 >= 0 &&
                          d - i0 - (RUN - 1) < NoP;
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
            if (words) {
#pragma unroll
                for (int w = 0; w < (RUN + 3) / 4; ++w) ((uint32_t*)row)[w] = pw[w];
            } else {
#pragma unroll
                for (int r = 0; r < RUN; ++r)
                    if (!SPLIT || i0 + r < L)
                        row[r] = (uint8_t)(pw[r >> 2] >> (8 * (r & 3)));
            }
        }

        if (lane == 31 || t == T - 1) {
            const TaNwEdge e = {m[RUN - 1], x[RUN - 1], y[RUN - 1],
                                o[RUN - 1], best[(RUN - 1) * T + t],
                                (int)barg[(RUN - 1) * T + t]};
            edge[(d & 1) * nwarps + warp] = e;
            if (SPLIT && t == T - 1 && k < P - 1) {
                out_rec[d] = e;
                if (pos == CH - 1 || d == d_end - 1)
                    ta_st_release(out_prog, d + 1);
            }
        }
        if (SPLIT) {
            // the next chunk into the other buffer, read from the next
            // diagonal
            if (t < CH && pos == fetch_pos) pend = fetch(q + 1);
            if (t < CH && pos == CH - 1) stage[((q + 1) & 1) * CH + t] = pend;
            if (++pos == CH) {
                pos = 0;
                ++q;
            }
        }
        __syncthreads();
    }
}

// Dynamic shared bytes of a CTA of S lanes in T threads (best and the
// transcript ids, the warp edges, the staged left neighbours of the first
// lane, the argmax bytes and the ticket).
extern "C" size_t ta_nw_fill_smem(int S, int threads) {
    const int nwarps = (threads + 31) / 32;
    return (size_t)S * 2 * sizeof(int) +
           (size_t)2 * nwarps * sizeof(TaNwEdge) +
           (size_t)2 * TA_NW_CHUNK * sizeof(TaNwEdge) +
           (size_t)(S + 3) / 4 * 4 + sizeof(int);
}

// Bytes of the scratch one launch of B pairs in segments of S lanes needs.
extern "C" size_t ta_nw_fill_scratch_bytes(int B, int L, int NoP, int S) {
    const int P = (L + S - 1) / S;
    return ta_nw_counter_ints(B, P) * sizeof(int) +
           (size_t)B * (P - 1) * (L + NoP - 1) * sizeof(TaNwEdge);
}

template <int RUN>
static int ta_nw_launch(const int* t, const int* o, const int* params,
                        uint8_t* out, int B, int L, int NoP, int S,
                        int o_rows, int p_rows, void* scratch, void* stream) {
    const int threads = S / RUN;
    const int P = (L + S - 1) / S;
    const size_t smem = ta_nw_fill_smem(S, threads);
    if (smem > TA_NW_SMEM_LIMIT || (long long)B * P > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const bool split = P > 1 || S != L;
    auto kernel =
        split ? ta_nw_fill_kernel<RUN, true> : ta_nw_fill_kernel<RUN, false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    int* counters = (int*)scratch;
    if (split) {  // the ticket and the progress counters
        e = cudaMemsetAsync(counters, 0,
                            ta_nw_counter_ints(B, P) * sizeof(int),
                            (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    TaNwEdge* recs = (TaNwEdge*)(counters + ta_nw_counter_ints(B, P));
    kernel<<<B * P, threads, smem, (cudaStream_t)stream>>>(
        t, o, params, out, B, L, NoP, S, P, o_rows, p_rows, counters, recs);
    return (int)cudaGetLastError();
}

static int ta_nw_fill_any(const int* t, const int* o, const int* params,
                          uint8_t* out, int B, int L, int NoP, int run,
                          int o_rows, int p_rows, int device, void* stream,
                          int S, void* scratch) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (B <= 0 || L <= 0 || NoP <= 0 || run <= 0 || S <= 0 || S % run ||
        S / run > TA_NW_MAX_THREADS || scratch == nullptr ||
        (o_rows != 1 && o_rows != B) || (p_rows != 1 && p_rows != B))
        return (int)cudaErrorInvalidValue;
    switch (run) {
        case 1: return ta_nw_launch<1>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 2: return ta_nw_launch<2>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 4: return ta_nw_launch<4>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 8: return ta_nw_launch<8>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 16: return ta_nw_launch<16>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        case 32: return ta_nw_launch<32>(t, o, params, out, B, L, NoP, S, o_rows, p_rows, scratch, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// One long pair (B = 1): nw_pallas._fill_pallas. seg: the lanes of a
// segment (S); scratch: ta_nw_fill_scratch_bytes(1, L, NoP, S) bytes.
extern "C" int ta_nw_fill(const int* t, const int* o, const int* params,
                          uint8_t* out, int L, int NoP, int run, int device,
                          void* stream, int seg, void* scratch) {
    return ta_nw_fill_any(t, o, params, out, 1, L, NoP, run, 1, 1, device,
                          stream, seg, scratch);
}

// B pairs of one (L, NoP) bucket: nw_pallas._fill_pallas_batched.
// per_pair: params holds one scoring row per pair (else one shared row);
// shared_feed: every pair reads OCR row 0 (else its own row).
extern "C" int ta_nw_fill_batched(const int* t, const int* o,
                                  const int* params, uint8_t* out, int B,
                                  int L, int NoP, int run, int per_pair,
                                  int shared_feed, int device, void* stream,
                                  int seg, void* scratch) {
    return ta_nw_fill_any(t, o, params, out, B, L, NoP, run,
                          shared_feed ? 1 : B, per_pair ? B : 1, device,
                          stream, seg, scratch);
}
