// BiLSTM recurrence, both directions, for the line recognizer (inference).
//
// Replaces the Pallas TPU kernel text_alignment_tpu/models/lstm_pallas.py
// bidir_scan_pallas (body _make_kernel): per step
//   gates = gx[t] + h_{t-1} . Wh          (fused [gi | gf | go | ci] chunks)
//   gi = sig(gates_i + WIP * c_{t-1}),  gf = sig(gates_f + WFP * c_{t-1})
//   c  = tanh(gates_ci) * gi + gf * c_{t-1}
//   go = sig(gates_o + WOP * c)   (the WOP term is skipped at t = 0: ocropy)
//   h  = tanh(c) * go
// The input projection gx (all frames at once) stays a torch.matmul outside,
// as the JAX package leaves it to XLA outside its kernel.
//
// What bounds it: the T steps are a dependent chain, each a tiny
// (rows x ns) . (ns x 4ns) product plus a dozen elementwise ops, so the
// kernel is latency- and issue-bound, not FLOP- or byte-bound: its floor
// is T times (one dependent ns-term sum + one barrier), and one SM issues
// a step's 4ns columns x ns unfused multiply-adds, broadcast loads of h
// and cell updates. The design keeps everything a step needs on chip and
// puts one barrier on the chain:
//
// - One CTA per (direction, tile of BT batch rows). BT is a template
//   parameter, so the row loops are unrolled without guards.
// - Thread (unit j, gate q) owns gate column q*ns + j and keeps that column
//   of Wh on chip for the whole scan (NSP = 4 * NQ floats, ns padded with
//   zero weights to a multiple of 4; the padding adds exact zeros at the
//   end of the sum): its first NQR quads in registers, as many as the
//   register budget below allows, the rest in a float4 slot of its own in
//   shared memory (conflict-free, [quad][thread]). The four gate columns of
//   a unit sit in four adjacent lanes of one warp: the cell update gathers
//   them with __shfl_sync, and c stays in the lanes' registers.
// - h_{t-1} is read from shared memory as float4 broadcasts (every thread
//   reads the same address). h is double-buffered by step parity, so one
//   barrier per step separates the writes of step t from the reads of
//   step t + 1.
// - gx for step t + 1 is loaded into registers at the top of step t, so its
//   load latency overlaps the product and the cell update.
//
// Every sum and product is rounded on its own (__fadd_rn / __fmul_rn: no
// FMA contraction) and h . Wh is summed by one thread over s in ascending
// order, the order of the plain version (models/lstm_kernel.py): the
// recurrence carries roundoff through every step of a line, so only the
// same order keeps the two within 1e-4 over thousands of steps.
//
// Layouts (all float32, contiguous):
//   gx   (2, T, B, 4ns)   input projection + bias, direction 1 length-reversed
//   whT  (2, ns, 4ns)     recurrent weights, gates[g] = sum_s h[s] whT[s, g]
//   peep (2, 3, ns)       [WIP, WFP, WOP] per direction
//   out  (2, T, B, ns)    h per step
// The instantiations (NQ, BT) are listed at the dispatch below and in
// models/lstm_kernel.py (TILES), which picks BT; ta_lstm_scan_attrs reports
// what an instantiation takes (registers, Wh quads in registers, shared
// bytes).
//
// Built with -DTA_LSTM_NO_PRODUCT the step skips h . Wh (wrong values):
// chip_lstm_ablation.py times that against the kernel.
//
// The wide route (ns > 128, ta_lstm_scan_wide_kernel): a thread's column no
// longer fits registers and its shared slot, so it has a third tier. Its
// first quads sit in registers, the next in its shared-memory slot, and the
// rest are read each step from global memory (__ldg; Wh stays L2-resident).
// A CTA has at most 1024 threads, four lanes a unit, so past ns = 256 a
// thread walks its column in each of ceil(ns / 256) unit groups within a
// step; every group reads h_{t-1} and the step still ends in one barrier.
// c lives in shared memory (a thread holds no per-group registers), and the
// sum over s stays one thread's ascending unfused sum, as above.

#include <cuda_runtime.h>

constexpr int TA_SMEM_LIMIT = 232448;  // shared bytes one H100 block can use

// The launch bound of an instantiation: 4 lanes for each of 4 * NQ units.
__host__ __device__ constexpr int ta_lstm_bound(int nq) {
    return (16 * nq + 31) / 32 * 32;
}

// The register budget. A CTA's warps are dealt to the SM's four
// sub-partitions of 16,384 registers each, so a thread of a CTA of W warps
// may have 16384 / (32 ceil(W / 4)) registers (at most 255). Besides its Wh
// column a thread is budgeted 12 per batch row and 36 for the rest; the
// quads of its column that do not fit go to a slot of its own in dynamic
// shared memory.
__host__ __device__ constexpr int ta_lstm_nqr(int nq, int bt) {
    const int per_partition = ((ta_lstm_bound(nq) + 31) / 32 + 3) / 4;
    const int cap = 16384 / (32 * per_partition) / 8 * 8;
    const int q = ((cap > 255 ? 255 : cap) - 12 * bt - 36) / 4;
    return q < 0 ? 0 : (q > nq ? nq : q);
}

// Dynamic shared bytes: the Wh quads past the registers, a float4 a thread.
__host__ __device__ constexpr size_t ta_lstm_smem(int nq, int bt,
                                                  int threads) {
    return (size_t)(nq - ta_lstm_nqr(nq, bt)) * threads * 16;
}

__device__ __forceinline__ float ta_sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

template <int NQ, int BT>
__global__ void __launch_bounds__(ta_lstm_bound(NQ), 1)
    ta_lstm_scan_kernel(const float* __restrict__ gx,
                        const float* __restrict__ whT,
                        const float* __restrict__ peep,
                        float* __restrict__ out, int T, int B, int ns) {
    constexpr int NSP = 4 * NQ;
    constexpr int NQR = ta_lstm_nqr(NQ, BT);
    static_assert(ta_lstm_smem(NQ, BT, ta_lstm_bound(NQ)) +
                          2 * BT * NSP * sizeof(float) <=
                      TA_SMEM_LIMIT,
                  "the instantiation's shared memory is over a block's");
    __shared__ __align__(16) float hbuf[2][BT][NSP];
    extern __shared__ float4 wsm[];  // quads NQR.. of the column: [k][tid]

    const int d = blockIdx.y;
    const int b0 = blockIdx.x * BT;
    const int nb = min(BT, B - b0);
    const int lane = threadIdx.x & 31;
    const int q = threadIdx.x & 3;
    const int j = threadIdx.x >> 2;
    const bool valid = j < ns;
    const int G = 4 * ns;
    const int g = q * ns + j;

    for (int k = threadIdx.x; k < 2 * BT * NSP; k += blockDim.x)
        (&hbuf[0][0][0])[k] = 0.0f;

    float w[4 * NQR + 1];
    const float* wd = whT + (size_t)d * ns * G;
#pragma unroll
    for (int s = 0; s < 4 * NQR; ++s)
        w[s] = (valid && s < ns) ? __ldg(wd + (size_t)s * G + g) : 0.0f;
    for (int k = NQR; k < NQ; ++k) {
        float v[4];
        for (int i = 0; i < 4; ++i) {
            const int s = 4 * k + i;
            v[i] = (valid && s < ns) ? __ldg(wd + (size_t)s * G + g) : 0.0f;
        }
        wsm[(k - NQR) * blockDim.x + threadIdx.x] =
            make_float4(v[0], v[1], v[2], v[3]);
    }
    const float* pd = peep + (size_t)d * 3 * ns;
    const float wip = valid ? __ldg(pd + j) : 0.0f;
    const float wfp = valid ? __ldg(pd + ns + j) : 0.0f;
    const float wop = valid ? __ldg(pd + 2 * ns + j) : 0.0f;

    // gx[d, t, b0 + r, g] and out[d, t, b0 + r, j]
    const float* gxd = gx + ((size_t)d * T * B + b0) * G + g;
    float* outd = out + ((size_t)d * T * B + b0) * ns + j;
    float gcur[BT], c[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
        gcur[r] = (valid && r < nb) ? __ldg(gxd + (size_t)r * G) : 0.0f;
        c[r] = 0.0f;
    }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        float gnext[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r)
            gnext[r] = (valid && t + 1 < T && r < nb)
                           ? __ldg(gxd + ((size_t)(t + 1) * B + r) * G)
                           : 0.0f;

        const float* hp = &hbuf[(t + 1) & 1][0][0];  // h_{t-1}
        float acc[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#ifndef TA_LSTM_NO_PRODUCT
#pragma unroll
        for (int k = 0; k < NQ; ++k) {
            const int kr = k < NQR ? 4 * k : 0;  // folds: k is unrolled
            const float4 wv =
                k < NQR ? make_float4(w[kr], w[kr + 1], w[kr + 2], w[kr + 3])
                        : wsm[(k - NQR) * blockDim.x + threadIdx.x];
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                const float4 hv =
                    *reinterpret_cast<const float4*>(hp + r * NSP + 4 * k);
                acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.x, wv.x));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.y, wv.y));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.z, wv.z));
                acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.w, wv.w));
            }
        }
#endif

        float* hn = &hbuf[t & 1][0][0];  // h_t
        const int base = lane & ~3;
#pragma unroll
        for (int r = 0; r < BT; ++r) {
            const float pre = __fadd_rn(gcur[r], acc[r]);
            const float gi_in = __shfl_sync(0xffffffffu, pre, base);
            const float gf_in = __shfl_sync(0xffffffffu, pre, base + 1);
            const float go_in = __shfl_sync(0xffffffffu, pre, base + 2);
            const float ci_in = __shfl_sync(0xffffffffu, pre, base + 3);
            const float cp = c[r];
            const float gi = ta_sigmoid(__fadd_rn(gi_in, __fmul_rn(wip, cp)));
            const float gf = ta_sigmoid(__fadd_rn(gf_in, __fmul_rn(wfp, cp)));
            const float ci = tanhf(ci_in);
            const float cn = __fadd_rn(__fmul_rn(ci, gi), __fmul_rn(gf, cp));
            const float go = ta_sigmoid(
                t > 0 ? __fadd_rn(go_in, __fmul_rn(wop, cn)) : go_in);
            const float h = __fmul_rn(tanhf(cn), go);
            c[r] = cn;
            if (valid && q == (r & 3)) {
                hn[r * NSP + j] = h;
                if (r < nb) outd[((size_t)t * B + r) * ns] = h;
            }
            gcur[r] = gnext[r];
        }
        __syncthreads();
    }
}

// The wide route's CTA: at most 1024 threads (32 warps, 8 a sub-partition:
// 64 registers a thread), so its register tier is what 64 registers leave
// after the budget of the narrow kernel.
constexpr int TA_LSTM_WIDE_THREADS = 1024;

__host__ __device__ constexpr int ta_lstm_wide_nqr(int bt) {
    return (64 - 12 * bt - 36) / 4 < 0 ? 0 : (64 - 12 * bt - 36) / 4;
}

__device__ __forceinline__ float4 ta_lstm_wquad(const float* wd, int g,
                                                int k, int ns, int G,
                                                bool valid) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = 4 * k + i;
        v[i] = (valid && s < ns) ? __ldg(wd + (size_t)s * G + g) : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
}

template <int BT>
__device__ __forceinline__ void ta_lstm_madd(float* acc, const float* hp,
                                             int NSP, int k, float4 wv) {
#pragma unroll
    for (int r = 0; r < BT; ++r) {
        const float4 hv = *reinterpret_cast<const float4*>(hp + r * NSP + 4 * k);
        acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.x, wv.x));
        acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.y, wv.y));
        acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.z, wv.z));
        acc[r] = __fadd_rn(acc[r], __fmul_rn(hv.w, wv.w));
    }
}

// Shared layout of the wide route: h [2][BT][NSP] and c [BT][NSP] floats,
// then the Wh quads NQR .. NQR + nqs of every unit group's column,
// [group][quad][thread] float4.
template <int BT>
__global__ void __launch_bounds__(TA_LSTM_WIDE_THREADS, 1)
    ta_lstm_scan_wide_kernel(const float* __restrict__ gx,
                             const float* __restrict__ whT,
                             const float* __restrict__ peep,
                             float* __restrict__ out, int T, int B, int ns,
                             int nqs) {
    constexpr int NQR = ta_lstm_wide_nqr(BT);
    const int nq = (ns + 3) / 4;
    const int NSP = 4 * nq;
    const int threads = blockDim.x;
    const int upg = threads >> 2;  // units a group
    const int ng = (ns + upg - 1) / upg;
    extern __shared__ float4 wide_sm[];
    float* hbuf = reinterpret_cast<float*>(wide_sm);
    float* cbuf = hbuf + 2 * BT * NSP;
    float4* wsm = reinterpret_cast<float4*>(cbuf + BT * NSP);

    const int d = blockIdx.y;
    const int b0 = blockIdx.x * BT;
    const int nb = min(BT, B - b0);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int q = tid & 3;
    const int j0 = tid >> 2;
    const int G = 4 * ns;

    for (int k = tid; k < 3 * BT * NSP; k += threads) hbuf[k] = 0.0f;

    const float* wd = whT + (size_t)d * ns * G;
    float w[4 * NQR + 1];
#pragma unroll
    for (int s = 0; s < 4 * NQR; ++s)
        w[s] = (j0 < ns && s < ns) ? __ldg(wd + (size_t)s * G + q * ns + j0)
                                   : 0.0f;
    for (int u = 0; u < ng; ++u) {
        const int j = j0 + u * upg;
        for (int kk = 0; kk < nqs; ++kk)
            wsm[(u * nqs + kk) * threads + tid] =
                ta_lstm_wquad(wd, q * ns + j, NQR + kk, ns, G, j < ns);
    }
    const float* pd = peep + (size_t)d * 3 * ns;
    const float* gxd = gx + ((size_t)d * T * B + b0) * G;
    float* outd = out + ((size_t)d * T * B + b0) * ns;
    __syncthreads();

    const int base = lane & ~3;
    for (int t = 0; t < T; ++t) {
        const float* hp = hbuf + ((t + 1) & 1) * BT * NSP;  // h_{t-1}
        float* hn = hbuf + (t & 1) * BT * NSP;              // h_t
        for (int u = 0; u < ng; ++u) {
            const int j = j0 + u * upg;
            const bool valid = j < ns;
            const int g = q * ns + j;
            float gcur[BT], acc[BT];
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                gcur[r] = (valid && r < nb)
                              ? __ldg(gxd + ((size_t)t * B + r) * G + g)
                              : 0.0f;
                acc[r] = 0.0f;
            }
#ifndef TA_LSTM_NO_PRODUCT
#pragma unroll
            for (int k = 0; k < NQR; ++k) {
                const float4 wv =
                    u == 0 ? make_float4(w[4 * k], w[4 * k + 1], w[4 * k + 2],
                                         w[4 * k + 3])
                           : ta_lstm_wquad(wd, g, k, ns, G, valid);
                ta_lstm_madd<BT>(acc, hp, NSP, k, wv);
            }
            for (int k = NQR; k < NQR + nqs; ++k)
                ta_lstm_madd<BT>(acc, hp, NSP, k,
                                 wsm[(u * nqs + k - NQR) * threads + tid]);
            // unrolled so that several quads' loads are in flight at once
#pragma unroll 4
            for (int k = NQR + nqs; k < nq; ++k)
                ta_lstm_madd<BT>(acc, hp, NSP, k,
                                 ta_lstm_wquad(wd, g, k, ns, G, valid));
#endif
            float cp[BT];
#pragma unroll
            for (int r = 0; r < BT; ++r) cp[r] = valid ? cbuf[r * NSP + j] : 0.0f;
            __syncwarp();  // every lane of the unit has read c_{t-1}
            const float wip = valid ? __ldg(pd + j) : 0.0f;
            const float wfp = valid ? __ldg(pd + ns + j) : 0.0f;
            const float wop = valid ? __ldg(pd + 2 * ns + j) : 0.0f;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
                const float pre = __fadd_rn(gcur[r], acc[r]);
                const float gi_in = __shfl_sync(0xffffffffu, pre, base);
                const float gf_in = __shfl_sync(0xffffffffu, pre, base + 1);
                const float go_in = __shfl_sync(0xffffffffu, pre, base + 2);
                const float ci_in = __shfl_sync(0xffffffffu, pre, base + 3);
                const float gi =
                    ta_sigmoid(__fadd_rn(gi_in, __fmul_rn(wip, cp[r])));
                const float gf =
                    ta_sigmoid(__fadd_rn(gf_in, __fmul_rn(wfp, cp[r])));
                const float ci = tanhf(ci_in);
                const float cn =
                    __fadd_rn(__fmul_rn(ci, gi), __fmul_rn(gf, cp[r]));
                const float go = ta_sigmoid(
                    t > 0 ? __fadd_rn(go_in, __fmul_rn(wop, cn)) : go_in);
                const float h = __fmul_rn(tanhf(cn), go);
                if (valid && q == (r & 3)) {
                    cbuf[r * NSP + j] = cn;
                    hn[r * NSP + j] = h;
                    if (r < nb) outd[((size_t)t * B + r) * ns + j] = h;
                }
            }
        }
        __syncthreads();
    }
}

static int ta_lstm_wide_threads(int ns) {
    const int t = (4 * ns + 31) / 32 * 32;
    return t < TA_LSTM_WIDE_THREADS ? t : TA_LSTM_WIDE_THREADS;
}

// Wh quads of each unit group's column in the shared tier (-1: the h and c
// buffers alone are over a block's shared memory).
static int ta_lstm_wide_nqs(int ns, int bt, int nqr) {
    const int threads = ta_lstm_wide_threads(ns);
    const int nq = (ns + 3) / 4;
    const int ng = (ns + threads / 4 - 1) / (threads / 4);
    const long long avail = TA_SMEM_LIMIT - 12LL * bt * 4 * nq;
    if (avail < 0) return -1;
    const long long fit = avail / (16LL * threads * ng);
    return (int)(fit < nq - nqr ? fit : nq - nqr);
}

static size_t ta_lstm_wide_smem(int ns, int bt, int nqs) {
    const int threads = ta_lstm_wide_threads(ns);
    const int nq = (ns + 3) / 4;
    const int ng = (ns + threads / 4 - 1) / (threads / 4);
    return 12 * (size_t)bt * 4 * nq + (size_t)16 * nqs * threads * ng;
}

template <int BT>
static cudaError_t ta_lstm_wide_launch(const float* gx, const float* whT,
                                       const float* peep, float* out, int T,
                                       int B, int ns, cudaStream_t stream) {
    const int nqs = ta_lstm_wide_nqs(ns, BT, ta_lstm_wide_nqr(BT));
    if (nqs < 0) return cudaErrorInvalidValue;
    const size_t smem = ta_lstm_wide_smem(ns, BT, nqs);
    auto kernel = ta_lstm_scan_wide_kernel<BT>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((B + BT - 1) / BT, 2), ta_lstm_wide_threads(ns), smem,
             stream>>>(gx, whT, peep, out, T, B, ns, nqs);
    return cudaSuccess;
}

template <int BT>
static cudaError_t ta_lstm_wide_attrs(int ns, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, ta_lstm_scan_wide_kernel<BT>);
    if (e != cudaSuccess) return e;
    const int nqr = ta_lstm_wide_nqr(BT);
    const int nqs = ta_lstm_wide_nqs(ns, BT, nqr);
    if (nqs < 0) return cudaErrorInvalidValue;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = ta_lstm_wide_threads(ns);
    out[3] = a.maxThreadsPerBlock;
    out[4] = nqr;
    out[5] = (int)(a.sharedSizeBytes + ta_lstm_wide_smem(ns, BT, nqs));
    out[6] = (ns + 3) / 4 - nqr - nqs;
    return cudaSuccess;
}

extern "C" const char* ta_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

static int ta_lstm_threads(int ns) { return (4 * ns + 31) / 32 * 32; }

template <int NQ, int BT>
static cudaError_t ta_lstm_launch(const float* gx, const float* whT,
                                  const float* peep, float* out, int T, int B,
                                  int ns, cudaStream_t stream) {
    const int threads = ta_lstm_threads(ns);
    if (threads > ta_lstm_bound(NQ)) return cudaErrorInvalidConfiguration;
    const size_t smem = ta_lstm_smem(NQ, BT, threads);
    auto kernel = ta_lstm_scan_kernel<NQ, BT>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((B + BT - 1) / BT, 2), threads, smem, stream>>>(
        gx, whT, peep, out, T, B, ns);
    return cudaSuccess;
}

// What the compiler made of the instantiation, at ns: registers and local
// (spill) bytes per thread, threads per block and the most a block of it
// can launch with, Wh quads held in registers, and shared bytes per block
// (static and dynamic).
template <int NQ, int BT>
static cudaError_t ta_lstm_attrs(int ns, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, ta_lstm_scan_kernel<NQ, BT>);
    if (e != cudaSuccess) return e;
    const int threads = ta_lstm_threads(ns);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = threads;
    out[3] = a.maxThreadsPerBlock;
    out[4] = ta_lstm_nqr(NQ, BT);
    out[5] = (int)(a.sharedSizeBytes + ta_lstm_smem(NQ, BT, threads));
    out[6] = 0;  // no quad read from global memory
    return cudaSuccess;
}

// The instantiations: NQ (ns rounded up to a multiple of 4, over 4) in
// {25, 32}, i.e. ns <= 100 and ns <= 128; BT in {1, 2, 4, 8}, where the
// shared memory of the Wh quads past the registers fits a block (not
// (32, 8)). Past ns = 128, nq = ceil(ns / 4) and the wide route, BT in
// {1, 2, 4}.
#define TA_LSTM_DISPATCH(FN, WIDE_FN, ...)                          \
    if (nq > 32) switch (bt) {                                      \
        case 1: return WIDE_FN<1>(__VA_ARGS__);                     \
        case 2: return WIDE_FN<2>(__VA_ARGS__);                     \
        case 4: return WIDE_FN<4>(__VA_ARGS__);                     \
        default: return cudaErrorInvalidValue;                      \
    }                                                               \
    switch (nq * 16 + bt) {                                         \
        case 25 * 16 + 1: return FN<25, 1>(__VA_ARGS__);            \
        case 25 * 16 + 2: return FN<25, 2>(__VA_ARGS__);            \
        case 25 * 16 + 4: return FN<25, 4>(__VA_ARGS__);            \
        case 25 * 16 + 8: return FN<25, 8>(__VA_ARGS__);            \
        case 32 * 16 + 1: return FN<32, 1>(__VA_ARGS__);            \
        case 32 * 16 + 2: return FN<32, 2>(__VA_ARGS__);            \
        case 32 * 16 + 4: return FN<32, 4>(__VA_ARGS__);            \
        default: return cudaErrorInvalidValue;                      \
    }

static cudaError_t ta_lstm_dispatch(const float* gx, const float* whT,
                                    const float* peep, float* out, int T,
                                    int B, int ns, int nq, int bt,
                                    cudaStream_t stream) {
    TA_LSTM_DISPATCH(ta_lstm_launch, ta_lstm_wide_launch, gx, whT, peep, out,
                     T, B, ns, stream)
}

static cudaError_t ta_lstm_attrs_dispatch(int nq, int bt, int ns, int* out) {
    TA_LSTM_DISPATCH(ta_lstm_attrs, ta_lstm_wide_attrs, ns, out)
}

// out[7]: regs, local_bytes, threads, max_threads, nqr, shared_bytes and
// the quads of a column read from global memory each step, of the (nq, bt)
// instantiation at ns (ta_lstm_attrs, ta_lstm_wide_attrs).
static bool ta_lstm_nq_ok(int nq, int ns) {
    return ns > 0 && 4 * nq >= ns && (nq <= 32 || nq == (ns + 3) / 4);
}

extern "C" int ta_lstm_scan_attrs(int nq, int bt, int ns, int device,
                                  int* out) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (!ta_lstm_nq_ok(nq, ns)) return (int)cudaErrorInvalidValue;
    return (int)ta_lstm_attrs_dispatch(nq, bt, ns, out);
}

extern "C" int ta_lstm_scan(const float* gx, const float* whT,
                            const float* peep, float* out, int T, int B,
                            int ns, int nq, int bt, int device,
                            void* stream) {
    // this library links its own CUDA runtime: select PyTorch's device
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    if (T <= 0 || B <= 0 || !ta_lstm_nq_ok(nq, ns))
        return (int)cudaErrorInvalidValue;
    e = ta_lstm_dispatch(gx, whT, peep, out, T, B, ns, nq, bt,
                         (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
