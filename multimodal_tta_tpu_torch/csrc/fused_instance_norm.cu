// Fused InstanceNorm + affine + optional ReLU over NDHWC x [B, S = D*H*W, C],
// forward and backward, one kernel launch each:
//
//     mean, var  per (b, c) over S in f32,  var = max(E[x^2] - E[x]^2, 0)
//     y  = act((x - mean) * rsqrt(var + eps) * gamma + beta)      in x's dtype
//     dx = rstd * gamma * (g - mean_S(g) - xhat * mean_S(g * xhat)),
//          g = gy * [y > 0] (ReLU) or gy,  xhat = (x - mean) * rstd
//     sums[0, b, c] = sum_S g,  sums[1, b, c] = sum_S g * xhat
//          (dbeta and dgamma are their sums over b)
//
// Replaces the TPU kernel multimodal_tta_tpu/pallas/fused_instance_norm.py
// (fused_instance_norm: _stats_kernel and _norm_kernel, two pallas_calls), and
// gives its gradient a kernel of the same skeleton. Over a depth split between
// ranks the two halves are separate entries again (stats, apply; bwd_sums,
// bwd_apply: see "split depth" below), with an all-reduce between them.
//
// What bounds it on Hopper: bytes. A few flops per element and no tensor-core
// work, so the least time is x read once and y written once (backward: gy and
// x read once, dx written once) at the card's memory rate. For most shapes of
// the model the tensor is so small (0.25-32 MB) that the byte time is a few
// microseconds and the cost is the launch: hence ONE launch per call.
//
// Design. The TPU kernel carries running sums through a sequential grid and
// reads x twice because no (b, c) slice fits its fast memory. Here two regimes,
// picked on the host (kernels/fused_instance_norm.py: plan):
//
//  * resident: a thread-block cluster of 1-8 CTAs owns one (sample, channel
//    group) slice [S, CG] with CG*sizeof(T) = 32 bytes (one sector per row).
//    Each CTA copies its rows into dynamic shared memory once with 16-byte
//    loads, accumulating the two sums in f32 registers; warps fold by shuffles,
//    the CTA through shared memory, the cluster by reading every peer's
//    partial through distributed shared memory in rank order; then the CTA
//    normalises out of shared memory. HBM traffic is 1R + 1W (backward:
//    2R + 1W), the least there is.
//  * streaming: a persistent cooperative grid. Phase 1: every CTA reduces
//    contiguous row chunks [rows, C] to f32 partials in a workspace
//    [B, P, 2, C]; a grid-wide barrier; phase 2: every CTA folds the P partials
//    of its sample (in index order) and normalises its chunks, walking them
//    backwards so that the rows phase 1 read last, which are still in L2, are
//    read first. Tensors up to the L2's size are read from HBM once; larger
//    ones twice. Channels that do not fill a 16-byte vector (odd C, unaligned
//    pointers) take the same kernel with one element per load.
//
// Determinism: every fold has a fixed order (shuffle tree, then index order);
// there are no floating-point atomics, so results are bitwise equal run to
// run. The elementwise arithmetic uses the non-contracting intrinsics
// (__fsub_rn, __fmul_rn, __fadd_rn), so the backward recomputes the ReLU mask
// from x bit for bit as the forward produced it (no read of y), and both
// follow the plain PyTorch version operation by operation.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// ---- V elements of T as one load/store -----------------------------------
template <typename T, int V> struct Raw;
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };
template <> struct Raw<__nv_bfloat16, 1> { using type = __nv_bfloat16; };

__device__ __forceinline__ void unpack(const float4& r, float (&f)[4]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
}
__device__ __forceinline__ void unpack(const float& r, float (&f)[1]) { f[0] = r; }
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
    }
}
__device__ __forceinline__ void unpack(const __nv_bfloat16& r, float (&f)[1]) {
    f[0] = __bfloat162float(r);
}
__device__ __forceinline__ void pack(const float (&f)[4], float4& r) {
    r = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void pack(const float (&f)[1], float& r) { r = f[0]; }
__device__ __forceinline__ void pack(const float (&f)[8], uint4& r) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
}
__device__ __forceinline__ void pack(const float (&f)[1], __nv_bfloat16& r) {
    r = __float2bfloat16_rn(f[0]);
}

// ---- the arithmetic, one rounding per operation as the plain version ------
__device__ __forceinline__ float xhat_of(float x, float mean, float rstd) {
    return __fmul_rn(__fsub_rn(x, mean), rstd);
}
__device__ __forceinline__ float affine_of(float xh, float gamma, float beta) {
    return __fadd_rn(__fmul_rn(xh, gamma), beta);
}
__device__ __forceinline__ void finish_stats(float sum, float sq, float n, float eps,
                                             float& mean, float& rstd) {
    mean = __fdiv_rn(sum, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(sq, n), __fmul_rn(mean, mean)), 0.0f);
    rstd = rsqrtf(__fadd_rn(var, eps));
}
__device__ __forceinline__ float dx_of(float g, float xh, float mg, float mgx, float scale) {
    return __fmul_rn(scale, __fsub_rn(__fsub_rn(g, mg), __fmul_rn(xh, mgx)));
}

// Sum over the lanes of a warp that share (lane & 1): a fixed xor tree.
template <int V>
__device__ __forceinline__ void fold_same_parity(float (&a)[V], float (&b)[V]) {
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
            b[i] += __shfl_xor_sync(0xffffffffu, b[i], off);
        }
    }
}

// ==== resident regime =======================================================
// grid (cluster, C / CG, B), cluster dimension (cluster, 1, 1). A slice row is
// two 16-byte vectors; thread t owns vectors t, t + THREADS, ... of the CTA's
// rows, so it always sees the same half of the channel group (THREADS is even)
// and reads back from shared memory only what it wrote itself.

// Fold the per-thread sums a[V], b[V] over the CTA, then over the cluster in
// rank order. On return tot[0..CG) and tot[CG..2CG) hold the cluster's totals
// in every CTA, and a cluster-wide barrier has passed.
template <int V>
__device__ __forceinline__ void cluster_fold(float (&a)[V], float (&b)[V],
                                             float (*warp_part)[2][2 * V], float* cta_part,
                                             float* tot) {
    constexpr int CG = 2 * V;
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    fold_same_parity<V>(a, b);
    if (lane < 2) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
            warp_part[warp][lane][i] = a[i];
            warp_part[warp][lane][V + i] = b[i];
        }
    }
    __syncthreads();
    if (tid < 2 * CG) {
        const int which = tid / CG, c = tid % CG;
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) acc += warp_part[w][c / V][which * V + c % V];
        cta_part[tid] = acc;
    }
    cluster.sync();
    if (tid < 2 * CG) {
        float acc = 0.0f;
        const unsigned ranks = cluster.num_blocks();
        for (unsigned r = 0; r < ranks; ++r) acc += cluster.map_shared_rank(cta_part, r)[tid];
        tot[tid] = acc;
    }
    // no CTA may leave (or reuse cta_part) while a peer still reads it
    cluster.sync();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
in_fwd_resident(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ stats, int B, int S, int C,
                int rows_per_cta, float n, float eps, int relu) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CG = 2 * V;
    using R = typename Raw<T, V>::type;
    extern __shared__ __align__(16) unsigned char slab_bytes[];
    R* slab = reinterpret_cast<R*>(slab_bytes);
    __shared__ float warp_part[WARPS][2][2 * V];
    __shared__ float cta_part[2 * CG];
    __shared__ float tot[2 * CG];
    __shared__ float st[2 * CG];  // mean[CG], rstd[CG]

    const int tid = threadIdx.x, half = tid & 1;
    const int rank = blockIdx.x, c0 = blockIdx.y * CG, b = blockIdx.z;
    const int row0 = rank * rows_per_cta;
    const int nvec = 2 * max(0, min(rows_per_cta, S - row0));
    const long long base = (static_cast<long long>(b) * S + row0) * C + c0 + half * V;

    float s[V], q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
#pragma unroll 4
    for (int v = tid; v < nvec; v += THREADS) {
        const R raw = *reinterpret_cast<const R*>(x + base + static_cast<long long>(v >> 1) * C);
        slab[v] = raw;
        float f[V];
        unpack(raw, f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
            s[i] += f[i];
            q[i] += f[i] * f[i];
        }
    }
    cluster_fold<V>(s, q, warp_part, cta_part, tot);
    if (tid < CG) {
        float mean, rstd;
        finish_stats(tot[tid], tot[CG + tid], n, eps, mean, rstd);
        st[tid] = mean;
        st[CG + tid] = rstd;
        if (rank == 0) {
            stats[b * C + c0 + tid] = mean;
            stats[(B + b) * C + c0 + tid] = rstd;
        }
    }
    __syncthreads();
    float m[V], rs[V], ga[V], be[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        m[i] = st[half * V + i];
        rs[i] = st[CG + half * V + i];
        ga[i] = gamma[c0 + half * V + i];
        be[i] = beta[c0 + half * V + i];
    }
#pragma unroll 4
    for (int v = tid; v < nvec; v += THREADS) {
        float f[V];
        unpack(slab[v], f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const float o = affine_of(xhat_of(f[i], m[i], rs[i]), ga[i], be[i]);
            f[i] = relu ? fmaxf(o, 0.0f) : o;
        }
        R out;
        pack(f, out);
        *reinterpret_cast<R*>(y + base + static_cast<long long>(v >> 1) * C) = out;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
in_bwd_resident(const T* __restrict__ gy, const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const float* __restrict__ stats,
                T* __restrict__ dx, float* __restrict__ sums, int B, int S, int C,
                int rows_per_cta, float n, int relu, int need_dx) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CG = 2 * V;
    using R = typename Raw<T, V>::type;
    extern __shared__ __align__(16) unsigned char slab_bytes[];
    R* slab = reinterpret_cast<R*>(slab_bytes);  // vector v: gy at 2v, x at 2v + 1
    __shared__ float warp_part[WARPS][2][2 * V];
    __shared__ float cta_part[2 * CG];
    __shared__ float tot[2 * CG];

    const int tid = threadIdx.x, half = tid & 1;
    const int rank = blockIdx.x, c0 = blockIdx.y * CG, b = blockIdx.z;
    const int row0 = rank * rows_per_cta;
    const int nvec = 2 * max(0, min(rows_per_cta, S - row0));
    const long long base = (static_cast<long long>(b) * S + row0) * C + c0 + half * V;

    float m[V], rs[V], ga[V], be[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        m[i] = stats[b * C + c0 + half * V + i];
        rs[i] = stats[(B + b) * C + c0 + half * V + i];
        ga[i] = gamma[c0 + half * V + i];
        be[i] = beta[c0 + half * V + i];
    }
    float sg[V], sgx[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sg[i] = sgx[i] = 0.0f;
#pragma unroll 2
    for (int v = tid; v < nvec; v += THREADS) {
        const long long off = base + static_cast<long long>(v >> 1) * C;
        const R rg = *reinterpret_cast<const R*>(gy + off);
        const R rx = *reinterpret_cast<const R*>(x + off);
        slab[2 * v] = rg;
        slab[2 * v + 1] = rx;
        float g[V], f[V];
        unpack(rg, g);
        unpack(rx, f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const float xh = xhat_of(f[i], m[i], rs[i]);
            const float gi = (relu && !(affine_of(xh, ga[i], be[i]) > 0.0f)) ? 0.0f : g[i];
            sg[i] += gi;
            sgx[i] += gi * xh;
        }
    }
    cluster_fold<V>(sg, sgx, warp_part, cta_part, tot);
    if (rank == 0 && tid < 2 * CG) {
        sums[(static_cast<long long>(tid / CG) * B + b) * C + c0 + tid % CG] = tot[tid];
    }
    if (!need_dx) return;
    float mg[V], mgx[V], scale[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        mg[i] = __fdiv_rn(tot[half * V + i], n);
        mgx[i] = __fdiv_rn(tot[CG + half * V + i], n);
        scale[i] = __fmul_rn(rs[i], ga[i]);
    }
#pragma unroll 2
    for (int v = tid; v < nvec; v += THREADS) {
        float g[V], f[V];
        unpack(slab[2 * v], g);
        unpack(slab[2 * v + 1], f);
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const float xh = xhat_of(f[i], m[i], rs[i]);
            const float gi = (relu && !(affine_of(xh, ga[i], be[i]) > 0.0f)) ? 0.0f : g[i];
            f[i] = dx_of(gi, xh, mg[i], mgx[i], scale[i]);
        }
        R out;
        pack(f, out);
        *reinterpret_cast<R*>(dx + base + static_cast<long long>(v >> 1) * C) = out;
    }
}

// ==== streaming regime ======================================================
// A persistent cooperative grid over B * P chunks; chunk (b, p) is the rows
// [p * rpc, (p + 1) * rpc) of sample b with all C channels, one contiguous run
// of memory. Inside a chunk the threads form RPI rows of LC vector lanes
// (LC = min(C / V, THREADS)), so that a thread keeps one set of V channels in
// registers; when C / V exceeds THREADS the channels go in NT tiles.

struct Geometry {
    int lanes_c, LC, RPI, NT, lane, rl;
};

template <int V>
__device__ __forceinline__ Geometry geometry(int C) {
    Geometry g;
    g.lanes_c = C / V;
    g.LC = min(g.lanes_c, THREADS);
    g.RPI = THREADS / g.LC;
    g.NT = (g.lanes_c + g.LC - 1) / g.LC;
    g.lane = threadIdx.x % g.LC;
    g.rl = threadIdx.x / g.LC;  // >= RPI: the thread idles
    return g;
}

// Fold per-thread sums over the RPI row threads of each lane (index order) and
// write the chunk's partial for channels cv*V.. to ws[(chunk*2 + {0,1})*C + c].
template <int V>
__device__ __forceinline__ void chunk_partial(const float (&a)[V], const float (&b)[V],
                                              const Geometry& g, int cv, float* scratch,
                                              float* ws_chunk, int C) {
    if (g.rl < g.RPI) {
        float* dst = scratch + (g.rl * g.LC + g.lane) * 2 * V;
#pragma unroll
        for (int i = 0; i < V; ++i) {
            dst[i] = a[i];
            dst[V + i] = b[i];
        }
    }
    __syncthreads();
    if (g.rl == 0 && cv < g.lanes_c) {
        float ta[V], tb[V];
#pragma unroll
        for (int i = 0; i < V; ++i) ta[i] = tb[i] = 0.0f;
        for (int k = 0; k < g.RPI; ++k) {
            const float* src = scratch + (k * g.LC + g.lane) * 2 * V;
#pragma unroll
            for (int i = 0; i < V; ++i) {
                ta[i] += src[i];
                tb[i] += src[V + i];
            }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
            ws_chunk[cv * V + i] = ta[i];
            ws_chunk[C + cv * V + i] = tb[i];
        }
    }
    __syncthreads();
}

// Fold the P partials of sample b (index order: first within K strided
// threads, then over the K) into tot[0..C) and tot[C..2C) in shared memory.
__device__ __forceinline__ void sample_totals(const float* ws_sample, int P, int C,
                                              float* scratch, float* tot) {
    const int tid = threadIdx.x;
    const int CW = min(C, THREADS), K = THREADS / CW;
    const int lane = tid % CW, k = tid / CW;
    for (int c0 = 0; c0 < C; c0 += CW) {
        const int c = c0 + lane;
        if (k < K) {
            float a = 0.0f, b = 0.0f;
            if (c < C) {
#pragma unroll 4
                for (int p = k; p < P; p += K) {
                    a += ws_sample[static_cast<long long>(2 * p) * C + c];
                    b += ws_sample[static_cast<long long>(2 * p + 1) * C + c];
                }
            }
            scratch[(k * CW + lane) * 2] = a;
            scratch[(k * CW + lane) * 2 + 1] = b;
        }
        __syncthreads();
        if (k == 0 && c < C) {
            float a = 0.0f, b = 0.0f;
            for (int kk = 0; kk < K; ++kk) {
                a += scratch[(kk * CW + lane) * 2];
                b += scratch[(kk * CW + lane) * 2 + 1];
            }
            tot[c] = a;
            tot[C + c] = b;
        }
        __syncthreads();
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_fwd_stream(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
              const float* __restrict__ beta, float* __restrict__ stats, float* __restrict__ ws,
              int B, int S, int C, int P, int rpc, float n, float eps, int relu) {
    using R = typename Raw<T, V>::type;
    extern __shared__ __align__(16) float sm[];
    float* scratch = sm;               // THREADS * 2 * V floats
    float* tot = sm + THREADS * 2 * V;  // 2 * C floats: sums, then mean and rstd
    const Geometry g = geometry<V>(C);
    const int nchunks = B * P;

    for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
        const int b = chunk / P, p = chunk % P;
        const int row0 = p * rpc, nrows = min(rpc, S - row0);
        const T* xb = x + (static_cast<long long>(b) * S + row0) * C;
        for (int tile = 0; tile < g.NT; ++tile) {
            const int cv = tile * g.LC + g.lane;
            float s[V], q[V];
#pragma unroll
            for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
            if (g.rl < g.RPI && cv < g.lanes_c) {
#pragma unroll 4
                for (int r = g.rl; r < nrows; r += g.RPI) {
                    float f[V];
                    unpack(*reinterpret_cast<const R*>(xb + static_cast<long long>(r) * C + cv * V), f);
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        s[i] += f[i];
                        q[i] += f[i] * f[i];
                    }
                }
            }
            chunk_partial<V>(s, q, g, cv, scratch, ws + static_cast<long long>(chunk) * 2 * C, C);
        }
    }
    cg::this_grid().sync();

    for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
        const int b = chunk / P, p = chunk % P;
        const int row0 = p * rpc, nrows = min(rpc, S - row0);
        sample_totals(ws + static_cast<long long>(b) * P * 2 * C, P, C, scratch, tot);
        for (int c = threadIdx.x; c < C; c += THREADS) {
            float mean, rstd;
            finish_stats(tot[c], tot[C + c], n, eps, mean, rstd);
            tot[c] = mean;
            tot[C + c] = rstd;
            if (p == 0) {
                stats[b * C + c] = mean;
                stats[(B + b) * C + c] = rstd;
            }
        }
        __syncthreads();
        const long long cbase = (static_cast<long long>(b) * S + row0) * C;
        for (int tile = 0; tile < g.NT; ++tile) {
            const int cv = tile * g.LC + g.lane;
            if (g.rl < g.RPI && cv < g.lanes_c && nrows > g.rl) {
                float m[V], rs[V], ga[V], be[V];
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    m[i] = tot[cv * V + i];
                    rs[i] = tot[C + cv * V + i];
                    ga[i] = gamma[cv * V + i];
                    be[i] = beta[cv * V + i];
                }
                // backwards: the rows phase 1 read last are the likeliest in L2
#pragma unroll 4
                for (int it = (nrows - g.rl - 1) / g.RPI; it >= 0; --it) {
                    const long long off = cbase + static_cast<long long>(g.rl + it * g.RPI) * C + cv * V;
                    float f[V];
                    unpack(*reinterpret_cast<const R*>(x + off), f);
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const float o = affine_of(xhat_of(f[i], m[i], rs[i]), ga[i], be[i]);
                        f[i] = relu ? fmaxf(o, 0.0f) : o;
                    }
                    R out;
                    pack(f, out);
                    *reinterpret_cast<R*>(y + off) = out;
                }
            }
        }
        __syncthreads();  // tot is rewritten for the CTA's next chunk
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_bwd_stream(const T* __restrict__ gy, const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const float* __restrict__ stats,
              T* __restrict__ dx, float* __restrict__ sums, float* __restrict__ ws,
              int B, int S, int C, int P, int rpc, float n, int relu, int need_dx) {
    using R = typename Raw<T, V>::type;
    extern __shared__ __align__(16) float sm[];
    float* scratch = sm;
    float* tot = sm + THREADS * 2 * V;  // sum g [C], sum g*xhat [C]
    const Geometry g = geometry<V>(C);
    const int nchunks = B * P;

    for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
        const int b = chunk / P, p = chunk % P;
        const int row0 = p * rpc, nrows = min(rpc, S - row0);
        const long long cbase = (static_cast<long long>(b) * S + row0) * C;
        for (int tile = 0; tile < g.NT; ++tile) {
            const int cv = tile * g.LC + g.lane;
            float sg[V], sgx[V];
#pragma unroll
            for (int i = 0; i < V; ++i) sg[i] = sgx[i] = 0.0f;
            if (g.rl < g.RPI && cv < g.lanes_c) {
                float m[V], rs[V], ga[V], be[V];
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    m[i] = stats[b * C + cv * V + i];
                    rs[i] = stats[(B + b) * C + cv * V + i];
                    ga[i] = gamma[cv * V + i];
                    be[i] = beta[cv * V + i];
                }
#pragma unroll 2
                for (int r = g.rl; r < nrows; r += g.RPI) {
                    const long long off = cbase + static_cast<long long>(r) * C + cv * V;
                    float gg[V], f[V];
                    unpack(*reinterpret_cast<const R*>(gy + off), gg);
                    unpack(*reinterpret_cast<const R*>(x + off), f);
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const float xh = xhat_of(f[i], m[i], rs[i]);
                        const float gi =
                            (relu && !(affine_of(xh, ga[i], be[i]) > 0.0f)) ? 0.0f : gg[i];
                        sg[i] += gi;
                        sgx[i] += gi * xh;
                    }
                }
            }
            chunk_partial<V>(sg, sgx, g, cv, scratch, ws + static_cast<long long>(chunk) * 2 * C, C);
        }
    }
    cg::this_grid().sync();

    for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
        const int b = chunk / P, p = chunk % P;
        if (!need_dx && p != 0) continue;
        const int row0 = p * rpc, nrows = min(rpc, S - row0);
        sample_totals(ws + static_cast<long long>(b) * P * 2 * C, P, C, scratch, tot);
        if (p == 0) {
            for (int c = threadIdx.x; c < C; c += THREADS) {
                sums[b * C + c] = tot[c];
                sums[(B + b) * C + c] = tot[C + c];
            }
        }
        if (need_dx) {
            const long long cbase = (static_cast<long long>(b) * S + row0) * C;
            for (int tile = 0; tile < g.NT; ++tile) {
                const int cv = tile * g.LC + g.lane;
                if (g.rl < g.RPI && cv < g.lanes_c && nrows > g.rl) {
                    float m[V], rs[V], ga[V], be[V], mg[V], mgx[V], scale[V];
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        m[i] = stats[b * C + cv * V + i];
                        rs[i] = stats[(B + b) * C + cv * V + i];
                        ga[i] = gamma[cv * V + i];
                        be[i] = beta[cv * V + i];
                        mg[i] = __fdiv_rn(tot[cv * V + i], n);
                        mgx[i] = __fdiv_rn(tot[C + cv * V + i], n);
                        scale[i] = __fmul_rn(rs[i], ga[i]);
                    }
#pragma unroll 2
                    for (int it = (nrows - g.rl - 1) / g.RPI; it >= 0; --it) {
                        const long long off =
                            cbase + static_cast<long long>(g.rl + it * g.RPI) * C + cv * V;
                        float gg[V], f[V];
                        unpack(*reinterpret_cast<const R*>(gy + off), gg);
                        unpack(*reinterpret_cast<const R*>(x + off), f);
#pragma unroll
                        for (int i = 0; i < V; ++i) {
                            const float xh = xhat_of(f[i], m[i], rs[i]);
                            const float gi =
                                (relu && !(affine_of(xh, ga[i], be[i]) > 0.0f)) ? 0.0f : gg[i];
                            f[i] = dx_of(gi, xh, mg[i], mgx[i], scale[i]);
                        }
                        R out;
                        pack(f, out);
                        *reinterpret_cast<R*>(dx + off) = out;
                    }
                }
            }
        }
        __syncthreads();  // tot is rewritten for the CTA's next chunk
    }
}

// ==== split depth: the statistics and the normalisation as separate entries ==
// When a volume's depth is split over ranks (parallel/space.py), the
// statistics of a (b, c) span ranks: each rank sums its slab (stats,
// bwd_sums), the sums are all-reduced between the launches, and a second
// launch normalises with the global sums (apply, bwd_apply). stats and
// bwd_sums are the streaming kernels' phase 1 and fold, without phase 2;
// apply and bwd_apply are their phase 2, with the totals read from memory
// instead of folded, so they need no grid barrier. Same grid and chunks as
// the streaming regime: chunk (b, p) is rows [p * rpc, (p + 1) * rpc) of b.

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_stats_split(const T* __restrict__ x, float* __restrict__ out, float* __restrict__ ws,
               int B, int S, int C, int P, int rpc) {
    using R = typename Raw<T, V>::type;
    extern __shared__ __align__(16) float sm[];
    float* scratch = sm;
    float* tot = sm + THREADS * 2 * V;
    const Geometry g = geometry<V>(C);
    const int nchunks = B * P;
    for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
        const int b = chunk / P, p = chunk % P;
        const int row0 = p * rpc, nrows = min(rpc, S - row0);
        const T* xb = x + (static_cast<long long>(b) * S + row0) * C;
        for (int tile = 0; tile < g.NT; ++tile) {
            const int cv = tile * g.LC + g.lane;
            float s[V], q[V];
#pragma unroll
            for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
            if (g.rl < g.RPI && cv < g.lanes_c) {
#pragma unroll 4
                for (int r = g.rl; r < nrows; r += g.RPI) {
                    float f[V];
                    unpack(*reinterpret_cast<const R*>(xb + static_cast<long long>(r) * C + cv * V), f);
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        s[i] += f[i];
                        q[i] += f[i] * f[i];
                    }
                }
            }
            chunk_partial<V>(s, q, g, cv, scratch, ws + static_cast<long long>(chunk) * 2 * C, C);
        }
    }
    cg::this_grid().sync();
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        sample_totals(ws + static_cast<long long>(b) * P * 2 * C, P, C, scratch, tot);
        for (int c = threadIdx.x; c < C; c += THREADS) {
            out[b * C + c] = tot[c];
            out[(B + b) * C + c] = tot[C + c];
        }
        __syncthreads();
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_apply_split(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ sums,
               float* __restrict__ stats, int B, int S, int C, int P, int rpc, float n, float eps,
               int relu) {
    using R = typename Raw<T, V>::type;
    extern __shared__ __align__(16) float st[];  // mean [C], rstd [C] of the chunk's sample
    const Geometry g = geometry<V>(C);
    const int nchunks = B * P;
    for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
        const int b = chunk / P, p = chunk % P;
        const int row0 = p * rpc, nrows = min(rpc, S - row0);
        for (int c = threadIdx.x; c < C; c += THREADS) {
            float mean, rstd;
            finish_stats(sums[b * C + c], sums[(B + b) * C + c], n, eps, mean, rstd);
            st[c] = mean;
            st[C + c] = rstd;
            if (p == 0) {
                stats[b * C + c] = mean;
                stats[(B + b) * C + c] = rstd;
            }
        }
        __syncthreads();
        const long long cbase = (static_cast<long long>(b) * S + row0) * C;
        for (int tile = 0; tile < g.NT; ++tile) {
            const int cv = tile * g.LC + g.lane;
            if (g.rl < g.RPI && cv < g.lanes_c) {
                float m[V], rs[V], ga[V], be[V];
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    m[i] = st[cv * V + i];
                    rs[i] = st[C + cv * V + i];
                    ga[i] = gamma[cv * V + i];
                    be[i] = beta[cv * V + i];
                }
#pragma unroll 4
                for (int r = g.rl; r < nrows; r += g.RPI) {
                    const long long off = cbase + static_cast<long long>(r) * C + cv * V;
                    float f[V];
                    unpack(*reinterpret_cast<const R*>(x + off), f);
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const float o = affine_of(xhat_of(f[i], m[i], rs[i]), ga[i], be[i]);
                        f[i] = relu ? fmaxf(o, 0.0f) : o;
                    }
                    R ov;
                    pack(f, ov);
                    *reinterpret_cast<R*>(y + off) = ov;
                }
            }
        }
        __syncthreads();  // st is rewritten for the CTA's next chunk
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_bwd_sums_split(const T* __restrict__ gy, const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ stats,
                  float* __restrict__ out, float* __restrict__ ws, int B, int S, int C, int P,
                  int rpc, int relu) {
    using R = typename Raw<T, V>::type;
    extern __shared__ __align__(16) float sm[];
    float* scratch = sm;
    float* tot = sm + THREADS * 2 * V;
    const Geometry g = geometry<V>(C);
    const int nchunks = B * P;
    for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
        const int b = chunk / P, p = chunk % P;
        const int row0 = p * rpc, nrows = min(rpc, S - row0);
        const long long cbase = (static_cast<long long>(b) * S + row0) * C;
        for (int tile = 0; tile < g.NT; ++tile) {
            const int cv = tile * g.LC + g.lane;
            float sg[V], sgx[V];
#pragma unroll
            for (int i = 0; i < V; ++i) sg[i] = sgx[i] = 0.0f;
            if (g.rl < g.RPI && cv < g.lanes_c) {
                float m[V], rs[V], ga[V], be[V];
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    m[i] = stats[b * C + cv * V + i];
                    rs[i] = stats[(B + b) * C + cv * V + i];
                    ga[i] = gamma[cv * V + i];
                    be[i] = beta[cv * V + i];
                }
#pragma unroll 2
                for (int r = g.rl; r < nrows; r += g.RPI) {
                    const long long off = cbase + static_cast<long long>(r) * C + cv * V;
                    float gg[V], f[V];
                    unpack(*reinterpret_cast<const R*>(gy + off), gg);
                    unpack(*reinterpret_cast<const R*>(x + off), f);
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const float xh = xhat_of(f[i], m[i], rs[i]);
                        const float gi =
                            (relu && !(affine_of(xh, ga[i], be[i]) > 0.0f)) ? 0.0f : gg[i];
                        sg[i] += gi;
                        sgx[i] += gi * xh;
                    }
                }
            }
            chunk_partial<V>(sg, sgx, g, cv, scratch, ws + static_cast<long long>(chunk) * 2 * C, C);
        }
    }
    cg::this_grid().sync();
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
        sample_totals(ws + static_cast<long long>(b) * P * 2 * C, P, C, scratch, tot);
        for (int c = threadIdx.x; c < C; c += THREADS) {
            out[b * C + c] = tot[c];
            out[(B + b) * C + c] = tot[C + c];
        }
        __syncthreads();
    }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_bwd_apply_split(const T* __restrict__ gy, const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ stats,
                   const float* __restrict__ sums, T* __restrict__ dx, int B, int S, int C, int P,
                   int rpc, float n, int relu) {
    using R = typename Raw<T, V>::type;
    const Geometry g = geometry<V>(C);
    const int nchunks = B * P;
    for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
        const int b = chunk / P, p = chunk % P;
        const int row0 = p * rpc, nrows = min(rpc, S - row0);
        const long long cbase = (static_cast<long long>(b) * S + row0) * C;
        for (int tile = 0; tile < g.NT; ++tile) {
            const int cv = tile * g.LC + g.lane;
            if (g.rl < g.RPI && cv < g.lanes_c) {
                float m[V], rs[V], ga[V], be[V], mg[V], mgx[V], scale[V];
#pragma unroll
                for (int i = 0; i < V; ++i) {
                    m[i] = stats[b * C + cv * V + i];
                    rs[i] = stats[(B + b) * C + cv * V + i];
                    ga[i] = gamma[cv * V + i];
                    be[i] = beta[cv * V + i];
                    mg[i] = __fdiv_rn(sums[b * C + cv * V + i], n);
                    mgx[i] = __fdiv_rn(sums[(B + b) * C + cv * V + i], n);
                    scale[i] = __fmul_rn(rs[i], ga[i]);
                }
#pragma unroll 2
                for (int r = g.rl; r < nrows; r += g.RPI) {
                    const long long off = cbase + static_cast<long long>(r) * C + cv * V;
                    float gg[V], f[V];
                    unpack(*reinterpret_cast<const R*>(gy + off), gg);
                    unpack(*reinterpret_cast<const R*>(x + off), f);
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const float xh = xhat_of(f[i], m[i], rs[i]);
                        const float gi =
                            (relu && !(affine_of(xh, ga[i], be[i]) > 0.0f)) ? 0.0f : gg[i];
                        f[i] = dx_of(gi, xh, mg[i], mgx[i], scale[i]);
                    }
                    R ov;
                    pack(f, ov);
                    *reinterpret_cast<R*>(dx + off) = ov;
                }
            }
        }
    }
}

// ==== host side =============================================================

constexpr int REGIME_RESIDENT = 0;
constexpr int REGIME_STREAMING = 1;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int cluster, size_t smem,
                   cudaStream_t stream, int validate, Args... args) {
    cudaError_t e;
    if (smem > STATIC_SMEM_LIMIT) {
        e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (validate) {
        int clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<const void*>(kernel), &cfg);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    }
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// CTAs of `kernel` that fit one SM at THREADS threads and `smem` dynamic bytes.
int ctas_per_sm(const void* kernel, size_t smem, int* out) {
    if (smem > STATIC_SMEM_LIMIT) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, THREADS, smem));
}

int launch_cooperative(const void* kernel, int grid, size_t smem, cudaStream_t stream,
                       int validate, void** args) {
    if (validate || smem > STATIC_SMEM_LIMIT) {
        int per_sm = 0, device = 0, sms = 0;
        int code = ctas_per_sm(kernel, smem, &per_sm);
        if (code != 0) return code;
        cudaError_t e = cudaGetDevice(&device);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (e != cudaSuccess) return static_cast<int>(e);
        // every CTA must be resident at once, or the grid barrier never completes
        if (grid > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    }
    const cudaError_t e =
        cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), args, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
const void* stream_kernel(int backward) {
    return backward ? reinterpret_cast<const void*>(&in_bwd_stream<T, V>)
                    : reinterpret_cast<const void*>(&in_fwd_stream<T, V>);
}

// The split entries that reduce over the grid (cooperative): 0 stats, 1 bwd_sums.
template <typename T, int V>
const void* split_sum_kernel(int backward) {
    return backward ? reinterpret_cast<const void*>(&in_bwd_sums_split<T, V>)
                    : reinterpret_cast<const void*>(&in_stats_split<T, V>);
}

const void* split_sum_kernel(int backward, int is_bf16, int vec) {
    if (is_bf16) {
        return vec == 8 ? split_sum_kernel<__nv_bfloat16, 8>(backward)
             : vec == 1 ? split_sum_kernel<__nv_bfloat16, 1>(backward) : nullptr;
    }
    return vec == 4 ? split_sum_kernel<float, 4>(backward)
         : vec == 1 ? split_sum_kernel<float, 1>(backward) : nullptr;
}

bool bad_split(int B, int S, int C, int is_bf16, int vec, int rows, int grid, int P) {
    const int full = is_bf16 ? 8 : 4;
    return B <= 0 || S <= 0 || C <= 0 || rows <= 0 || grid < 1 || P < 1 ||
           (vec != full && vec != 1) || C % vec != 0 || static_cast<long long>(P) * rows < S;
}

template <typename K, typename... Args>
int launch_plain(K kernel, int grid, size_t smem, cudaStream_t stream, Args... args) {
    if (smem > STATIC_SMEM_LIMIT) {
        const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, THREADS, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

const void* stream_kernel(int backward, int is_bf16, int vec) {
    if (is_bf16) {
        return vec == 8 ? stream_kernel<__nv_bfloat16, 8>(backward)
             : vec == 1 ? stream_kernel<__nv_bfloat16, 1>(backward) : nullptr;
    }
    return vec == 4 ? stream_kernel<float, 4>(backward)
         : vec == 1 ? stream_kernel<float, 1>(backward) : nullptr;
}

bool bad_shape(int B, int S, int C, int regime, int is_bf16, int vec, int cluster, int rows,
               int grid, int P) {
    if (B <= 0 || S <= 0 || C <= 0 || rows <= 0) return true;
    const int full = is_bf16 ? 8 : 4;
    if (regime == REGIME_RESIDENT) {
        return vec != full || C % (2 * full) != 0 || cluster < 1 || cluster > 8 ||
               static_cast<long long>(cluster) * rows < S || B > 65535 || C / (2 * full) > 65535;
    }
    if (regime == REGIME_STREAMING) {
        return (vec != full && vec != 1) || C % vec != 0 || grid < 1 || P < 1 ||
               static_cast<long long>(P) * rows < S;
    }
    return true;
}

}  // namespace

// All launchers enqueue on `stream`, do not synchronise, and return 0 or the
// CUDA error of the refused launch. `validate` != 0 adds the occupancy checks
// (one cluster must fit the card; a cooperative grid must be co-resident);
// the caller asks for them the first time it uses a plan.
//
// x, y [B, S, C] of f32 or bf16 (is_bf16); gamma, beta [C] f32; stats [2, B, C]
// f32 receives mean and rstd. resident: grid (cluster, C / CG, B), `rows` rows
// per CTA, `smem` = rows * 32 bytes. streaming: `grid` CTAs, P chunks of `rows`
// rows per sample, ws [B, P, 2, C] f32, `smem` = (THREADS * 2 * vec + 2 * C) * 4.
extern "C" int mtta_instance_norm_forward(const void* x, void* y, const void* gamma,
                                          const void* beta, void* stats, void* ws, int B, int S,
                                          int C, int is_bf16, int relu, float eps, int regime,
                                          int vec, int cluster, int rows, int grid, int P,
                                          long long smem, int validate, void* stream) {
    if (x == nullptr || y == nullptr || gamma == nullptr || beta == nullptr || stats == nullptr ||
        smem < 0 || bad_shape(B, S, C, regime, is_bf16, vec, cluster, rows, grid, P)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ga = static_cast<const float*>(gamma);
    const float* be = static_cast<const float*>(beta);
    float* stats_f = static_cast<float*>(stats);
    const float n = static_cast<float>(S);
    if (regime == REGIME_RESIDENT) {
        const int cgw = is_bf16 ? 16 : 8;
        const dim3 g(cluster, C / cgw, B);
        if (is_bf16) {
            return launch_cluster(in_fwd_resident<__nv_bfloat16>, g, cluster, smem, st, validate,
                                  static_cast<const __nv_bfloat16*>(x),
                                  static_cast<__nv_bfloat16*>(y), ga, be, stats_f, B, S, C, rows, n,
                                  eps, relu);
        }
        return launch_cluster(in_fwd_resident<float>, g, cluster, smem, st, validate,
                              static_cast<const float*>(x), static_cast<float*>(y), ga, be,
                              stats_f, B, S, C, rows, n, eps, relu);
    }
    if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&x, &y, &ga, &be, &stats_f, &ws, &B, &S, &C, &P, &rows, const_cast<float*>(&n),
                    &eps, &relu};
    return launch_cooperative(stream_kernel(0, is_bf16, vec), grid, smem, st, validate, args);
}

// gy, x, dx [B, S, C]; stats [2, B, C] as the forward wrote them; sums
// [2, B, C] f32 receives sum g and sum g * xhat per sample; dx is written only
// when need_dx != 0 (it may be null otherwise). resident: `smem` = rows * 64.
extern "C" int mtta_instance_norm_backward(const void* gy, const void* x, const void* gamma,
                                           const void* beta, const void* stats, void* dx,
                                           void* sums, void* ws, int B, int S, int C, int is_bf16,
                                           int relu, int need_dx, int regime, int vec, int cluster,
                                           int rows, int grid, int P, long long smem, int validate,
                                           void* stream) {
    if (gy == nullptr || x == nullptr || gamma == nullptr || beta == nullptr || stats == nullptr ||
        sums == nullptr || (need_dx && dx == nullptr) || smem < 0 ||
        bad_shape(B, S, C, regime, is_bf16, vec, cluster, rows, grid, P)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ga = static_cast<const float*>(gamma);
    const float* be = static_cast<const float*>(beta);
    const float* stats_f = static_cast<const float*>(stats);
    float* sums_f = static_cast<float*>(sums);
    const float n = static_cast<float>(S);
    if (regime == REGIME_RESIDENT) {
        const int cgw = is_bf16 ? 16 : 8;
        const dim3 g(cluster, C / cgw, B);
        if (is_bf16) {
            return launch_cluster(in_bwd_resident<__nv_bfloat16>, g, cluster, smem, st, validate,
                                  static_cast<const __nv_bfloat16*>(gy),
                                  static_cast<const __nv_bfloat16*>(x), ga, be, stats_f,
                                  static_cast<__nv_bfloat16*>(dx), sums_f, B, S, C, rows, n, relu,
                                  need_dx);
        }
        return launch_cluster(in_bwd_resident<float>, g, cluster, smem, st, validate,
                              static_cast<const float*>(gy), static_cast<const float*>(x), ga, be,
                              stats_f, static_cast<float*>(dx), sums_f, B, S, C, rows, n, relu,
                              need_dx);
    }
    if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&gy, &x, &ga, &be, &stats_f, &dx, &sums_f, &ws, &B, &S, &C, &P, &rows,
                    const_cast<float*>(&n), &relu, &need_dx};
    return launch_cooperative(stream_kernel(1, is_bf16, vec), grid, smem, st, validate, args);
}

// CTAs of the streaming kernel (forward or backward, dtype, vector width) that
// one SM holds at `smem` dynamic bytes; negative: minus the CUDA error code.
extern "C" int mtta_instance_norm_stream_ctas_per_sm(int backward, int is_bf16, int vec,
                                                     long long smem) {
    const void* kernel = stream_kernel(backward, is_bf16, vec);
    if (kernel == nullptr || smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0;
    const int code = ctas_per_sm(kernel, static_cast<size_t>(smem), &per_sm);
    return code != 0 ? -code : per_sm;
}

// ---- the split-depth entries (parallel/space.py) ---------------------------
// Streaming geometry: `grid` CTAs, P chunks of `rows` rows per sample. stats
// and bwd_sums take ws [B, P, 2, C] f32 and `smem` = (THREADS * 2 * vec + 2 *
// C) * 4 (cooperative: the grid must be co-resident); apply takes 2 * C
// floats of dynamic shared memory, bwd_apply none. `n` is the element count
// of a (b, c) over the WHOLE depth (every rank's slab), as a float.

// out [2, B, C] f32: sum x, sum x^2 of this slab per (b, c).
extern "C" int mtta_instance_norm_stats(const void* x, void* out, void* ws, int B, int S, int C,
                                        int is_bf16, int vec, int rows, int grid, int P,
                                        long long smem, int validate, void* stream) {
    if (x == nullptr || out == nullptr || ws == nullptr || smem < 0 ||
        bad_split(B, S, C, is_bf16, vec, rows, grid, P)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    void* args[] = {&x, &out, &ws, &B, &S, &C, &P, &rows};
    return launch_cooperative(split_sum_kernel(0, is_bf16, vec), grid, smem,
                              static_cast<cudaStream_t>(stream), validate, args);
}

// y = act((x - mean) * rstd * gamma + beta) from the global sums [2, B, C];
// stats [2, B, C] receives mean and rstd (what bwd_sums and bwd_apply take).
extern "C" int mtta_instance_norm_apply(const void* x, void* y, const void* gamma, const void* beta,
                                        const void* sums, void* stats, int B, int S, int C,
                                        int is_bf16, int relu, float n, float eps, int vec,
                                        int rows, int grid, int P, void* stream) {
    if (x == nullptr || y == nullptr || gamma == nullptr || beta == nullptr || sums == nullptr ||
        stats == nullptr || !(n > 0.0f) || bad_split(B, S, C, is_bf16, vec, rows, grid, P)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = static_cast<size_t>(2 * C) * sizeof(float);
    const float* ga = static_cast<const float*>(gamma);
    const float* be = static_cast<const float*>(beta);
    const float* su = static_cast<const float*>(sums);
    float* sf = static_cast<float*>(stats);
    if (is_bf16) {
        const __nv_bfloat16* xi = static_cast<const __nv_bfloat16*>(x);
        __nv_bfloat16* yo = static_cast<__nv_bfloat16*>(y);
        return vec == 8 ? launch_plain(in_apply_split<__nv_bfloat16, 8>, grid, smem, st, xi, yo, ga, be,
                                       su, sf, B, S, C, P, rows, n, eps, relu)
                        : launch_plain(in_apply_split<__nv_bfloat16, 1>, grid, smem, st, xi, yo, ga, be,
                                       su, sf, B, S, C, P, rows, n, eps, relu);
    }
    const float* xi = static_cast<const float*>(x);
    float* yo = static_cast<float*>(y);
    return vec == 4 ? launch_plain(in_apply_split<float, 4>, grid, smem, st, xi, yo, ga, be, su, sf, B,
                                   S, C, P, rows, n, eps, relu)
                    : launch_plain(in_apply_split<float, 1>, grid, smem, st, xi, yo, ga, be, su, sf, B,
                                   S, C, P, rows, n, eps, relu);
}

// out [2, B, C] f32: sum g, sum g * xhat of this slab per (b, c), g the
// output gradient through the ReLU mask recomputed from x and stats.
extern "C" int mtta_instance_norm_bwd_sums(const void* gy, const void* x, const void* gamma,
                                           const void* beta, const void* stats, void* out, void* ws,
                                           int B, int S, int C, int is_bf16, int relu, int vec,
                                           int rows, int grid, int P, long long smem, int validate,
                                           void* stream) {
    if (gy == nullptr || x == nullptr || gamma == nullptr || beta == nullptr || stats == nullptr ||
        out == nullptr || ws == nullptr || smem < 0 || bad_split(B, S, C, is_bf16, vec, rows, grid, P)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    void* args[] = {&gy, &x, &gamma, &beta, &stats, &out, &ws, &B, &S, &C, &P, &rows, &relu};
    return launch_cooperative(split_sum_kernel(1, is_bf16, vec), grid, smem,
                              static_cast<cudaStream_t>(stream), validate, args);
}

// dx = rstd * gamma * (g - sum g / n - xhat * sum g xhat / n) from the global
// sums [2, B, C] of bwd_sums.
extern "C" int mtta_instance_norm_bwd_apply(const void* gy, const void* x, const void* gamma,
                                            const void* beta, const void* stats, const void* sums,
                                            void* dx, int B, int S, int C, int is_bf16, int relu,
                                            float n, int vec, int rows, int grid, int P,
                                            void* stream) {
    if (gy == nullptr || x == nullptr || gamma == nullptr || beta == nullptr || stats == nullptr ||
        sums == nullptr || dx == nullptr || !(n > 0.0f) ||
        bad_split(B, S, C, is_bf16, vec, rows, grid, P)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* ga = static_cast<const float*>(gamma);
    const float* be = static_cast<const float*>(beta);
    const float* sf = static_cast<const float*>(stats);
    const float* su = static_cast<const float*>(sums);
    if (is_bf16) {
        const __nv_bfloat16* gi = static_cast<const __nv_bfloat16*>(gy);
        const __nv_bfloat16* xi = static_cast<const __nv_bfloat16*>(x);
        __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dx);
        return vec == 8 ? launch_plain(in_bwd_apply_split<__nv_bfloat16, 8>, grid, 0, st, gi, xi, ga, be,
                                       sf, su, d, B, S, C, P, rows, n, relu)
                        : launch_plain(in_bwd_apply_split<__nv_bfloat16, 1>, grid, 0, st, gi, xi, ga, be,
                                       sf, su, d, B, S, C, P, rows, n, relu);
    }
    const float* gi = static_cast<const float*>(gy);
    const float* xi = static_cast<const float*>(x);
    float* d = static_cast<float*>(dx);
    return vec == 4 ? launch_plain(in_bwd_apply_split<float, 4>, grid, 0, st, gi, xi, ga, be, sf, su, d,
                                   B, S, C, P, rows, n, relu)
                    : launch_plain(in_bwd_apply_split<float, 1>, grid, 0, st, gi, xi, ga, be, sf, su, d,
                                   B, S, C, P, rows, n, relu);
}

// CTAs of stats (backward = 0) or bwd_sums (1) that one SM holds at `smem`
// dynamic bytes; negative: minus the CUDA error code.
extern "C" int mtta_instance_norm_split_ctas_per_sm(int backward, int is_bf16, int vec, long long smem) {
    const void* kernel = split_sum_kernel(backward, is_bf16, vec);
    if (kernel == nullptr || smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0;
    const int code = ctas_per_sm(kernel, static_cast<size_t>(smem), &per_sm);
    return code != 0 ? -code : per_sm;
}

// The runtime's text for an error code returned above.
extern "C" const char* mtta_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
