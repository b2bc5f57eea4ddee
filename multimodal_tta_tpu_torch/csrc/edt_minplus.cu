// Min-plus line transforms for the exact euclidean distance transform:
//
//     g[r, i] = min_j ( f[r, j] + cost[j, i] ),   f32
//
// Replaces the TPU kernel multimodal_tta_tpu/pallas/edt_minplus.py
// (minplus_pallas / _minplus_kernel). Two entry points share one inner loop:
//
//   * mtta_edt_volumes: the squared EDT of V volumes [V, D, H, W] in ONE
//     launch. Three passes (axis D, H, W, in the reference's order) run on a
//     persistent cooperative grid with a grid barrier between them. The cost
//     is cost[j, i] = ((i - j) * spacing)^2, read from a table of n floats
//     that every block builds in shared memory; the first pass reads the
//     {0,1} byte mask itself (1 -> 0, 0 -> +inf), the later ones work in place
//     on the output (16 MB for four 48x144x144 volumes: it stays in the L2),
//     and the last may write the square root.
//   * mtta_minplus_f32: the TPU kernel's function, f [rows, n] against an
//     arbitrary finite cost matrix [n, n], which every warp reads through
//     the L1 (measured faster than a copy staged in shared memory per block:
//     no staging, and more blocks fit an SM).
//
// What bounds it on Hopper: a product over the (min, +) semiring has no
// tensor-core form, so it is 2 * rows * n^2 f32 add/min instructions against
// 8 * rows * n bytes; at n = 144 the operations bound is 3.6x the byte bound.
// The design is therefore about instruction slots:
//
//   * A block owns WHOLE lines (all n outputs of R lines), so j needs no
//     slab loop, nothing is recomputed at a tile edge and a pass can write in
//     place. The tile of f lies in dynamic shared memory as [n j][R rows]
//     (the transposed layout the TPU kernel also chose).
//   * A thread keeps 8 rows x 6 columns of outputs in registers: 48
//     independent min chains. Per 4 values of j it reads 8 float4 of f and 5
//     float2 of the cost table (a window of 9 entries that slides by one per
//     j) for 192 adds and 192 candidates to take the min of: 3 to 4 shared
//     loads per 100 arithmetic instructions. A warp is 4 lanes along r and
//     8 lanes along i: it covers 32 rows x 48 columns. n = 48 is one column
//     group and n = 144 three, so no column and no j is wasted there, a tile
//     of 32 lines is small enough to spread evenly over the SMs, and five
//     blocks of three warps share an SM, one's loads under another's
//     arithmetic. Any other n is padded to the next multiple of 48 inside
//     shared memory (+inf in f, never stored).
//   * Lines are addressed where they lie. For axis D and H the R rows of a
//     tile are neighbouring voxels along W (contiguous: 16-byte loads and
//     stores along r), and j strides by H*W or W. For axis W a line is
//     contiguous and is transposed on its way into shared memory; the row
//     stride R + 4 keeps those stores free of bank conflicts. No copy of the
//     volume is made for any axis.
//   * Tiles are handed out by an atomic counter per pass, so that blocks
//     sharing an SM balance; several blocks per SM overlap one block's loads
//     with another's arithmetic.
//   * The EDT's mins are integer mins. An add and a min cannot fuse, and on
//     this card the pair runs at 28.8 T/s in a register-only probe (the
//     data sheet's f32 rate would allow 33.5). In the EDT every value is a
//     non-negative float (0, a sum of squares or +inf; never NaN or -0), and
//     such floats order as their bit patterns do as signed integers, so one
//     three-input integer min (__vimin3_s32, VIMNMX3) takes two candidates:
//     three instructions for two candidates instead of four. The general
//     entry keeps fminf, since a cost matrix may hold negative entries.
//
// The result is bitwise what a broadcast add followed by a min over j gives:
// every candidate is one f32 add (__fadd_rn, never contracted), the table is
// built with __fmul_rn exactly as ((i - j) * spacing) ** 2 rounds, and a min
// is exact in any order. +inf in f is data (an empty line): inf + finite =
// inf and min(inf, inf) = inf, so no NaN can arise while cost is finite.
// The file must be built without fast-math flags.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int COLS = 6;          // output columns per thread
constexpr int ROWS = 8;          // output rows per thread, as two quads
constexpr int LR = 4;            // lanes of a warp along r
constexpr int LI = 32 / LR;      // lanes of a warp along i
constexpr int WROWS = LR * ROWS; // rows one warp covers: 32
constexpr int WCOLS = LI * COLS; // columns one warp covers: 48
constexpr int TILE_PAD = 4;      // tile row stride = R + TILE_PAD floats
constexpr int MAX_THREADS = 512; // 128 registers a thread: the 48 accumulators fit unspilled
constexpr int MAX_PASSES = 3;
constexpr int MAX_DEVICES = 64;

constexpr int COST_TABLE = 0;   // ((i - j) * spacing)^2 from a table in shared memory
constexpr int COST_MATRIX = 1;  // a cost matrix [n, n] read from device memory

constexpr int LINES_STRIDED = 0;     // rows contiguous in memory, j strided
constexpr int LINES_CONTIGUOUS = 1;  // each line contiguous, rows `pitch` apart

// One pass over `lines` lines of n samples. Mirrored by a ctypes.Structure in
// kernels/edt_minplus.py: keep the field order.
struct Pass {
    long long lines;    // number of lines
    long long inner;    // strided: lines per contiguous run of rows
    long long pitch;    // strided: elements between runs; contiguous: between lines
    long long jstride;  // elements between consecutive samples of a line
    long long tiles;    // ceil(lines / R)
    int n;              // samples per line
    int row_groups;     // RG: R = RG * 32 rows per tile
    int kind;           // LINES_*
    int cost_mode;      // COST_*
    int src_is_mask;    // the source is bytes: != 0 -> 0.0f, 0 -> +inf
    int vec;            // 16-byte loads and stores are aligned
    int sqrt_out;       // store sqrt(g)
    float spacing;      // COST_TABLE: the axis' voxel spacing
};

struct Params {
    const void* src;     // first pass: the mask bytes or f
    float* dst;          // every pass writes here; later passes also read it
    const float* cost;   // [n, n], COST_MATRIX
    unsigned* counters;  // [MAX_PASSES + 1], zero between launches
    int npass;
    Pass pass[MAX_PASSES];
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one pass: row bases, the cost area, the tile.
__host__ __device__ inline long long pass_smem_bytes(const Pass& p) {
    const int rows = p.row_groups * WROWS;
    const int nj = round_up(p.n, 4);
    const int np = round_up(p.n, WCOLS);
    const long long cost_floats = p.cost_mode == COST_TABLE ? nj + np : 0;
    return 8LL * rows + 4 * cost_floats + 4LL * nj * (rows + TILE_PAD);
}

__device__ __forceinline__ float4 inf4() {
    return make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
}

__device__ __forceinline__ float mask_value(unsigned char m) { return m ? 0.0f : CUDART_INF_F; }

// ---- one pass: the block walks tiles handed out by `counter` ---------------

template <int COST>
__device__ void run_pass(const Pass& p, const void* src, float* dst, const float* cost,
                         unsigned* counter, unsigned char* smem) {
    __shared__ unsigned s_tile;

    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nthreads >> 5;
    const int n = p.n;
    const int nj = round_up(n, 4);
    const int np = round_up(n, WCOLS);
    const int n_ig = np / WCOLS;
    const int rg_count = p.row_groups;
    const int R = rg_count * WROWS;
    const int RS = R + TILE_PAD;
    const long long jstride = p.jstride;

    long long* rbase = reinterpret_cast<long long*>(smem);
    float* cost_s = reinterpret_cast<float*>(smem + 8LL * R);
    float* tile = cost_s + (COST == COST_TABLE ? nj + np : 0);

    // the cost, once per pass and block
    if (COST == COST_TABLE) {
        // table[off + k] = (|k| * spacing)^2 for k = i - j; off = nj - 1 makes
        // every window start of the inner loop even: 8-byte aligned
        const int off = nj - 1;
        for (int k = tid; k < nj + np; k += nthreads) {
            const int d = k - off;
            const float x = __fmul_rn(static_cast<float>(d < 0 ? -d : d), p.spacing);
            cost_s[k] = __fmul_rn(x, x);
        }
    }

    const float* srcf = static_cast<const float*>(src);
    const unsigned char* srcb = static_cast<const unsigned char*>(src);
    const bool is_mask = p.src_is_mask != 0;
    const bool vec = p.vec != 0;

    // this thread's outputs: rows rq0 + a and rq1 + a (a < 4), columns i0 + b
    const int lr = lane % LR;
    const int li = lane / LR;

    for (;;) {
        if (tid == 0) s_tile = atomicAdd(counter, 1u);
        __syncthreads();  // also: every thread is done with the tile before
        const long long t = s_tile;
        if (t >= p.tiles) break;
        const long long row0 = t * R;

        for (int r = tid; r < R; r += nthreads) {
            const long long rho = row0 + r;
            long long b = -1;
            if (rho < p.lines) {
                b = p.kind == LINES_STRIDED ? (rho / p.inner) * p.pitch + rho % p.inner
                                            : rho * p.pitch;
            }
            rbase[r] = b;
        }
        __syncthreads();

        // ---- load the tile as [j][r]; +inf outside the lines and beyond n --
        if (p.kind == LINES_STRIDED) {
            if (vec) {  // four neighbouring rows per 16-byte (mask: 4-byte) load
                const int quads = R / 4;
                for (int e = tid; e < quads * nj; e += nthreads) {
                    const int j = e / quads, q = e - j * quads;
                    const long long b = rbase[4 * q];
                    float4 v = inf4();
                    if (j < n && b >= 0) {
                        const long long at = b + j * jstride;
                        if (is_mask) {
                            const uchar4 m = *reinterpret_cast<const uchar4*>(srcb + at);
                            v = make_float4(mask_value(m.x), mask_value(m.y), mask_value(m.z),
                                            mask_value(m.w));
                        } else {
                            v = *reinterpret_cast<const float4*>(srcf + at);
                        }
                    }
                    *reinterpret_cast<float4*>(tile + j * RS + 4 * q) = v;
                }
            } else {
                for (int e = tid; e < R * nj; e += nthreads) {
                    const int j = e / R, r = e - j * R;
                    const long long b = rbase[r];
                    float v = CUDART_INF_F;
                    if (j < n && b >= 0) {
                        const long long at = b + j * jstride;
                        v = is_mask ? mask_value(srcb[at]) : srcf[at];
                    }
                    tile[j * RS + r] = v;
                }
            }
        } else {
            if (vec) {
                // a warp reads 16 rows x 2 quads of j: 32-byte runs in memory,
                // and its four transposed stores hit 32 different banks
                const int r16 = R / 16;
                const int items = r16 * ((nj / 4 + 1) / 2) * 32;
                for (int e = tid; e < items; e += nthreads) {
                    const int rest = e >> 5;
                    const int r = (rest % r16) * 16 + (e & 15);
                    const int jq = (rest / r16) * 2 + ((e >> 4) & 1);
                    if (4 * jq >= nj) continue;
                    const long long b = rbase[r];
                    float4 v = inf4();
                    if (b >= 0) {
                        const long long at = b + 4 * jq;
                        if (is_mask) {
                            const uchar4 m = *reinterpret_cast<const uchar4*>(srcb + at);
                            v = make_float4(mask_value(m.x), mask_value(m.y), mask_value(m.z),
                                            mask_value(m.w));
                        } else {
                            v = *reinterpret_cast<const float4*>(srcf + at);
                        }
                    }
                    float* o = tile + 4 * jq * RS + r;
                    o[0] = v.x;
                    o[RS] = v.y;
                    o[2 * RS] = v.z;
                    o[3 * RS] = v.w;
                }
            } else {
                // a warp reads 4 rows x 8 samples: conflict-free transposed stores
                const int r4 = R / 4;
                const int items = r4 * ((nj + 7) / 8) * 32;
                for (int e = tid; e < items; e += nthreads) {
                    const int rest = e >> 5;
                    const int r = (rest % r4) * 4 + ((e >> 3) & 3);
                    const int j = (rest / r4) * 8 + (e & 7);
                    if (j >= nj) continue;
                    const long long b = rbase[r];
                    float v = CUDART_INF_F;
                    if (j < n && b >= 0) {
                        const long long at = b + j;
                        v = is_mask ? mask_value(srcb[at]) : srcf[at];
                    }
                    tile[j * RS + r] = v;
                }
            }
        }
        __syncthreads();

        // ---- every warp takes (row group, column group) pairs ---------------
        for (int unit = warp; unit < rg_count * n_ig; unit += nwarps) {
            const int rg = unit / n_ig;
            const int ig = unit - rg * n_ig;
            const int rq0 = rg * WROWS + 4 * lr;
            const int rq1 = rq0 + 4 * LR;
            const int i0 = ig * WCOLS + li * COLS;

            float acc[ROWS][COLS];
#pragma unroll
            for (int a = 0; a < ROWS; ++a)
#pragma unroll
                for (int b = 0; b < COLS; ++b) acc[a][b] = CUDART_INF_F;

            if (COST == COST_TABLE) {
                const float* frow = tile + rq0;
                // window of chunk j0: table[off + i0 - j0 - 3 ...], COLS + 3 floats
                // (i0 is even and off - 3 a multiple of 4: 8-byte aligned)
                const float* win = cost_s + (nj - 1) + i0 - 3;
#pragma unroll 1
                for (int j0 = 0; j0 < nj; j0 += 4) {
                    float w[COLS + 4];
                    {
                        const float2* wp = reinterpret_cast<const float2*>(win - j0);
#pragma unroll
                        for (int k = 0; k < (COLS + 4) / 2; ++k) {
                            const float2 v = wp[k];
                            w[2 * k] = v.x;
                            w[2 * k + 1] = v.y;
                        }
                    }
                    // two candidates per min: every value here is a non-negative
                    // float (never NaN, never -0), and those order as their bits do
                    // as signed integers, so one three-input integer min takes both
#pragma unroll
                    for (int jj = 0; jj < 4; jj += 2) {
                        const float* fp = frow + (j0 + jj) * RS;
                        const float4 lo = *reinterpret_cast<const float4*>(fp);
                        const float4 hi = *reinterpret_cast<const float4*>(fp + 4 * LR);
                        const float4 lo2 = *reinterpret_cast<const float4*>(fp + RS);
                        const float4 hi2 = *reinterpret_cast<const float4*>(fp + RS + 4 * LR);
                        const float f[ROWS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
                        const float g[ROWS] = {lo2.x, lo2.y, lo2.z, lo2.w, hi2.x, hi2.y, hi2.z, hi2.w};
#pragma unroll
                        for (int a = 0; a < ROWS; ++a)
#pragma unroll
                            for (int b = 0; b < COLS; ++b)
                                acc[a][b] = __int_as_float(__vimin3_s32(
                                    __float_as_int(acc[a][b]),
                                    __float_as_int(__fadd_rn(f[a], w[3 - jj + b])),
                                    __float_as_int(__fadd_rn(g[a], w[2 - jj + b]))));
                    }
                }
            } else {
                const float* frow = tile + rq0;
#pragma unroll 2
                for (int j = 0; j < n; ++j) {
                    float c[COLS];
                    const float* cp = cost + static_cast<long long>(j) * n + i0;
#pragma unroll
                    for (int b = 0; b < COLS; ++b) c[b] = (i0 + b < n) ? __ldg(cp + b) : 0.0f;
                    const float* fp = frow + j * RS;
                    const float4 lo = *reinterpret_cast<const float4*>(fp);
                    const float4 hi = *reinterpret_cast<const float4*>(fp + 4 * LR);
                    const float f[ROWS] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
                    for (int a = 0; a < ROWS; ++a)
#pragma unroll
                        for (int b = 0; b < COLS; ++b)
                            acc[a][b] = fminf(acc[a][b], __fadd_rn(f[a], c[b]));
                }
            }

            if (p.sqrt_out) {
#pragma unroll
                for (int a = 0; a < ROWS; ++a)
#pragma unroll
                    for (int b = 0; b < COLS; ++b) acc[a][b] = __fsqrt_rn(acc[a][b]);
            }

            // ---- store: the block owns these lines, so in place is safe ----
            if (p.kind == LINES_STRIDED) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int rq = h ? rq1 : rq0;
                    if (vec) {
                        const long long b = rbase[rq];
                        if (b < 0) continue;
#pragma unroll
                        for (int c = 0; c < COLS; ++c) {
                            if (i0 + c >= n) break;
                            *reinterpret_cast<float4*>(dst + b + (i0 + c) * jstride) = make_float4(
                                acc[4 * h][c], acc[4 * h + 1][c], acc[4 * h + 2][c], acc[4 * h + 3][c]);
                        }
                    } else {
#pragma unroll
                        for (int a = 0; a < 4; ++a) {
                            const long long b = rbase[rq + a];
                            if (b < 0) continue;
#pragma unroll
                            for (int c = 0; c < COLS; ++c)
                                if (i0 + c < n) dst[b + (i0 + c) * jstride] = acc[4 * h + a][c];
                        }
                    }
                }
            } else {
#pragma unroll
                for (int a = 0; a < ROWS; ++a) {
                    const long long b = rbase[(a < 4 ? rq0 : rq1) + (a & 3)];
                    if (b < 0) continue;
                    float* o = dst + b + i0;
                    if (vec) {  // n and i0 are even: a pair of columns is whole or absent
#pragma unroll
                        for (int c = 0; c < COLS; c += 2)
                            if (i0 + c < n)
                                *reinterpret_cast<float2*>(o + c) = make_float2(acc[a][c], acc[a][c + 1]);
                    } else {
#pragma unroll
                        for (int c = 0; c < COLS; ++c)
                            if (i0 + c < n) o[c] = acc[a][c];
                    }
                }
            }
        }
    }
}

// The last block to finish puts the counters back to zero for the next launch
// on this workspace (launches that share one run in stream order).
__device__ __forceinline__ void release_counters(unsigned* counters) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        const unsigned done = atomicAdd(&counters[MAX_PASSES], 1u);
        if (done == gridDim.x - 1) {
#pragma unroll
            for (int k = 0; k <= MAX_PASSES; ++k) counters[k] = 0u;
            __threadfence();
        }
    }
}

// All passes of the squared EDT of V volumes: cooperative, persistent.
__global__ void __launch_bounds__(MAX_THREADS, 1) minplus_edt_kernel(const Params prm) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::grid_group grid = cg::this_grid();
    for (int k = 0; k < prm.npass; ++k) {
        if (k > 0) grid.sync();  // pass k reads what every block wrote in pass k - 1
        run_pass<COST_TABLE>(prm.pass[k], k == 0 ? prm.src : prm.dst, prm.dst, nullptr,
                             &prm.counters[k], smem);
    }
    release_counters(prm.counters);
}

// One pass against a cost matrix: the TPU kernel's function.
__global__ void __launch_bounds__(MAX_THREADS, 1) minplus_matrix_kernel(const Params prm) {
    extern __shared__ __align__(16) unsigned char smem[];
    run_pass<COST_MATRIX>(prm.pass[0], prm.src, prm.dst, prm.cost, &prm.counters[0], smem);
    release_counters(prm.counters);
}

// Register-only probe of the add/min instruction rate: 32 independent chains a
// thread, no memory in the loop. mode 0: acc = fminf(acc, x + c), the general
// entry's pair; mode 1: one three-input integer min per two adds, the EDT's
// inner loop.
constexpr int PROBE_CHAINS = 32;

__global__ void __launch_bounds__(256) minplus_probe_kernel(float* out, int iters, int mode) {
    float acc[PROBE_CHAINS];
    const float seed = static_cast<float>(threadIdx.x & 15) * 0.0625f;
#pragma unroll
    for (int k = 0; k < PROBE_CHAINS; ++k) acc[k] = seed + static_cast<float>(k + 1);
    const float c0 = out[0], c1 = out[1];  // 0.0f and 0.0f at run time, unknown to the compiler
    if (mode == 0) {
        for (int it = 0; it < iters; ++it) {
#pragma unroll
            for (int k = 0; k < PROBE_CHAINS; ++k)
                acc[k] = fminf(acc[k], __fadd_rn(acc[(k + 1) % PROBE_CHAINS], c0));
        }
    } else {
        for (int it = 0; it < iters; ++it) {
#pragma unroll
            for (int k = 0; k < PROBE_CHAINS; ++k) {
                const int a = __float_as_int(__fadd_rn(acc[(k + 1) % PROBE_CHAINS], c0));
                const int b = __float_as_int(__fadd_rn(acc[(k + 2) % PROBE_CHAINS], c1));
                acc[k] = __int_as_float(__vimin3_s32(__float_as_int(acc[k]), a, b));
            }
        }
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < PROBE_CHAINS; ++k) s += acc[k];
    if (s == -1.0f) out[2] = s;  // never true: keeps the chains alive
}

// ==== host side =============================================================

constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

const void* kernel_of(int matrix) {
    return matrix ? reinterpret_cast<const void*>(&minplus_matrix_kernel)
                  : reinterpret_cast<const void*>(&minplus_edt_kernel);
}

// Raise the kernel's dynamic shared memory limit to `smem` on this device
// (never lower it: an earlier plan may need more).
int allow_smem(int matrix, size_t smem) {
    static size_t allowed[2][MAX_DEVICES] = {};
    if (smem <= STATIC_SMEM_LIMIT) return 0;
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 0 || device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (smem <= allowed[matrix][device]) return 0;
    e = cudaFuncSetAttribute(kernel_of(matrix), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[matrix][device] = smem;
    return 0;
}

int blocks_per_sm(int matrix, int threads, size_t smem, int* out) {
    const int code = allow_smem(matrix, smem);
    if (code != 0) return code;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel_of(matrix), threads, smem));
}

bool bad_pass(const Pass& p, int threads, long long smem) {
    if (p.lines <= 0 || p.n <= 0 || p.tiles <= 0 || p.tiles > 0x7fffffffLL || p.row_groups < 1 ||
        p.pitch <= 0 || p.jstride <= 0)
        return true;
    if (p.kind == LINES_STRIDED ? p.inner <= 0 : (p.kind != LINES_CONTIGUOUS || p.jstride != 1))
        return true;
    if (p.cost_mode != COST_TABLE && p.cost_mode != COST_MATRIX) return true;
    const long long rows = static_cast<long long>(p.row_groups) * WROWS;
    if (p.tiles != (p.lines + rows - 1) / rows) return true;
    if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0) return true;
    return pass_smem_bytes(p) > smem;
}

int launch(int matrix, Params& prm, int threads, int grid, long long smem, int validate,
           cudaStream_t stream) {
    if (grid < 1 || smem < 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < prm.npass; ++k)
        if (bad_pass(prm.pass[k], threads, smem)) return static_cast<int>(cudaErrorInvalidValue);
    int code = allow_smem(matrix, static_cast<size_t>(smem));
    if (code != 0) return code;
    if (matrix) {
        // one pass, no grid barrier: a plain launch will do
        minplus_matrix_kernel<<<grid, threads, static_cast<size_t>(smem), stream>>>(prm);
        return static_cast<int>(cudaGetLastError());
    }
    if (validate) {
        // every block must be resident at once, or the grid barrier never completes
        int per_sm = 0, device = 0, sms = 0;
        code = blocks_per_sm(matrix, threads, static_cast<size_t>(smem), &per_sm);
        if (code != 0) return code;
        cudaError_t e = cudaGetDevice(&device);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (grid > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    }
    void* args[] = {&prm};
    const cudaError_t e = cudaLaunchCooperativeKernel(kernel_of(0), dim3(grid), dim3(threads), args,
                                                      static_cast<size_t>(smem), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All launchers enqueue on `stream`, do not synchronise, and return 0 or the
// CUDA error of the refused launch. `counters` is a zeroed workspace of four
// unsigned ints that launches on one stream may share; `validate` != 0 adds
// the check that the EDT's cooperative grid is co-resident (asked for at a
// plan's first use).

// The squared EDT of V volumes: `points` [V, D, H, W] bytes (!= 0 marks a
// point), `out` [V, D, H, W] f32, `passes` the three passes in axis order.
extern "C" int mtta_edt_volumes(const void* points, void* out, void* counters,
                                const void* passes, int npass, int threads, int grid,
                                long long smem, int validate, void* stream) {
    if (points == nullptr || out == nullptr || counters == nullptr || passes == nullptr ||
        npass < 1 || npass > MAX_PASSES)
        return static_cast<int>(cudaErrorInvalidValue);
    Params prm = {};
    prm.src = points;
    prm.dst = static_cast<float*>(out);
    prm.counters = static_cast<unsigned*>(counters);
    prm.npass = npass;
    for (int k = 0; k < npass; ++k) {
        prm.pass[k] = static_cast<const Pass*>(passes)[k];
        if (prm.pass[k].cost_mode != COST_TABLE || (prm.pass[k].src_is_mask != 0) != (k == 0))
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch(0, prm, threads, grid, smem, validate, static_cast<cudaStream_t>(stream));
}

// g[r, i] = min_j f[r, j] + cost[j, i]: f, g [rows, n] f32 with contiguous
// lines, cost [n, n] f32 contiguous, `pass` the one pass (npass must be 1).
extern "C" int mtta_minplus_f32(const void* f, const void* cost, void* g, void* counters,
                                const void* pass, int npass, int threads, int grid,
                                long long smem, int validate, void* stream) {
    if (f == nullptr || cost == nullptr || g == nullptr || counters == nullptr ||
        pass == nullptr || npass != 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Params prm = {};
    prm.src = f;
    prm.dst = static_cast<float*>(g);
    prm.cost = static_cast<const float*>(cost);
    prm.counters = static_cast<unsigned*>(counters);
    prm.npass = 1;
    prm.pass[0] = *static_cast<const Pass*>(pass);
    if (prm.pass[0].cost_mode != COST_MATRIX || prm.pass[0].src_is_mask || prm.pass[0].sqrt_out)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch(1, prm, threads, grid, smem, validate, static_cast<cudaStream_t>(stream));
}

// Blocks of the kernel (matrix: 0 the EDT's, 1 the cost-matrix one) that one
// SM holds at `threads` threads and `smem` dynamic bytes; negative: minus the
// CUDA error code.
extern "C" int mtta_minplus_blocks_per_sm(int matrix, int threads, long long smem) {
    if ((matrix != 0 && matrix != 1) || threads < 32 || threads > MAX_THREADS || smem < 0)
        return -static_cast<int>(cudaErrorInvalidValue);
    int per_sm = 0;
    const int code = blocks_per_sm(matrix, threads, static_cast<size_t>(smem), &per_sm);
    return code != 0 ? -code : per_sm;
}

// The size of struct Pass, for the binding to check its mirror against.
extern "C" int mtta_minplus_pass_bytes() { return static_cast<int>(sizeof(Pass)); }

// The instruction-rate probe: `blocks` x 256 threads, each `iters` times 32 chains of
// one add and one min (mode 0) or two adds and one three-input min (mode 1).
// `out` holds at least three zeroed floats.
extern "C" int mtta_minplus_probe(void* out, int blocks, int iters, int mode, void* stream) {
    if (out == nullptr || blocks < 1 || iters < 1 || (mode != 0 && mode != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    minplus_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(out), iters, mode);
    return static_cast<int>(cudaGetLastError());
}

// The runtime's text for an error code returned above.
extern "C" const char* mtta_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
