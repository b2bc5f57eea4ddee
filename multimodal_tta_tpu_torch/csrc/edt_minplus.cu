// Min-plus line transform for the exact euclidean distance transform:
//
//     g[r, i] = min_j ( f[r, j] + cost[j, i] ),   f [rows, n], cost [n, n], f32
//
// Replaces the TPU kernel multimodal_tta_tpu/pallas/edt_minplus.py
// (minplus_pallas / _minplus_kernel). One separable pass of the squared EDT
// per volume axis calls it with cost[j, i] = ((i - j) * spacing)^2.
//
// What bounds it on Hopper: a matrix product over the (min, +) semiring has
// no tensor-core form, so it is 2 * rows * n^2 f32 add/min instructions against
// only 4 * (2 * rows * n + n^2) bytes. At n = 144 the operations bound is
// 3.6x the byte bound; at n = 48 the two are about equal.
//
// Design: a block owns a 64 x 64 tile of g and walks j in slabs of 32. Each
// slab stages f[64 rows, 32 j] and cost[32 j, 64 i] in 16.6 KB of static
// shared memory (under the 48 KB static limit for any n), and each of the
// 256 threads keeps a 4 x 4 patch of outputs in registers: per j it reads
// four f values (warp broadcast) and one float4 of cost, and does 16 adds
// and 16 mins. Ragged edges are masked in the loads: f reads +inf and cost
// reads 0 outside the arrays, so inf + 0 = inf never wins a min and no
// padding copy is needed. +inf in f is data (an empty line), not an error:
// inf + finite = inf and fminf(inf, inf) = inf, so no NaN can arise while
// cost is finite; the file must be built without fast-math flags.
//
// The result is bitwise what a broadcast add followed by a min over j gives:
// every candidate is one f32 add, and min is exact in any order.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE_R = 64;   // rows of g per block
constexpr int TILE_I = 64;   // columns of g per block
constexpr int SLAB_J = 32;   // j values staged per step
constexpr int PATCH = 4;     // each thread owns PATCH x PATCH outputs
constexpr int THREADS = (TILE_R / PATCH) * (TILE_I / PATCH);  // 256

__global__ void __launch_bounds__(THREADS)
minplus_kernel(const float* __restrict__ f, const float* __restrict__ cost,
               float* __restrict__ g, long long rows, int n,
               long long f_stride, long long cost_stride, long long g_stride) {
    // +1 column: the 4 rows a thread reads and the 8 a warp reads fall in
    // different banks
    __shared__ float f_s[TILE_R][SLAB_J + 1];
    __shared__ __align__(16) float c_s[SLAB_J][TILE_I];

    const int tid = threadIdx.x;
    const int tx = tid % (TILE_I / PATCH);  // patch column
    const int ty = tid / (TILE_I / PATCH);  // patch row
    const long long r0 = static_cast<long long>(blockIdx.x) * TILE_R;
    const int i0 = blockIdx.y * TILE_I;

    float acc[PATCH][PATCH];
#pragma unroll
    for (int a = 0; a < PATCH; ++a)
#pragma unroll
        for (int b = 0; b < PATCH; ++b) acc[a][b] = CUDART_INF_F;

    for (int j0 = 0; j0 < n; j0 += SLAB_J) {
        for (int e = tid; e < TILE_R * SLAB_J; e += THREADS) {
            const int rr = e / SLAB_J, jj = e % SLAB_J;
            const long long r = r0 + rr;
            const int j = j0 + jj;
            f_s[rr][jj] = (r < rows && j < n) ? f[r * f_stride + j] : CUDART_INF_F;
        }
        for (int e = tid; e < SLAB_J * TILE_I; e += THREADS) {
            const int jj = e / TILE_I, ii = e % TILE_I;
            const int j = j0 + jj, i = i0 + ii;
            c_s[jj][ii] = (j < n && i < n) ? cost[static_cast<long long>(j) * cost_stride + i] : 0.0f;
        }
        __syncthreads();

#pragma unroll 8
        for (int jj = 0; jj < SLAB_J; ++jj) {
            const float4 c4 = *reinterpret_cast<const float4*>(&c_s[jj][tx * PATCH]);
            const float c[PATCH] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int a = 0; a < PATCH; ++a) {
                const float fv = f_s[ty * PATCH + a][jj];
#pragma unroll
                for (int b = 0; b < PATCH; ++b) acc[a][b] = fminf(acc[a][b], fv + c[b]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < PATCH; ++a) {
        const long long r = r0 + ty * PATCH + a;
        if (r >= rows) continue;
#pragma unroll
        for (int b = 0; b < PATCH; ++b) {
            const int i = i0 + tx * PATCH + b;
            if (i < n) g[r * g_stride + i] = acc[a][b];
        }
    }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Pointers are device pointers to f32; strides are in
// elements between consecutive rows. Does not synchronise.
extern "C" int mtta_minplus_f32(const void* f, const void* cost, void* g,
                                long long rows, int n, long long f_stride,
                                long long cost_stride, long long g_stride,
                                void* stream) {
    if (f == nullptr || cost == nullptr || g == nullptr || rows <= 0 || n <= 0 ||
        f_stride < n || cost_stride < n || g_stride < n) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long row_blocks = (rows + TILE_R - 1) / TILE_R;
    if (row_blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(row_blocks),
                    static_cast<unsigned>((n + TILE_I - 1) / TILE_I));
    if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
    minplus_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(f), static_cast<const float*>(cost),
        static_cast<float*>(g), rows, n, f_stride, cost_stride, g_stride);
    return static_cast<int>(cudaGetLastError());
}

// The runtime's text for an error code returned above.
extern "C" const char* mtta_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
