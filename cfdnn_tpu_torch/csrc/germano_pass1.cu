// germano_pass1: pass 1 of the dynamic Smagorinsky model. Per cell, the
// strain magnitude |S| and the Germano products
//     L:M = sum_ab w_ab L_ab M_ab,   M:M = sum_ab w_ab M_ab M_ab
// (w = 1 on the diagonal, 2 off it; L_ab = box(u_a u_b) - box(u_a) box(u_b)
// of the cell-centre velocity at the 3-point test filter, M_ab =
// 3 Delta^2 |S| S_ab), and their sums over each (x, z) plane.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_germano_pass1 (body
// _germano_pass1_kernel, which accumulates the plane sums across its
// sequential x-slab grid in the field dtype). The plain PyTorch twin is
// ops/kernels.py germano_pass1_twin (turbulence/les.py germano_products,
// then the plane sums in float64). The clip of Cs^2 and nu = Cs^2 Delta^2
// |S| stay plain torch on the (1, Ny, 1) profiles, as in the reference.
//
// Test filter (les.py _box_filter_batch): separable 3-point box, x first,
// then y, then z; periodic axes wrap, a wall y truncates and divides by the
// in-domain weight (18 in the wall rows, 27 elsewhere). Reach: two cells
// in x and z (one for the filter, one for the face-to-centre average).
//
// Bound on the H100: arithmetic and L1/L2 traffic rather than device
// memory: each cell reads the 27 cells of its filter stencil (about 160
// loads, nearly all cache hits) and does ~600 flops, while only |S| is
// written back. Design: one thread per cell; a block holds 256 cells of one
// (x, z) plane (blockIdx.y is the row j), reduces its cells' L:M and M:M in
// float64 shared memory in a fixed tree order, and writes one partial per
// block. A second small kernel sums each row's partials in block order and
// casts to the field dtype. No atomics: a run repeats bit for bit, and the
// plane sums are never accumulated in float32.
#include "les.cuh"

namespace {

using cfdnn::LesGrid;
using cfdnn::kBlock;

template <typename T>
__global__ void germano_cells_kernel(LesGrid<T> g, const T* __restrict__ delta,
                                     T* __restrict__ smag,
                                     double* __restrict__ partial) {
    __shared__ double s_lm[kBlock];
    __shared__ double s_mm[kBlock];
    const int nx = g.nx, ny = g.ny, nz = g.nz;
    const int j = blockIdx.y;
    const int t = threadIdx.x;
    const long long p = static_cast<long long>(blockIdx.x) * kBlock + t;
    T lm = T(0), mm = T(0);
    if (p < static_cast<long long>(nx) * nz) {
        const int i = static_cast<int>(p / nz);
        const int k = static_cast<int>(p % nz);
        T G[3][3], S[3][3];
        g.gradient(i, j, k, G);
        const T sm = cfdnn::strain(G, S);
        smag[cfdnn::at3(i, j, k, ny, nz)] = sm;
        const T dl = delta[static_cast<long long>(j) * nz + k];
        const T fac = T(3) * dl * dl * sm;
        // box filter of (u, v, w, uu, uv, uw, vv, vw, ww) at the cell
        // centres, summed x-innermost as the separable filter sums
        T fz[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) fz[q] = T(0);
        for (int dk = -1; dk <= 1; ++dk) {
            const int kk = dk < 0 ? cfdnn::wrap_m(k, nz)
                                  : (dk > 0 ? cfdnn::wrap_p(k, nz) : k);
            T fy[9];
#pragma unroll
            for (int q = 0; q < 9; ++q) fy[q] = T(0);
            for (int dj = -1; dj <= 1; ++dj) {
                int jj = j + dj;
                if (jj < 0 || jj >= ny) {
                    if (g.wall_y) continue;   // truncated at the wall
                    jj = jj < 0 ? ny - 1 : 0;
                }
                T fx[9];
#pragma unroll
                for (int q = 0; q < 9; ++q) fx[q] = T(0);
                for (int di = -1; di <= 1; ++di) {
                    const int ii = di < 0 ? cfdnn::wrap_m(i, nx)
                                          : (di > 0 ? cfdnn::wrap_p(i, nx) : i);
                    T c[3];
                    g.centre(ii, jj, kk, c);
                    fx[0] = fx[0] + c[0];
                    fx[1] = fx[1] + c[1];
                    fx[2] = fx[2] + c[2];
                    fx[3] = fx[3] + c[0] * c[0];
                    fx[4] = fx[4] + c[0] * c[1];
                    fx[5] = fx[5] + c[0] * c[2];
                    fx[6] = fx[6] + c[1] * c[1];
                    fx[7] = fx[7] + c[1] * c[2];
                    fx[8] = fx[8] + c[2] * c[2];
                }
#pragma unroll
                for (int q = 0; q < 9; ++q) fy[q] = fy[q] + fx[q];
            }
#pragma unroll
            for (int q = 0; q < 9; ++q) fz[q] = fz[q] + fy[q];
        }
        const T wgt = (g.wall_y && (j == 0 || j == ny - 1)) ? T(18) : T(27);
        T ub[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) ub[a] = fz[a] / wgt;
        // pairs (0,0) (0,1) (0,2) (1,1) (1,2) (2,2), in the twin's order
        int q = 3;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = a; b < 3; ++b, ++q) {
                const T w2 = a == b ? T(1) : T(2);
                const T L = fz[q] / wgt - ub[a] * ub[b];
                const T M = fac * S[a][b];
                lm = lm + w2 * L * M;
                mm = mm + w2 * M * M;
            }
    }
    s_lm[t] = static_cast<double>(lm);
    s_mm[t] = static_cast<double>(mm);
    __syncthreads();
    for (int s = kBlock / 2; s > 0; s >>= 1) {
        if (t < s) {
            s_lm[t] += s_lm[t + s];
            s_mm[t] += s_mm[t + s];
        }
        __syncthreads();
    }
    if (t == 0) {
        const long long nb = gridDim.x;
        partial[static_cast<long long>(j) * nb + blockIdx.x] = s_lm[0];
        partial[(static_cast<long long>(ny) + j) * nb + blockIdx.x] = s_mm[0];
    }
}

// lm[j] (q = 0) and mm[j] (q = 1): the row's partials summed in block order
template <typename T>
__global__ void germano_rows_kernel(const double* __restrict__ partial,
                                    T* __restrict__ lm, T* __restrict__ mm,
                                    int ny, int nb) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;   // q * ny + j
    if (r >= 2 * ny) return;
    double acc = 0.0;
    for (int b = 0; b < nb; ++b) acc += partial[static_cast<long long>(r) * nb + b];
    (r < ny ? lm : mm)[r % ny] = static_cast<T>(acc);
}

// the blocks of one row, and so the partials per row of `partial`
int row_blocks(int nx, int nz) {
    return static_cast<int>(cfdnn::blocks_for(static_cast<long long>(nx) * nz));
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* inv_dx,
           const void* inv_dy, const void* inv_dz, const void* den_x,
           const void* den_y, const void* den_z, const void* delta,
           void* smag, void* partial, void* lm, void* mm,
           int nx, int ny, int nz, int wall_y, int n_partial, void* stream) {
    const LesGrid<T> g{static_cast<const T*>(u), static_cast<const T*>(v),
                       static_cast<const T*>(w), static_cast<const T*>(inv_dx),
                       static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
                       static_cast<const T*>(den_x), static_cast<const T*>(den_y),
                       static_cast<const T*>(den_z), nx, ny, nz, wall_y,
                       /*wall_z=*/0};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // `partial` is (2, ny, n_partial), sized by cfdnn_germano_pass1_blocks
    const int nb = row_blocks(nx, nz);
    if (n_partial != nb) return static_cast<int>(cudaErrorInvalidValue);
    germano_cells_kernel<T><<<dim3(nb, ny), kBlock, 0, s>>>(
        g, static_cast<const T*>(delta), static_cast<T*>(smag),
        static_cast<double*>(partial));
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    germano_rows_kernel<T><<<cfdnn::blocks_for(2LL * ny), kBlock, 0, s>>>(
        static_cast<const double*>(partial), static_cast<T*>(lm),
        static_cast<T*>(mm), ny, nb);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The length of the last axis of `partial` for an nx x nz plane.
extern "C" int cfdnn_germano_pass1_blocks(int nx, int nz) {
    return row_blocks(nx, nz);
}

extern "C" int cfdnn_germano_pass1_f32(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta,
        void* smag, void* partial, void* lm, void* mm,
        int nx, int ny, int nz, int wall_y, int n_partial, void* stream) {
    return launch<float>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y, den_z,
                         delta, smag, partial, lm, mm, nx, ny, nz, wall_y,
                         n_partial, stream);
}

extern "C" int cfdnn_germano_pass1_f64(
        const void* u, const void* v, const void* w, const void* inv_dx,
        const void* inv_dy, const void* inv_dz, const void* den_x,
        const void* den_y, const void* den_z, const void* delta,
        void* smag, void* partial, void* lm, void* mm,
        int nx, int ny, int nz, int wall_y, int n_partial, void* stream) {
    return launch<double>(u, v, w, inv_dx, inv_dy, inv_dz, den_x, den_y, den_z,
                          delta, smag, partial, lm, mm, nx, ny, nz, wall_y,
                          n_partial, stream);
}
