// The stencils of the slab projection kernels (divergence.cu, correct.cu:
// one thread per point, device memory; xz.cu runs the same expressions
// over offsets on its staged tile), each
// read through a reader: r.template at<C>(i, j, k) gives face component
// C (0 u, 1 v, 2 w) at its stored point, r(i, j, k) the pressure at a
// cell.
//
// Per axis a mode: 0 = the axis has one cell (skipped by the divergence,
// its component copied by the correction, as the operators do), 1 =
// periodic (N stored faces, face N wraps to 0), 2 = bounded (N+1 stored
// faces, boundary faces in the array).
#pragma once

#include "common.cuh"

namespace cfdnn {

// The staggered O2 divergence at cell (i, j, k):
//     sum over axes a of (face_hi - face_lo) * inv_d_a
// with the reference's order of summation (x, then y, then z).
template <typename T, typename R>
__device__ __forceinline__ T div_cell(const R& r, const T* __restrict__ inv_dx,
                                      const T* __restrict__ inv_dy,
                                      const T* __restrict__ inv_dz, int i, int j,
                                      int k, int nx, int ny, int nz, int mx,
                                      int my, int mz) {
    T acc = T(0);
    bool have = false;
    if (mx) {
        const int hi = mx == 1 ? wrap_p(i, nx) : i + 1;
        const T t = (r.template at<0>(hi, j, k) - r.template at<0>(i, j, k)) * inv_dx[i];
        acc = t;
        have = true;
    }
    if (my) {
        const int hi = my == 1 ? wrap_p(j, ny) : j + 1;
        const T t = (r.template at<1>(i, hi, k) - r.template at<1>(i, j, k)) * inv_dy[j];
        acc = have ? acc + t : t;
        have = true;
    }
    if (mz) {
        const int hi = mz == 1 ? wrap_p(k, nz) : k + 1;
        const T t = (r.template at<2>(i, j, hi) - r.template at<2>(i, j, k)) * inv_dz[k];
        acc = have ? acc + t : t;
    }
    return acc;
}

// The O2 pressure gradient at face (i, j, k) of axis `axis`, between cells
// f-1 and f: (p[f] - p[f-1]) * inv_dc[f], with the periodic wrap, or on a
// bounded axis the Neumann copy ghost of bc.pad_pressure, which makes the
// gradient at the two boundary faces exactly zero.
template <typename T, typename P>
__device__ __forceinline__ T face_grad(const P& p, const T* __restrict__ inv_dc,
                                       int i, int j, int k, int axis, int mode,
                                       int nx, int ny, int nz) {
    const int n = axis == 0 ? nx : (axis == 1 ? ny : nz);
    const int f = axis == 0 ? i : (axis == 1 ? j : k);
    int lo;
    if (mode == 1) {
        lo = wrap_m(f, n);
    } else {
        if (f == 0 || f == n) return T(0) * inv_dc[f];
        lo = f - 1;
    }
    int il = i, jl = j, kl = k;
    if (axis == 0) il = lo; else if (axis == 1) jl = lo; else kl = lo;
    return (p(i, j, k) - p(il, jl, kl)) * inv_dc[f];
}

}  // namespace cfdnn
