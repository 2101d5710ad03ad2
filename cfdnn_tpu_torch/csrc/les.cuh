// Shared device code of the LES kernels (nu_sgs, nu_sgs_xz, germano_pass1;
// transport reads the gradient too): the grid they serve, the ghost rules
// of its fields, the nine-component velocity gradient at a cell and the
// algebraic closures' nu_sgs.
//
// The grid: periodic uniform x; y and z each periodic uniform or bounded
// by stationary no-slip walls at any stretching. Shapes: u (nx, ny, nz) (x periodic: N faces
// stored); v (nx, ny+1, nz) with the wall faces stored, or (nx, ny, nz) on
// a periodic y; w (nx, ny, nz+1) likewise, or (nx, ny, nz) on a periodic z.
//
// Every expression follows the operator library's order of evaluation
// (ops/operators.py velocity_gradient: f2c_diff on the diagonal,
// f2c_mean(cc_central(...)) off it), so that the kernels agree with their
// plain twins to the roundoff of a fused multiply-add.
#pragma once

#include "common.cuh"

namespace cfdnn {

template <typename T>
struct LesGrid {
    const T* __restrict__ u;
    const T* __restrict__ v;
    const T* __restrict__ w;
    const T* __restrict__ inv_dx;   // (nx) 1/cell width
    const T* __restrict__ inv_dy;   // (ny)
    const T* __restrict__ inv_dz;   // (nz)
    const T* __restrict__ den_x;    // (nx) 2-apart ghost-aware centre distance
    const T* __restrict__ den_y;    // (ny)   (the cc_central denominators)
    const T* __restrict__ den_z;    // (nz)
    int nx, ny, nz;
    int wall_y;                     // 1: no-slip walls in y, 0: periodic y
    int wall_z;                     // 1: no-slip walls in z, 0: periodic z

    __device__ __forceinline__ int nfy() const { return wall_y ? ny + 1 : ny; }
    __device__ __forceinline__ int nfz() const { return wall_z ? nz + 1 : nz; }

    // The stencils below read component C (0 u, 1 v, 2 w) at its stored
    // point (i, j, k) through a reader r, r.template at<C>(i, j, k)
    // (transport_tile.cuh's). nu_sgs_xz (xz.cu) and nu_sgs_tile.cuh run the
    // same gradient over offsets on their staged tiles.

    // Component C, cell-centred in y (u, or w), at row jj in [-1, ny]: odd
    // reflection about the wall value 0 (pad_tangential), or the periodic
    // wrap.
    template <int C, typename R>
    __device__ __forceinline__ T yc(const R& r, int i, int jj, int k) const {
        if (jj < 0) return wall_y ? -r.template at<C>(i, 0, k) : r.template at<C>(i, ny - 1, k);
        if (jj >= ny) return wall_y ? -r.template at<C>(i, ny - 1, k) : r.template at<C>(i, 0, k);
        return r.template at<C>(i, jj, k);
    }

    // Component C, cell-centred in z (u, or v), at column kk in [-1, nz]:
    // the same rules along z.
    template <int C, typename R>
    __device__ __forceinline__ T zc(const R& r, int i, int j, int kk) const {
        if (kk < 0) return wall_z ? -r.template at<C>(i, j, 0) : r.template at<C>(i, j, nz - 1);
        if (kk >= nz) return wall_z ? -r.template at<C>(i, j, nz - 1) : r.template at<C>(i, j, 0);
        return r.template at<C>(i, j, kk);
    }

    // the upper face of cell j of v, of cell k of w
    __device__ __forceinline__ int vhi(int j) const { return wall_y ? j + 1 : wrap_p(j, ny); }
    __device__ __forceinline__ int whi(int k) const { return wall_z ? k + 1 : wrap_p(k, nz); }

    // grad(u) at cell (i, j, k), read through r: G[a][b] = d u_a / d x_b.
    template <typename R>
    __device__ __forceinline__ void gradient(const R& r, int i, int j, int k,
                                             T G[3][3]) const {
        const T h = T(0.5);
        const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
        const int jf = vhi(j), kf = whi(k);
        const T dy = den_y[j], dx = den_x[i], dz = den_z[k];
        // diagonal: staggered difference across the cell
        G[0][0] = (r.template at<0>(ip, j, k) - r.template at<0>(i, j, k)) * inv_dx[i];
        G[1][1] = (r.template at<1>(i, jf, k) - r.template at<1>(i, j, k)) * inv_dy[j];
        G[2][2] = (r.template at<2>(i, j, kf) - r.template at<2>(i, j, k)) * inv_dz[k];
        // off the diagonal: central difference at the component's own
        // points, then the mean of the two points bounding the cell
        const T uy_lo = (yc<0>(r, i, j + 1, k) - yc<0>(r, i, j - 1, k)) / dy;
        const T uy_hi = (yc<0>(r, ip, j + 1, k) - yc<0>(r, ip, j - 1, k)) / dy;
        G[0][1] = h * (uy_lo + uy_hi);
        const T uz_lo = (zc<0>(r, i, j, k + 1) - zc<0>(r, i, j, k - 1)) / dz;
        const T uz_hi = (zc<0>(r, ip, j, k + 1) - zc<0>(r, ip, j, k - 1)) / dz;
        G[0][2] = h * (uz_lo + uz_hi);
        const T vx_lo = (r.template at<1>(ip, j, k) - r.template at<1>(im, j, k)) / dx;
        const T vx_hi = (r.template at<1>(ip, jf, k) - r.template at<1>(im, jf, k)) / dx;
        G[1][0] = h * (vx_lo + vx_hi);
        const T vz_lo = (zc<1>(r, i, j, k + 1) - zc<1>(r, i, j, k - 1)) / dz;
        const T vz_hi = (zc<1>(r, i, jf, k + 1) - zc<1>(r, i, jf, k - 1)) / dz;
        G[1][2] = h * (vz_lo + vz_hi);
        const T wx_lo = (r.template at<2>(ip, j, k) - r.template at<2>(im, j, k)) / dx;
        const T wx_hi = (r.template at<2>(ip, j, kf) - r.template at<2>(im, j, kf)) / dx;
        G[2][0] = h * (wx_lo + wx_hi);
        const T wy_lo = (yc<2>(r, i, j + 1, k) - yc<2>(r, i, j - 1, k)) / dy;
        const T wy_hi = (yc<2>(r, i, j + 1, kf) - yc<2>(r, i, j - 1, kf)) / dy;
        G[2][1] = h * (wy_lo + wy_hi);
    }
};

// sqrt(max(x, 0)) (utils/numerics.py safe_sqrt): exactly 0 at zero strain
template <typename T>
__device__ __forceinline__ T safe_sqrt(T x) { return x > T(0) ? sqrt(x) : T(0); }

// The strain tensor S (symmetric; S[a][b] = (G[a][b] + G[b][a]) / 2) and
// |S| = sqrt(2 S_ij S_ij) (turbulence/base.py strain_rotation).
template <typename T>
__device__ __forceinline__ T strain(const T G[3][3], T S[3][3]) {
    const T h = T(0.5);
    S[0][0] = G[0][0];
    S[1][1] = G[1][1];
    S[2][2] = G[2][2];
    S[0][1] = S[1][0] = h * (G[0][1] + G[1][0]);
    S[0][2] = S[2][0] = h * (G[0][2] + G[2][0]);
    S[1][2] = S[2][1] = h * (G[1][2] + G[2][1]);
    const T ss = S[0][0] * S[0][0] + S[1][1] * S[1][1] + S[2][2] * S[2][2]
               + T(2) * (S[0][1] * S[0][1] + S[0][2] * S[0][2] + S[1][2] * S[1][2]);
    return safe_sqrt(T(2) * ss);
}

// nu_sgs of an algebraic closure from the velocity gradient G at a cell of
// filter width *delta, with its constant coeff (turbulence/les.py):
//   CLOSURE 0 Smagorinsky  (Cs Delta)^2 |S|
//           1 WALE         (Cw Delta)^2 (Sd:Sd)^(3/2) / ((S:S)^(5/2) + (Sd:Sd)^(5/4) + 1e-30)
//           2 Vreman       Cv sqrt(max(B_beta, 0) / max(a:a, 1e-30))
template <typename T, int CLOSURE>
__device__ __forceinline__ T nu_closure(const T G[3][3], const T* __restrict__ delta,
                                        T coeff) {
    T S[3][3];
    const T smag = strain(G, S);
    const T dl = *delta;
    const T cd = coeff * dl;
    T nu;
    if (CLOSURE == 0) {
        nu = cd * cd * smag;
    } else if (CLOSURE == 1) {
        // Sd = sym(g.g) - tr(g.g)/3 I
        T g2[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                g2[a][b] = G[a][0] * G[0][b] + G[a][1] * G[1][b] + G[a][2] * G[2][b];
        const T tr = g2[0][0] + g2[1][1] + g2[2][2];
        T sdsd = T(0);
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                T sd = T(0.5) * (g2[a][b] + g2[b][a]);
                if (a == b) sd = sd - tr / T(3);
                sdsd = sdsd + sd * sd;
            }
        const T ss = T(0.5) * (smag * smag);
        const T denom = pow(ss, T(2.5)) + pow(sdsd, T(1.25)) + T(1e-30);
        nu = cd * cd * pow(sdsd, T(1.5)) / denom;
    } else {
        // a_ab = G[b][a]; beta = Delta^2 a^T a
        T aa = T(0);
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) aa = aa + G[b][a] * G[b][a];
        const T d2 = dl * dl;
        T bb[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                bb[a][b] = d2 * (G[a][0] * G[b][0] + G[a][1] * G[b][1] + G[a][2] * G[b][2]);
        T B = bb[0][0] * bb[1][1] - bb[0][1] * bb[0][1]
            + bb[0][0] * bb[2][2] - bb[0][2] * bb[0][2]
            + bb[1][1] * bb[2][2] - bb[1][2] * bb[1][2];
        B = B > T(0) ? B : T(0);
        nu = coeff * sqrt(B / (aa > T(1e-30) ? aa : T(1e-30)));
    }
    return nu;
}

}  // namespace cfdnn
