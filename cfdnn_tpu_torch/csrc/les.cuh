// Shared device code of the LES kernels (nu_sgs, germano_pass1): the grid
// they serve, the ghost rules of its fields, the nine-component velocity
// gradient at a cell and the cell-centre velocity.
//
// The grid: periodic uniform x; y and z each periodic uniform or bounded
// by stationary no-slip walls at any stretching (germano_pass1 keeps z
// periodic: wall_z = 0). Shapes: u (nx, ny, nz) (x periodic: N faces
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

    // A field cell-centred in y (u, or w with nzs stored z points) at row
    // jj in [-1, ny]: odd reflection about the wall value 0
    // (pad_tangential), or the periodic wrap.
    __device__ __forceinline__ T yc(const T* __restrict__ f, int i, int jj,
                                    int k, int nzs) const {
        if (jj < 0) return wall_y ? -f[at3(i, 0, k, ny, nzs)] : f[at3(i, ny - 1, k, ny, nzs)];
        if (jj >= ny) return wall_y ? -f[at3(i, ny - 1, k, ny, nzs)] : f[at3(i, 0, k, ny, nzs)];
        return f[at3(i, jj, k, ny, nzs)];
    }

    // A field cell-centred in z (u, or v with nys stored y points) at
    // column kk in [-1, nz]: the same rules along z.
    __device__ __forceinline__ T zc(const T* __restrict__ f, int i, int j,
                                    int kk, int nys) const {
        if (kk < 0) return wall_z ? -f[at3(i, j, 0, nys, nz)] : f[at3(i, j, nz - 1, nys, nz)];
        if (kk >= nz) return wall_z ? -f[at3(i, j, nz - 1, nys, nz)] : f[at3(i, j, 0, nys, nz)];
        return f[at3(i, j, kk, nys, nz)];
    }

    __device__ __forceinline__ T U(int i, int j, int k) const { return u[at3(i, j, k, ny, nz)]; }
    __device__ __forceinline__ T V(int i, int jf, int k) const { return v[at3(i, jf, k, nfy(), nz)]; }
    __device__ __forceinline__ T W(int i, int j, int kf) const { return w[at3(i, j, kf, ny, nfz())]; }

    // the upper face of cell j of v, of cell k of w
    __device__ __forceinline__ int vhi(int j) const { return wall_y ? j + 1 : wrap_p(j, ny); }
    __device__ __forceinline__ int whi(int k) const { return wall_z ? k + 1 : wrap_p(k, nz); }

    // grad(u) at cell (i, j, k): G[a][b] = d u_a / d x_b.
    __device__ __forceinline__ void gradient(int i, int j, int k, T G[3][3]) const {
        const T h = T(0.5);
        const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
        const int jf = vhi(j), kf = whi(k);
        const int nys = nfy(), nzs = nfz();
        const T dy = den_y[j], dx = den_x[i], dz = den_z[k];
        // diagonal: staggered difference across the cell
        G[0][0] = (U(ip, j, k) - U(i, j, k)) * inv_dx[i];
        G[1][1] = (V(i, jf, k) - V(i, j, k)) * inv_dy[j];
        G[2][2] = (W(i, j, kf) - W(i, j, k)) * inv_dz[k];
        // off the diagonal: central difference at the component's own
        // points, then the mean of the two points bounding the cell
        const T uy_lo = (yc(u, i, j + 1, k, nz) - yc(u, i, j - 1, k, nz)) / dy;
        const T uy_hi = (yc(u, ip, j + 1, k, nz) - yc(u, ip, j - 1, k, nz)) / dy;
        G[0][1] = h * (uy_lo + uy_hi);
        const T uz_lo = (zc(u, i, j, k + 1, ny) - zc(u, i, j, k - 1, ny)) / dz;
        const T uz_hi = (zc(u, ip, j, k + 1, ny) - zc(u, ip, j, k - 1, ny)) / dz;
        G[0][2] = h * (uz_lo + uz_hi);
        const T vx_lo = (V(ip, j, k) - V(im, j, k)) / dx;
        const T vx_hi = (V(ip, jf, k) - V(im, jf, k)) / dx;
        G[1][0] = h * (vx_lo + vx_hi);
        const T vz_lo = (zc(v, i, j, k + 1, nys) - zc(v, i, j, k - 1, nys)) / dz;
        const T vz_hi = (zc(v, i, jf, k + 1, nys) - zc(v, i, jf, k - 1, nys)) / dz;
        G[1][2] = h * (vz_lo + vz_hi);
        const T wx_lo = (W(ip, j, k) - W(im, j, k)) / dx;
        const T wx_hi = (W(ip, j, kf) - W(im, j, kf)) / dx;
        G[2][0] = h * (wx_lo + wx_hi);
        const T wy_lo = (yc(w, i, j + 1, k, nzs) - yc(w, i, j - 1, k, nzs)) / dy;
        const T wy_hi = (yc(w, i, j + 1, kf, nzs) - yc(w, i, j - 1, kf, nzs)) / dy;
        G[2][1] = h * (wy_lo + wy_hi);
    }

    // (u, v, w) interpolated to the centre of cell (i, j, k)
    __device__ __forceinline__ void centre(int i, int j, int k, T c[3]) const {
        const T h = T(0.5);
        c[0] = h * (U(i, j, k) + U(wrap_p(i, nx), j, k));
        c[1] = h * (V(i, j, k) + V(i, vhi(j), k));
        c[2] = h * (W(i, j, k) + W(i, j, whi(k)));
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

}  // namespace cfdnn
