// The general predictor's grid and terms: what the two kernels of its
// function share, predictor_general_tile.cuh (the slab kernel on a walked
// (x, z) tile) and predictor_general_xz.cuh (the xz kernel), each of which
// writes the terms below over offsets on its staged window, in this order
// of evaluation, in its own `Tile`. This header keeps the grid they take as their parameter (`Grid`: the
// fields, the three axes' metrics and walls) and how the launchers build
// it (`make_grid`).
//
// The operators and the order of evaluation are the operator library's
// (ops/operators.py _conv_skew, _conv_advective, diffusive), term by term,
// for component s and derivative direction d:
//   skew, d == s:  0.5 (phi_c[f] n_hi - phi_c[f-1] n_lo) inv_dc[f], phi_c
//                  the cell mean mirrored beyond a wall (pad_center),
//                  n_lo/n_hi the odd reflection 2 phi_wall - phi_next
//                  (pad_normal);
//   skew, d != s:  0.5 (U_e[c+1] n_hi - U_e[c] n_lo) inv_d[c], U_e =
//                  c2f_mean(comp d, s) with the ghost 2 tang_s[d] -
//                  interior, n_lo/n_hi phi's ghost 2 tang_d[s] - interior;
//   central:       phi (phi_{f+1} - phi_{f-1}) / den_f[f] along s (odd
//                  ghosts), and c2f_mean(f2c_mean(comp d, d), s) times
//                  (phi_{c+1} - phi_{c-1}) / den_c[c] across (tang ghosts);
//   diffusion:     along s, (F_hi - F_lo) inv_dc[f] of the cell fluxes
//                  F = nu (phi_{c+1} - phi_c) inv_d[c], mirrored beyond a
//                  wall (_bdiff_stored); across, (F[c+1] - F[c]) inv_d[c]
//                  of F = nu_e (phi_c - phi_{c-1}) inv_dg (c2f_diff with
//                  tang ghosts, the ghost-aware spacing), nu_e the scalar
//                  nu or c2f_mean(c2f_mean(nu + nu_t, d), s) with mirror
//                  pads at walls and the wrap average on periodic axes;
//   upwind:        adv dphi with adv as central's (phi itself along s)
//                  and dphi = adv >= 0 ? back : fwd, the one-sided
//                  differences (phi_c - phi_{c-1}) / dg[c] and
//                  (phi_{c+1} - phi_c) / dg[c+1] with the ghosts of
//                  central (_upwind_pair, dg the ghost-aware spacings);
//   upwind2:       the same with the minmod-limited MUSCL pair of
//                  _upwind2_deriv_pair over phi_{c-2} ... phi_{c+2}, the
//                  ghosts two deep beyond a wall (pad_normal and
//                  pad_tangential with ng = 2).
// A point's O2 terms read its neighbours one cell away along each axis
// and the diagonal ones in each plane of two axes (the cross terms), never
// further; upwind2's read two cells along each axis.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace cfdnn {
namespace general {

// The convective scheme, the kernels' template argument and the C
// entries' `scheme` (ops/kernels.py SCHEME_CODES): central 0 and skew 1
// are the values of the bool SKEW the kernels took before the upwind
// schemes.
enum Scheme : int { kCentral = 0, kSkew = 1, kUpwind = 2, kUpwind2 = 3 };

// The metric vectors of an axis in ops/kernels.py general_arrays: Axis's
// five, then Spacing's two.
constexpr int kAxisMetrics = 7;

template <typename T>
struct Axis {
    const T* __restrict__ inv_d;   // (n)    1 / cell width
    const T* __restrict__ inv_dc;  // (n+1)  1 / centre distance at the faces
    const T* __restrict__ inv_dg;  // (n+1)  1 / ghost-aware centre spacing
    const T* __restrict__ den_c;   // (n)    2-apart centre distance
    const T* __restrict__ den_f;   // (nf)   2-apart face distance
    int n;                         // cells
    int wall;                      // 1: no-slip walls, 0: periodic
    T tlo[3];                      // tangential wall velocity of u, v, w
    T thi[3];                      //   at the low and the high wall
};

// The upwind schemes' one-sided spacings (general_arrays' dg_c and dg_f of
// each axis): along axis a, a point of cell index c divides its backward
// difference by c[a][c] and its forward one by c[a][c + 1], a point of
// face index f by f[a][f] and f[a][f + 1]. The kernels take it as a
// parameter of its own after their others, so that Grid, and with it the
// code of the skew and central instantiations, stays as it was.
template <typename T>
struct Spacing {
    const T* c[3];                 // (n+1) ghost-aware centre spacings
    const T* f[3];                 // (nf+1) the faces'

    // The pointers advanced to the point (i, j, k): [0] its backward
    // divisor along each axis, [1] its forward one.
    __device__ __forceinline__ Spacing at(int i, int j, int k) const {
        return Spacing{{c[0] + i, c[1] + j, c[2] + k},
                       {f[0] + i, f[1] + j, f[2] + k}};
    }
};

// The base of a kernel's reader of the terms (its `Tile`): the point's
// Spacing under upwind and upwind2, nothing (an empty base, no bytes)
// under skew and central, whose reader is then the one of before: the
// same layout and the same code.
struct NoSpacing {};

template <int SCHEME, typename T>
using SpacingOf =
    std::conditional_t<SCHEME == kUpwind || SCHEME == kUpwind2, Spacing<T>,
                       NoSpacing>;

// SpacingOf's value at the point (i, j, k) from the kernel's Spacing.
template <int SCHEME, typename T>
__device__ __forceinline__ SpacingOf<SCHEME, T> spacing_at(
        const Spacing<T>& sg, int i, int j, int k) {
    if constexpr (std::is_same_v<SpacingOf<SCHEME, T>, NoSpacing>)
        return {};
    else
        return sg.at(i, j, k);
}

// The fields as the launcher passed them, with the axes: both kernels
// take this struct as their parameter and stage its fields. Offsets are
// 32-bit: the launchers refuse arrays of 2^31 elements or more.
template <typename T>
struct Grid {
    Axis<T> ax[3];
    const T* __restrict__ f[3];    // u, v, w
    const T* __restrict__ nut;     // (nx, ny, nz) or nullptr
    int sx[4], sy[4];              // x and y strides of u, v, w and nu_t
    T nu;
};

// The reader's fields, metrics and walls as the launchers receive them:
// the 21 metric pointers (seven per axis, ops/kernels.py general_arrays;
// Axis takes the first five of each) and the (lo, hi) tangential wall
// velocities of u, v, w on y, then on z (x is periodic).
template <typename T>
Grid<T> make_grid(const void* u, const void* v, const void* w,
                  const void* nut, const void* const* metrics,
                  const double* tang, int nx, int ny, int nz, int wall_y,
                  int wall_z, double nu) {
    const int nyf = wall_y ? ny + 1 : ny, nzf = wall_z ? nz + 1 : nz;
    Grid<T> g;
    const int ext[4][2] = {{ny, nz}, {nyf, nz}, {ny, nzf}, {ny, nz}};
    for (int c = 0; c < 4; ++c) {
        g.sx[c] = ext[c][0] * ext[c][1];
        g.sy[c] = ext[c][1];
    }
    const int n[3] = {nx, ny, nz};
    const int wall[3] = {0, wall_y, wall_z};
    for (int a = 0; a < 3; ++a) {
        Axis<T>& A = g.ax[a];
        const void* const* m = metrics + kAxisMetrics * a;
        A.inv_d = static_cast<const T*>(m[0]);
        A.inv_dc = static_cast<const T*>(m[1]);
        A.inv_dg = static_cast<const T*>(m[2]);
        A.den_c = static_cast<const T*>(m[3]);
        A.den_f = static_cast<const T*>(m[4]);
        A.n = n[a];
        A.wall = wall[a];
        for (int c = 0; c < 3; ++c) {
            // tang: (lo, hi) of u, v, w on y, then on z; x is periodic
            A.tlo[c] = a == 0 ? T(0) : T(tang[6 * (a - 1) + 2 * c]);
            A.thi[c] = a == 0 ? T(0) : T(tang[6 * (a - 1) + 2 * c + 1]);
        }
    }
    g.f[0] = static_cast<const T*>(u);
    g.f[1] = static_cast<const T*>(v);
    g.f[2] = static_cast<const T*>(w);
    g.nut = static_cast<const T*>(nut);
    g.nu = T(nu);
    return g;
}

// The upwind spacings of the same 21 metric pointers: the last two of
// each axis.
template <typename T>
Spacing<T> make_spacing(const void* const* metrics) {
    Spacing<T> s;
    for (int a = 0; a < 3; ++a) {
        s.c[a] = static_cast<const T*>(metrics[kAxisMetrics * a + 5]);
        s.f[a] = static_cast<const T*>(metrics[kAxisMetrics * a + 6]);
    }
    return s;
}

// minmod(a, b) of the upwind2 limiter (operators._minmod): the smaller
// in magnitude where a and b have one sign, else 0.
template <typename T>
__device__ __forceinline__ T minmod(T a, T b) {
    return a * b > T(0) ? (fabs(a) < fabs(b) ? a : b) : T(0);
}

}  // namespace general
}  // namespace cfdnn
