// The term math of the general predictor's slab kernel,
// predictor_general.cu (one thread per point, every operand read from
// device memory); predictor_general_xz.cuh runs the same terms in the
// same order over offsets on its staged tile. Each function below is
// templated over a reader G, which supplies
//   g.ax[3]              the three axes (Axis: metrics, cells, walls),
//   g.nu                 the scalar viscosity,
//   g.template val<C>(p) component C at the in-range point p,
//   g.ne(p)              nu + nu_t at cell p;
// every periodic wrap and wall ghost is formed here, from in-range reads.
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
//                  pads at walls and the wrap average on periodic axes.
// A point's terms read its neighbours one cell away along each axis and
// the diagonal ones in each plane of two axes (the cross terms), never
// further.
#pragma once

#include "common.cuh"

namespace cfdnn {
namespace general {

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

// A point of the union box; a component's own index along its axis is a
// face index, a cell index along the other two.
struct Pt {
    int q[3];
};

__device__ __forceinline__ Pt with(Pt p, int a, int x) {
    p.q[a] = x;
    return p;
}

// Component C at p (in range), from the reader g.
template <typename T, int C, typename G>
__device__ __forceinline__ T val(const G& g, const Pt& p) {
    return g.template val<C>(p);
}

// The global-memory reader of the slab kernel (predictor_general.cu):
// the fields as the launcher passed them. The xz kernel takes the same
// struct as its parameter and stages its fields. Offsets are 32-bit: the
// launchers refuse arrays of 2^31 elements or more.
template <typename T>
struct Grid {
    Axis<T> ax[3];
    const T* __restrict__ f[3];    // u, v, w
    const T* __restrict__ nut;     // (nx, ny, nz) or nullptr
    int sx[4], sy[4];              // x and y strides of u, v, w and nu_t
    T nu;

    // component C at p
    template <int C>
    __device__ __forceinline__ T val(const Pt& p) const {
        return f[C][p.q[0] * sx[C] + p.q[1] * sy[C] + p.q[2]];
    }

    // nu + nu_t at cell p
    __device__ __forceinline__ T ne(const Pt& p) const {
        return nu + nut[p.q[0] * sx[3] + p.q[1] * sy[3] + p.q[2]];
    }
};

// The reader's fields, metrics and walls as the launchers receive them:
// the fifteen metric pointers (five per axis, ops/kernels.py
// general_arrays) and the (lo, hi) tangential wall velocities of u, v, w
// on y, then on z (x is periodic).
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
        const void* const* m = metrics + 5 * a;
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

// Component S along its own axis at face x in [-1, nf]: the periodic wrap,
// or the odd reflection about the boundary face (pad_normal).
template <typename T, int S, typename G>
__device__ __forceinline__ T normal(const G& g, const Pt& p, int x) {
    const Axis<T>& A = g.ax[S];
    if (!A.wall) {
        x = x < 0 ? A.n - 1 : (x >= A.n ? 0 : x);
        return val<T, S>(g, with(p, S, x));
    }
    if (x < 0)
        return T(2) * val<T, S>(g, with(p, S, 0)) - val<T, S>(g, with(p, S, 1));
    if (x > A.n)
        return T(2) * val<T, S>(g, with(p, S, A.n)) - val<T, S>(g, with(p, S, A.n - 1));
    return val<T, S>(g, with(p, S, x));
}

// Component C (cell-centred along D) at cell x in [-1, n] of axis D: the
// periodic wrap, or 2 tang - interior beyond a wall (pad_tangential).
template <typename T, int C, int D, typename G>
__device__ __forceinline__ T tangential(const G& g, const Pt& p, int x) {
    const Axis<T>& A = g.ax[D];
    if (!A.wall) {
        x = x < 0 ? A.n - 1 : (x >= A.n ? 0 : x);
        return val<T, C>(g, with(p, D, x));
    }
    if (x < 0) return T(2) * A.tlo[C] - val<T, C>(g, with(p, D, 0));
    if (x >= A.n) return T(2) * A.thi[C] - val<T, C>(g, with(p, D, A.n - 1));
    return val<T, C>(g, with(p, D, x));
}

// The cells on either side of face f of axis A: wrapped, or mirrored
// (clamped) beyond a wall.
template <typename T>
__device__ __forceinline__ void face_cells(const Axis<T>& A, int f, int& lo,
                                           int& hi) {
    if (A.wall) {
        lo = f > 0 ? f - 1 : 0;
        hi = f < A.n ? f : A.n - 1;
    } else {
        lo = wrap_m(f, A.n);
        hi = f;
    }
}

// The upper face of cell c of axis A.
template <typename T>
__device__ __forceinline__ int upper(const Axis<T>& A, int c) {
    return A.wall ? c + 1 : wrap_p(c, A.n);
}

// ---- convection: term d of component s ----------------------------------

template <typename T, int S, typename G>
__device__ T skew_own(const G& g, const Pt& p) {
    const Axis<T>& A = g.ax[S];
    const T h = T(0.5);
    const int f = p.q[S];
    int cl, ch;
    face_cells(A, f, cl, ch);
    // phi_c of cells cl and ch (the cell mean, mirrored beyond a wall)
    const T u_lo = h * (val<T, S>(g, with(p, S, cl)) + val<T, S>(g, with(p, S, upper(A, cl))));
    const T u_hi = h * (val<T, S>(g, with(p, S, ch)) + val<T, S>(g, with(p, S, upper(A, ch))));
    const T lo_n = normal<T, S>(g, p, f - 1);
    const T hi_n = normal<T, S>(g, p, f + 1);
    return h * (u_hi * hi_n - u_lo * lo_n) * A.inv_dc[f];
}

template <typename T, int S, int D, typename G>
__device__ T skew_cross(const G& g, const Pt& p) {
    const Axis<T>& As = g.ax[S];
    const Axis<T>& Ad = g.ax[D];
    const T h = T(0.5);
    const int f = p.q[S], c = p.q[D];
    // component d at its face e of axis D, averaged along S to face f
    // (c2f_mean, the ghost 2 tang_s[d] - interior beyond a wall)
    auto edge = [&](int e) -> T {
        const Pt pe = with(p, D, e);
        if (!As.wall)
            return h * (val<T, D>(g, with(pe, S, wrap_m(f, As.n))) + val<T, D>(g, pe));
        const T lo = f == 0 ? T(2) * As.tlo[D] - val<T, D>(g, with(pe, S, 0))
                            : val<T, D>(g, with(pe, S, f - 1));
        const T hi = f == As.n ? T(2) * As.thi[D] - val<T, D>(g, with(pe, S, As.n - 1))
                               : val<T, D>(g, pe);
        return h * (lo + hi);
    };
    const T u_lo = edge(c);
    const T u_hi = edge(upper(Ad, c));
    const T lo_n = tangential<T, S, D>(g, p, c - 1);
    const T hi_n = tangential<T, S, D>(g, p, c + 1);
    return h * (u_hi * hi_n - u_lo * lo_n) * Ad.inv_d[c];
}

template <typename T, int S, typename G>
__device__ T central_own(const G& g, const Pt& p) {
    const int f = p.q[S];
    const T dphi = (normal<T, S>(g, p, f + 1) - normal<T, S>(g, p, f - 1))
                   / g.ax[S].den_f[f];
    return val<T, S>(g, p) * dphi;
}

template <typename T, int S, int D, typename G>
__device__ T central_cross(const G& g, const Pt& p) {
    const Axis<T>& As = g.ax[S];
    const Axis<T>& Ad = g.ax[D];
    const T h = T(0.5);
    const int f = p.q[S], c = p.q[D];
    const int cp = upper(Ad, c);
    // component d at the centre of cell c of axis D (f2c_mean), S-cell x
    auto uc = [&](int x) -> T {
        const Pt px = with(p, S, x);
        return h * (val<T, D>(g, with(px, D, c)) + val<T, D>(g, with(px, D, cp)));
    };
    T adv;
    if (!As.wall) {
        adv = h * (uc(wrap_m(f, As.n)) + uc(f));
    } else {
        const T lo = f == 0 ? T(2) * As.tlo[D] - uc(0) : uc(f - 1);
        const T hi = f == As.n ? T(2) * As.thi[D] - uc(As.n - 1) : uc(f);
        adv = h * (lo + hi);
    }
    const T dphi = (tangential<T, S, D>(g, p, c + 1) - tangential<T, S, D>(g, p, c - 1))
                   / Ad.den_c[c];
    return adv * dphi;
}

template <typename T, bool SKEW, int S, int D, typename G>
__device__ __forceinline__ T conv_term(const G& g, const Pt& p) {
    if constexpr (D == S)
        return SKEW ? skew_own<T, S>(g, p) : central_own<T, S>(g, p);
    else
        return SKEW ? skew_cross<T, S, D>(g, p) : central_cross<T, S, D>(g, p);
}

// ---- diffusion: term d of component s -----------------------------------

template <typename T, bool NUT, int S, typename G>
__device__ T diff_own(const G& g, const Pt& p) {
    const Axis<T>& A = g.ax[S];
    // the cell flux of cell x: nu (phi_{x+1} - phi_x) inv_d[x]
    auto flux = [&](int x) -> T {
        const T grad = (val<T, S>(g, with(p, S, upper(A, x))) - val<T, S>(g, with(p, S, x)))
                       * A.inv_d[x];
        if constexpr (NUT)
            return g.ne(with(p, S, x)) * grad;
        else
            return g.nu * grad;
    };
    int lo, hi;
    face_cells(A, p.q[S], lo, hi);
    return (flux(hi) - flux(lo)) * A.inv_dc[p.q[S]];
}

template <typename T, bool NUT, int S, int D, typename G>
__device__ T diff_cross(const G& g, const Pt& p) {
    const Axis<T>& As = g.ax[S];
    const Axis<T>& Ad = g.ax[D];
    const T h = T(0.5);
    const int c = p.q[D];
    // the flux at face e of axis D
    auto flux = [&](int e) -> T {
        const T grad = (tangential<T, S, D>(g, p, e) - tangential<T, S, D>(g, p, e - 1))
                       * Ad.inv_dg[e];
        if constexpr (NUT) {
            // nu + nu_t averaged to face e of D (at the S-cells xl, xh),
            // then to face f of S
            int el, eh, xl, xh;
            face_cells(Ad, e, el, eh);
            face_cells(As, p.q[S], xl, xh);
            const Pt pl = with(p, S, xl), ph = with(p, S, xh);
            const T n_lo = h * (g.ne(with(pl, D, el)) + g.ne(with(pl, D, eh)));
            const T n_hi = h * (g.ne(with(ph, D, el)) + g.ne(with(ph, D, eh)));
            return h * (n_lo + n_hi) * grad;
        } else {
            return g.nu * grad;
        }
    };
    return (flux(upper(Ad, c)) - flux(c)) * Ad.inv_d[c];
}

template <typename T, bool NUT, int S, int D, typename G>
__device__ __forceinline__ T diff_term(const G& g, const Pt& p) {
    if constexpr (D == S)
        return diff_own<T, NUT, S>(g, p);
    else
        return diff_cross<T, NUT, S, D>(g, p);
}

// u* (S = 0, with the body force), v* or w* at p.
template <typename T, bool NUT, bool SKEW, int S, typename G>
__device__ __forceinline__ T star(const G& g, const Pt& p, T dt, T fx) {
    T conv = conv_term<T, SKEW, S, 0>(g, p);
    conv = conv + conv_term<T, SKEW, S, 1>(g, p);
    conv = conv + conv_term<T, SKEW, S, 2>(g, p);
    T lap = diff_term<T, NUT, S, 0>(g, p);
    lap = lap + diff_term<T, NUT, S, 1>(g, p);
    lap = lap + diff_term<T, NUT, S, 2>(g, p);
    const T c = val<T, S>(g, p);
    if constexpr (S == 0)
        return c + dt * (-conv + lap + fx);
    else
        return c + dt * (-conv + lap);
}

}  // namespace general
}  // namespace cfdnn
