// transport: the k-omega point-implicit advance of the two-equation RANS
// closures, in one pass over u, v, w, k, omega and nu_t, with the SST
// eddy viscosity as an optional third output.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_transport_advance (body
// _transport_advance_kernel, which runs the closure's math_fn,
// turbulence/transport.py, on an x-slab with a halo of ng planes). The
// plain PyTorch twin is ops/kernels.py transport_twin: the port's
// turbulence/transport.py sst_advance_math, sst_with_nut_math and
// komega_advance_math on whole arrays. Three instantiations (MODEL):
//   0 SST            k_new, om_new       (the EARSM closures' advance)
//   1 SST + nu_t     k_new, om_new, nu_t (the SST closure's step)
//   2 Wilcox         k_new, om_new
// k_new and om_new are the values before the clip and the omega pin;
// the caller applies that epilogue (idempotent) to what it carries.
// MODEL 1's nu_t is sst_nut_math of the clipped and pinned values and the
// in-kernel strain.
//
// Where trouble is likely, and what the code does about it:
//  1. SST reaches two cells. Its diffusion reads nu_k and nu_om at the six
//     neighbours, and each is F1-blended from the k and omega gradients at
//     that neighbour, so a cell reads k and omega two cells away along
//     each axis and on the edge diagonals (the TPU kernel's ng = 2). Each
//     thread evaluates the blend (`blend`: F1 and the cross-diffusion
//     product) at its cell and at its six neighbours from the unpadded
//     arrays; nothing is staged through shared memory or a second launch.
//     Wilcox's diffusivities take only the input nu_t: reach one.
//  2. Ghost rules (transport.py _neighbors, keyed on the axis's BC): a
//     periodic axis wraps, even when stretched; a wall is Dirichlet
//     through the ghost 2 wv - interior, with wv = 0 for k and om_wall for
//     omega; nu_eff's ghost mirrors the interior. Spacings: den_c (2-apart
//     centre distance), dpos (centre spacing, ghost-aware: the upwind
//     den_b = dpos[i], den_f = dpos[i+1]) and inv_dpos = 1/dpos (the
//     diffusion), built once on the host (ops/kernels.py
//     transport_arrays). The strain and the cell-centre velocity are
//     les.cuh's LesGrid, whose ghosts assume stationary no-slip walls: the
//     gate (ops/kernels.py nu_sgs_eligible) refuses a moving wall.
//  3. Host scalars. om_wall, nu and every constant product the twin forms
//     in Python (2 sigma_omega2, 500 nu, 10 beta_star, ...) arrive as
//     doubles computed once on the host, in the twin's order; dt is read
//     on the device through its pointer (no host sync).
//  4. Epilogue. MODEL 1 clips k_new to [k_min, k_max] and omega to
//     [omega_min, omega_max], pins omega to om_visc where the pin mask
//     is > 0.5, and forms nu_t of those values, as the twin does; the
//     stored k_new, om_new stay unclipped.
//  5. float32 overflow in the blending. With omega at its 1e-10 floor,
//     arg1^4 and arg2^2 reach inf; `safe_tanh` clamps its argument to
//     +-30 so tanh reads 1, and lets a NaN through as torch.clamp does
//     (no fmin/fmax, which drop a NaN). max/min follow torch.maximum
//     and torch.clamp on NaN. Powers and the order of operations are the
//     twin's, so float64 agrees to roundoff.
//  6. Per-cell constants (y_wall, pin mask, om_visc) are (1, Ny, Nz)
//     device arrays built once by the model; pin and om_visc are read by
//     MODEL 1 only, and only where the grid has a wall.
//
// Bound on the H100: device-memory bandwidth. The bytes: six fields in,
// two or three out (32 or 36 bytes a cell in float32). The arithmetic as
// written here (adds, multiplies, divisions, square roots and tanh one
// each, pow(x, 4) two multiplies, comparisons and clamps not counted):
// 544 a cell for MODEL 1, 530 for MODEL 0 (of which the six neighbours'
// blends and diffusivities are 270), 229 for MODEL 2. At 67 TFLOP/s that
// is at most 0.83 of the bytes' time at 3.35 TB/s, so each instantiation
// is bytes-bound; the neighbour reads of the blends (~100 loads a cell)
// are served by L1/L2.
// Design: one thread per cell, z fastest within a warp, all neighbour and
// ghost values formed in registers.
#include "les.cuh"

namespace {

using cfdnn::LesGrid;
using cfdnn::at3;

template <typename T>
struct TAxis {
    const T* __restrict__ inv_d;     // (n)    1 / cell width
    const T* __restrict__ den_c;     // (n)    2-apart centre distance
    const T* __restrict__ dpos;      // (n+1)  ghost-aware centre spacing
    const T* __restrict__ inv_dpos;  // (n+1)  1 / dpos
    int n;
    int wall;                        // 1: walls at both ends, 0: periodic
};

// The constants, in the order ops/kernels.py _transport_params writes them.
enum {
    P_NU, P_TWO_OM_WALL, P_K_MIN, P_OM_MIN, P_CD_MIN, P_BETA_STAR,
    P_TWO_SO2, P_500NU, P_FOUR_SO2, P_BETA1, P_BETA2, P_ALPHA1, P_ALPHA2,
    P_SK1, P_SK2, P_SO1, P_SO2, P_TEN_BS, P_K_MAX, P_OM_MAX, P_A1,
    P_1000NU, P_COUNT
};

template <typename T>
struct TGrid {
    LesGrid<T> les;                  // u, v, w and the strain metrics
    TAxis<T> ax[3];
    const T* __restrict__ k;
    const T* __restrict__ om;
    const T* __restrict__ nut;
    const T* __restrict__ y_wall;    // (Ny, Nz)
    T p[P_COUNT];
};

// torch.clamp(x, min=lo) and the like: a NaN x passes through
template <typename T>
__device__ __forceinline__ T lo_clamp(T x, T lo) { return x < lo ? lo : x; }
template <typename T>
__device__ __forceinline__ T hi_clamp(T x, T hi) { return x > hi ? hi : x; }
// torch.maximum / torch.minimum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
    return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
    return (a != a || b != b) ? a + b : (a < b ? a : b);
}
// utils/numerics.py safe_tanh: tanh(clamp(x, -30, 30))
template <typename T>
__device__ __forceinline__ T safe_tanh(T x) {
    return tanh(hi_clamp(lo_clamp(x, T(-30)), T(30)));
}

struct Cell {
    int c[3];
};

// The neighbour of p at d = +-1 along axis a: true and its cell in q, or
// false where it is a wall ghost (p is the boundary cell).
template <typename T>
__device__ __forceinline__ bool neighbour(const TGrid<T>& g, const Cell& p,
                                          int a, int d, Cell& q) {
    q = p;
    const int n = g.ax[a].n;
    int c = p.c[a] + d;
    if (c < 0 || c >= n) {
        if (g.ax[a].wall) return false;
        c = c < 0 ? n - 1 : 0;
    }
    q.c[a] = c;
    return true;
}

template <typename T>
__device__ __forceinline__ long long flat(const TGrid<T>& g, const Cell& p) {
    return at3(p.c[0], p.c[1], p.c[2], g.ax[1].n, g.ax[2].n);
}

template <typename T>
__device__ __forceinline__ T kq(const TGrid<T>& g, const Cell& p) {
    return lo_clamp(g.k[flat(g, p)], g.p[P_K_MIN]);
}
template <typename T>
__device__ __forceinline__ T omq(const TGrid<T>& g, const Cell& p) {
    return lo_clamp(g.om[flat(g, p)], g.p[P_OM_MIN]);
}
template <typename T>
__device__ __forceinline__ T ntq(const TGrid<T>& g, const Cell& p) {
    return lo_clamp(g.nut[flat(g, p)], T(0));
}
template <typename T>
__device__ __forceinline__ T yq(const TGrid<T>& g, const Cell& p) {
    return lo_clamp(g.y_wall[static_cast<long long>(p.c[1]) * g.ax[2].n + p.c[2]],
                    T(1e-10));
}

// (f_{i-1}, f_{i+1}) along axis a of the clamped k (OMEGA false, wall
// value 0) or omega (wall value om_wall): transport.py _neighbors.
template <typename T, bool OMEGA>
__device__ __forceinline__ void pair(const TGrid<T>& g, const Cell& p, int a,
                                     T f, T& fm, T& fp) {
    const T two_wv = OMEGA ? g.p[P_TWO_OM_WALL] : T(0);
    Cell q;
    if (neighbour(g, p, a, -1, q)) fm = OMEGA ? omq(g, q) : kq(g, q);
    else fm = two_wv - f;
    if (neighbour(g, p, a, +1, q)) fp = OMEGA ? omq(g, q) : kq(g, q);
    else fp = two_wv - f;
}

// SST's F1 at cell p, and the product g_k . g_omega of the central
// gradients (sst_advance_math, through F1).
template <typename T>
__device__ __forceinline__ T blend(const TGrid<T>& g, const Cell& p, T& gkgo) {
    const T k = kq(g, p), om = omq(g, p), y = yq(g, p);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        T km, kp, om_m, om_p;
        pair<T, false>(g, p, a, k, km, kp);
        pair<T, true>(g, p, a, om, om_m, om_p);
        const T den = g.ax[a].den_c[p.c[a]];
        const T prod = ((kp - km) / den) * ((om_p - om_m) / den);
        gkgo = a == 0 ? prod : gkgo + prod;
    }
    const T cd_omega = lo_clamp(g.p[P_TWO_SO2] / om * gkgo, g.p[P_CD_MIN]);
    T arg1 = nan_max(sqrt(k) / (g.p[P_BETA_STAR] * om * y),
                     g.p[P_500NU] / (y * y * om));
    arg1 = nan_min(arg1, g.p[P_FOUR_SO2] * k / (cd_omega * y * y));
    return safe_tanh(pow(arg1, T(4)));
}

// (nu_k, nu_om) at cell p: nu + sigma * max(nu_t, 0), sigma F1-blended
// (SST) or constant (Wilcox, in the sigma_k1 / sigma_omega1 slots).
template <typename T, bool SST>
__device__ __forceinline__ void nu_eff(const TGrid<T>& g, const Cell& p,
                                       T& nu_k, T& nu_om) {
    const T* c = g.p;
    const T nt = ntq(g, p);
    if (SST) {
        T gkgo;
        const T f1 = blend(g, p, gkgo);
        nu_k = c[P_NU] + (f1 * c[P_SK1] + (T(1) - f1) * c[P_SK2]) * nt;
        nu_om = c[P_NU] + (f1 * c[P_SO1] + (T(1) - f1) * c[P_SO2]) * nt;
    } else {
        nu_k = c[P_NU] + c[P_SK1] * nt;
        nu_om = c[P_NU] + c[P_SO1] * nt;
    }
}

// One axis's term of div(nu_eff grad f) (transport.py _diffusion).
template <typename T>
__device__ __forceinline__ T diff_term(const TAxis<T>& A, int i, T f, T fm,
                                       T fp, T ne, T n_m, T n_p) {
    const T g_lo = (f - fm) * A.inv_dpos[i] * T(0.5) * (n_m + ne);
    const T g_hi = (fp - f) * A.inv_dpos[i + 1] * T(0.5) * (ne + n_p);
    return (g_hi - g_lo) * A.inv_d[i];
}

// (div(nu_k grad k), div(nu_om grad omega)) at p, the centre's
// diffusivities given; each neighbour's pair is evaluated once, there
// (SST: one blend a neighbour), and a wall ghost mirrors the centre's.
template <typename T, bool SST>
__device__ __forceinline__ void diffusion(
        const TGrid<T>& g, const Cell& p, T k, T om, T nu_k, T nu_om,
        const T km[3], const T kp[3], const T om_m[3], const T om_p[3],
        T& diff_k, T& diff_om) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        Cell q;
        T nk_m = nu_k, no_m = nu_om, nk_p = nu_k, no_p = nu_om;
        if (neighbour(g, p, a, -1, q)) nu_eff<T, SST>(g, q, nk_m, no_m);
        if (neighbour(g, p, a, +1, q)) nu_eff<T, SST>(g, q, nk_p, no_p);
        const int i = p.c[a];
        const T tk = diff_term(g.ax[a], i, k, km[a], kp[a], nu_k, nk_m, nk_p);
        const T to = diff_term(g.ax[a], i, om, om_m[a], om_p[a], nu_om, no_m, no_p);
        diff_k = a == 0 ? tk : diff_k + tk;
        diff_om = a == 0 ? to : diff_om + to;
    }
}

// sum over the axes of the first-order upwind advection vel_a df/dx_a
// (transport.py _axis_terms)
template <typename T>
__device__ __forceinline__ T advection(const TGrid<T>& g, const Cell& p, T f,
                                       const T vel[3], const T fm[3],
                                       const T fp[3]) {
    T adv = T(0);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const int i = p.c[a];
        const T back = (f - fm[a]) / g.ax[a].dpos[i];
        const T fwd = (fp[a] - f) / g.ax[a].dpos[i + 1];
        const T term = vel[a] * (vel[a] >= T(0) ? back : fwd);
        adv = a == 0 ? term : adv + term;
    }
    return adv;
}

template <typename T, int MODEL>
__global__ void transport_kernel(TGrid<T> g, const T* __restrict__ dt_ptr,
                                 const T* __restrict__ pin,
                                 const T* __restrict__ om_visc,
                                 T* __restrict__ k_out, T* __restrict__ om_out,
                                 T* __restrict__ nut_out) {
    constexpr bool SST = MODEL != 2;
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= static_cast<long long>(nx) * ny * nz) return;
    Cell p;
    p.c[2] = static_cast<int>(idx % nz);
    const long long r = idx / nz;
    p.c[1] = static_cast<int>(r % ny);
    p.c[0] = static_cast<int>(r / ny);
    const T* c = g.p;
    const T dt = *dt_ptr;

    const T k = kq(g, p), om = omq(g, p), nt = ntq(g, p);
    T G[3][3], S[3][3], vel[3];
    g.les.gradient(p.c[0], p.c[1], p.c[2], G);
    const T smag = cfdnn::strain(G, S);
    const T s2 = smag * smag;
    g.les.centre(p.c[0], p.c[1], p.c[2], vel);

    T km[3], kp[3], om_m[3], om_p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        pair<T, false>(g, p, a, k, km[a], kp[a]);
        pair<T, true>(g, p, a, om, om_m[a], om_p[a]);
    }
    const T adv_k = advection(g, p, k, vel, km, kp);
    const T adv_om = advection(g, p, om, vel, om_m, om_p);
    const T p_k = nan_min(nt * s2, c[P_TEN_BS] * k * om);

    T k_new, om_new, diff_k, diff_om;
    if (SST) {
        T gkgo;
        const T f1 = blend(g, p, gkgo);
        const T beta = f1 * c[P_BETA1] + (T(1) - f1) * c[P_BETA2];
        const T alpha = f1 * c[P_ALPHA1] + (T(1) - f1) * c[P_ALPHA2];
        const T nu_k = c[P_NU] + (f1 * c[P_SK1] + (T(1) - f1) * c[P_SK2]) * nt;
        const T nu_om = c[P_NU] + (f1 * c[P_SO1] + (T(1) - f1) * c[P_SO2]) * nt;
        const T cd = lo_clamp(T(2) * (T(1) - f1) * c[P_SO2] / om * gkgo, T(0));
        diffusion<T, true>(g, p, k, om, nu_k, nu_om, km, kp, om_m, om_p,
                           diff_k, diff_om);
        const T src_k = p_k + diff_k - adv_k;
        const T src_om = alpha * (om / k) * p_k + diff_om - adv_om + cd;
        k_new = (k + dt * src_k) / (T(1) + dt * c[P_BETA_STAR] * om);
        om_new = (om + dt * src_om) / (T(1) + dt * beta * om);
    } else {
        T nu_k, nu_om;
        nu_eff<T, false>(g, p, nu_k, nu_om);
        diffusion<T, false>(g, p, k, om, nu_k, nu_om, km, kp, om_m, om_p,
                            diff_k, diff_om);
        const T src_k = p_k + diff_k - adv_k;
        const T src_om = c[P_ALPHA1] * (om / k) * p_k + diff_om - adv_om;
        k_new = (k + dt * src_k) / (T(1) + dt * c[P_BETA_STAR] * om);
        om_new = (om + dt * src_om) / (T(1) + dt * c[P_BETA1] * om);
    }
    k_out[idx] = k_new;
    om_out[idx] = om_new;
    if (MODEL == 1) {
        // the epilogue on the values the closure sees, then sst_nut_math
        const long long plane = static_cast<long long>(p.c[1]) * nz + p.c[2];
        const T kc = hi_clamp(lo_clamp(k_new, c[P_K_MIN]), c[P_K_MAX]);
        T oc = hi_clamp(lo_clamp(om_new, c[P_OM_MIN]), c[P_OM_MAX]);
        if (pin != nullptr && pin[plane] > T(0.5)) oc = om_visc[plane];
        const T k2 = lo_clamp(kc, c[P_K_MIN]);
        const T o2 = lo_clamp(oc, c[P_OM_MIN]);
        const T y = yq(g, p);
        const T arg2 = nan_max(T(2) * sqrt(k2) / (c[P_BETA_STAR] * o2 * y),
                               c[P_500NU] / (y * y * o2));
        const T f2 = safe_tanh(arg2 * arg2);
        const T nut = c[P_A1] * k2 / nan_max(c[P_A1] * o2, smag * f2);
        nut_out[idx] = hi_clamp(lo_clamp(nut, T(0)), c[P_1000NU]);
    }
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* k,
           const void* om, const void* nut, const void* dt, const void* y_wall,
           const void* pin, const void* om_visc, void* k_out, void* om_out,
           void* nut_out, const void* const* metrics, const double* params,
           int nx, int ny, int nz, int wall_y, int wall_z, int model,
           void* stream) {
    // every axis has a neighbour on each side (the gate: 3-D, n > 1)
    if (nx < 2 || ny < 2 || nz < 2 || model < 0 || model > 2
            || (model == 1 && nut_out == nullptr)
            || ((pin == nullptr) != (om_visc == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    TGrid<T> g;
    const int n[3] = {nx, ny, nz};
    const int wall[3] = {0, wall_y, wall_z};
    for (int a = 0; a < 3; ++a) {
        const void* const* m = metrics + 4 * a;
        g.ax[a].inv_d = static_cast<const T*>(m[0]);
        g.ax[a].den_c = static_cast<const T*>(m[1]);
        g.ax[a].dpos = static_cast<const T*>(m[2]);
        g.ax[a].inv_dpos = static_cast<const T*>(m[3]);
        g.ax[a].n = n[a];
        g.ax[a].wall = wall[a];
    }
    g.les = LesGrid<T>{static_cast<const T*>(u), static_cast<const T*>(v),
                       static_cast<const T*>(w), g.ax[0].inv_d, g.ax[1].inv_d,
                       g.ax[2].inv_d, g.ax[0].den_c, g.ax[1].den_c,
                       g.ax[2].den_c, nx, ny, nz, wall_y, wall_z};
    g.k = static_cast<const T*>(k);
    g.om = static_cast<const T*>(om);
    g.nut = static_cast<const T*>(nut);
    g.y_wall = static_cast<const T*>(y_wall);
    for (int i = 0; i < P_COUNT; ++i) g.p[i] = T(params[i]);
    const T* d = static_cast<const T*>(dt);
    const T* pn = static_cast<const T*>(pin);
    const T* ov = static_cast<const T*>(om_visc);
    T* ko = static_cast<T*>(k_out);
    T* oo = static_cast<T*>(om_out);
    T* no = static_cast<T*>(nut_out);
    const long long cells = static_cast<long long>(nx) * ny * nz;
    const unsigned blocks = cfdnn::blocks_for(cells);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (model) {
        case 0: transport_kernel<T, 0><<<blocks, cfdnn::kBlock, 0, s>>>(g, d, pn, ov, ko, oo, no); break;
        case 1: transport_kernel<T, 1><<<blocks, cfdnn::kBlock, 0, s>>>(g, d, pn, ov, ko, oo, no); break;
        default: transport_kernel<T, 2><<<blocks, cfdnn::kBlock, 0, s>>>(g, d, pn, ov, ko, oo, no); break;
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_transport_f32(
        const void* u, const void* v, const void* w, const void* k,
        const void* om, const void* nut, const void* dt, const void* y_wall,
        const void* pin, const void* om_visc, void* k_out, void* om_out,
        void* nut_out, const void* const* metrics, const double* params,
        int nx, int ny, int nz, int wall_y, int wall_z, int model,
        void* stream) {
    return launch<float>(u, v, w, k, om, nut, dt, y_wall, pin, om_visc, k_out,
                         om_out, nut_out, metrics, params, nx, ny, nz, wall_y,
                         wall_z, model, stream);
}

extern "C" int cfdnn_transport_f64(
        const void* u, const void* v, const void* w, const void* k,
        const void* om, const void* nut, const void* dt, const void* y_wall,
        const void* pin, const void* om_visc, void* k_out, void* om_out,
        void* nut_out, const void* const* metrics, const double* params,
        int nx, int ny, int nz, int wall_y, int wall_z, int model,
        void* stream) {
    return launch<double>(u, v, w, k, om, nut, dt, y_wall, pin, om_visc, k_out,
                          om_out, nut_out, metrics, params, nx, ny, nz, wall_y,
                          wall_z, model, stream);
}
