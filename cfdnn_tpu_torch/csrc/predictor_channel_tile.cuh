// predictor_channel: the channel predictor on an (x, z) tile walked along
// y.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_channel (body
// _channel_kernel, math predictor_slab_math_channel, y-metrics
// _channel_y_arrays), both of its branches: nut_e=None (nut == nullptr
// here) and the cell nu_t operand of the LES closures. The plain PyTorch
// twin is ops/kernels.py predictor_channel_twin. The predictor +
// divergence kernel (fused_predictor_channel_div) runs these stars on a
// window with a two-cell high halo: predictor_channel_div_tile.cuh.
//
// Grid: periodic uniform x and z, no-slip walls in y at any stretching, O2
// skew or central, scalar nu or nu + a cell nu_t.
// Shapes: u, w, nut (nx, ny, nz); v (nx, ny+1, nz) with the wall faces
// stored. y-metrics (device vectors): inv_dy (ny), inv_dyc (ny+1),
// inv_dgy (ny+1), inv2_cy (ny), inv2_fy (ny+1).
// Wall ghosts, each as the twin builds them:
//   u, w tangential  -> -interior (odd reflection to 0 at the wall)
//   v normal         -> 2 v_wall - v_next (linear extrapolation)
//   cell quantities  -> mirror copy (phi_c of skew v, the v diffusion flux,
//                       nu + nu_t)
// With nu_t, the viscosity is taken at the cells along each component's
// own axis and averaged to the transverse faces flux direction first, then
// the component's axis, in the order of ops.operators.diffusive.
//
// The stars are the slab kernel's star_u, star_w and star_v, term for
// term and in the same order of evaluation, rewritten over offsets from
// the thread's point: on the staged window (xz_tile.cuh) a neighbour is
// always one step away, so each operand is one shared-memory load at a
// fixed offset, with no wrap_m/wrap_p and no 64-bit at3. The wall ghosts
// (the odd reflection of u and w, 2 v_wall - v_next, the clamped cells
// below and above a face, mirrored nu + nu_t) are compiled only into the
// planes next to a wall (EDGE): by the slab kernel's code those are
// j = 0, ny - 1 and ny, the only planes where wall_t, nu_e or jc_lo/jc_hi
// reach beyond the stored rows. 1/hx and 1/hz are host scalars; the y
// metrics are read by global row, the same for the whole block.
//
// Bound on the H100: device-memory bandwidth (u, v, w in, three stars
// out: 24 bytes a cell in float32, ~150-170 flops; nu_t 4 bytes and ~140
// flops more). Design: a block of 8 x 32 threads stages its tile plus a
// one-cell x/z halo (corners included), 10 x 34 points of each field and
// plane, and walks ny + 1 planes (v's faces) in chunks, the next planes
// copied by cp.async (two in flight in float32); at plane j < ny a thread
// writes star u and star w of cell j and star v of face j, at j = ny star
// v only. The launcher picks the chunk of planes a block walks
// (tile_plan.cuh: the longest, at most xz::kChunk, that still gives the
// card two waves of blocks, and not under 8 planes), so that a 128^3 grid
// fills the card. float32 runs at four blocks an SM, float64 at two. What
// holds it
// then is instruction issue: the interior body is ~175 instructions a
// point (27 shared-memory loads, ~120 float), the plane's copy ~100 more.
//
// The float and double entry points are compiled apart
// (predictor_channel_tile.cu, predictor_channel_tile_f64.cu).
#pragma once

#include "xz_tile.cuh"

namespace {

using cfdnn::xz::Window;

// The stars at the thread's point on the staged window r (u, v, w, nu_t:
// fields 0 ... 3), at plane j. x and z are periodic and
// staged wrapped; unless EDGE every y offset stays inside the stored rows.
template <typename T, bool NUT, bool SKEW, bool EDGE, typename View>
struct ChannelTile {
    View r;
    const T* __restrict__ inv_dy;
    const T* __restrict__ inv_dyc;
    const T* __restrict__ inv_dgy;
    const T* __restrict__ inv2_cy;
    const T* __restrict__ inv2_fy;
    int j, ny;
    T ihx, ihz, nu;

    __device__ __forceinline__ T U(int di, int dj, int dk) const {
        return r.template at<0>(di, dj, dk);
    }
    __device__ __forceinline__ T V(int di, int dj, int dk) const {
        return r.template at<1>(di, dj, dk);
    }
    __device__ __forceinline__ T W(int di, int dj, int dk) const {
        return r.template at<2>(di, dj, dk);
    }

    // wall_t: u or w (C = 0, 2) at row j + dj in [-1, ny], the odd
    // reflection of the first or last row beyond a wall
    template <int C>
    __device__ __forceinline__ T wall_t(int di, int dj, int dk) const {
        if (EDGE) {
            if (j + dj < 0) return -r.template at<C>(di, -j, dk);
            if (j + dj >= ny) return -r.template at<C>(di, ny - 1 - j, dk);
        }
        return r.template at<C>(di, dj, dk);
    }

    // nu_e: nu + nu_t at cell row j + dj, mirrored beyond the walls
    __device__ __forceinline__ T ne(int di, int dj, int dk) const {
        if (EDGE) {
            const int jj = j + dj;
            dj = jj < 0 ? -j : (jj >= ny ? ny - 1 - j : dj);
        }
        return nu + r.template at<3>(di, dj, dk);
    }

    // ---- u (x-face, y-center, z-center) star, j < ny ------------------
    __device__ __forceinline__ T star_u(T dt, T fx) const {
        const T h = T(0.5), two = T(2);
        const T c = U(0, 0, 0);
        const T xp = U(1, 0, 0), xm = U(-1, 0, 0);
        const T zp = U(0, 0, 1), zm = U(0, 0, -1);
        const T yp = wall_t<0>(0, 1, 0);
        const T ym = wall_t<0>(0, -1, 0);
        // v at (x-face, y-face j / j+1), w at (x-face, z-face k / k+1)
        const T ve_lo = h * (V(-1, 0, 0) + V(0, 0, 0));
        const T ve_hi = h * (V(-1, 1, 0) + V(0, 1, 0));
        const T we_lo = h * (W(-1, 0, 0) + W(0, 0, 0));
        const T we_hi = h * (W(-1, 0, 1) + W(0, 0, 1));
        T conv;
        if constexpr (SKEW) {
            conv = h * ((h * (c + xp)) * xp - (h * (xm + c)) * xm) * ihx;
            conv += h * (ve_hi * yp - ve_lo * ym) * inv_dy[j];
            conv += h * (we_hi * zp - we_lo * zm) * ihz;
        } else {
            conv = c * (xp - xm) * (h * ihx);
            conv += (h * (ve_lo + ve_hi)) * (yp - ym) * inv2_cy[j];
            conv += (h * (we_lo + we_hi)) * (zp - zm) * (h * ihz);
        }
        T lap;
        if constexpr (!NUT) {
            const T f_lo = nu * ((c - ym) * inv_dgy[j]);
            const T f_hi = nu * ((yp - c) * inv_dgy[j + 1]);
            lap = nu * (xp - two * c + xm) * ihx * ihx
                + (f_hi - f_lo) * inv_dy[j]
                + nu * (zp - two * c + zm) * ihz * ihz;
        } else {
            // x (own axis): the cells on either side of face i
            const T fx_hi = ne(0, 0, 0) * (xp - c) * ihx;
            const T fx_lo = ne(-1, 0, 0) * (c - xm) * ihx;
            // y faces j, j+1: y mirror-average, then x-average
            const T ny_lo = h * (h * (ne(-1, -1, 0) + ne(-1, 0, 0))
                               + h * (ne(0, -1, 0) + ne(0, 0, 0)));
            const T ny_hi = h * (h * (ne(-1, 0, 0) + ne(-1, 1, 0))
                               + h * (ne(0, 0, 0) + ne(0, 1, 0)));
            const T fy_lo = ny_lo * ((c - ym) * inv_dgy[j]);
            const T fy_hi = ny_hi * ((yp - c) * inv_dgy[j + 1]);
            // z faces k, k+1: z-average, then x-average
            const T nz_lo = h * (h * (ne(-1, 0, -1) + ne(-1, 0, 0))
                               + h * (ne(0, 0, -1) + ne(0, 0, 0)));
            const T nz_hi = h * (h * (ne(-1, 0, 0) + ne(-1, 0, 1))
                               + h * (ne(0, 0, 0) + ne(0, 0, 1)));
            const T fz_lo = nz_lo * (c - zm) * ihz;
            const T fz_hi = nz_hi * (zp - c) * ihz;
            lap = (fx_hi - fx_lo) * ihx + (fy_hi - fy_lo) * inv_dy[j]
                + (fz_hi - fz_lo) * ihz;
        }
        return c + dt * (-conv + lap + fx);
    }

    // ---- w (z-face, y-center) star, j < ny ----------------------------
    __device__ __forceinline__ T star_w(T dt) const {
        const T h = T(0.5), two = T(2);
        const T cw = W(0, 0, 0);
        const T wxp = W(1, 0, 0), wxm = W(-1, 0, 0);
        const T wzp = W(0, 0, 1), wzm = W(0, 0, -1);
        const T wyp = wall_t<2>(0, 1, 0);
        const T wym = wall_t<2>(0, -1, 0);
        // u at (x-face, z-face), v at (y-face, z-face)
        const T ue_lo = h * (U(0, 0, -1) + U(0, 0, 0));
        const T ue_hi = h * (U(1, 0, -1) + U(1, 0, 0));
        const T vw_lo = h * (V(0, 0, -1) + V(0, 0, 0));
        const T vw_hi = h * (V(0, 1, -1) + V(0, 1, 0));
        T convw;
        if constexpr (SKEW) {
            convw = h * ((h * (cw + wzp)) * wzp - (h * (wzm + cw)) * wzm) * ihz;
            convw += h * (ue_hi * wxp - ue_lo * wxm) * ihx;
            convw += h * (vw_hi * wyp - vw_lo * wym) * inv_dy[j];
        } else {
            convw = cw * (wzp - wzm) * (h * ihz);
            convw += (h * (ue_lo + ue_hi)) * (wxp - wxm) * (h * ihx);
            convw += (h * (vw_lo + vw_hi)) * (wyp - wym) * inv2_cy[j];
        }
        T lapw;
        if constexpr (!NUT) {
            const T g_lo = nu * ((cw - wym) * inv_dgy[j]);
            const T g_hi = nu * ((wyp - cw) * inv_dgy[j + 1]);
            lapw = nu * (wxp - two * cw + wxm) * ihx * ihx
                 + (g_hi - g_lo) * inv_dy[j]
                 + nu * (wzp - two * cw + wzm) * ihz * ihz;
        } else {
            // z (own axis): the cells on either side of face k
            const T fz_hi = ne(0, 0, 0) * (wzp - cw) * ihz;
            const T fz_lo = ne(0, 0, -1) * (cw - wzm) * ihz;
            // x faces i, i+1: x-average, then z-average
            const T nx_lo = h * (h * (ne(-1, 0, -1) + ne(0, 0, -1))
                               + h * (ne(-1, 0, 0) + ne(0, 0, 0)));
            const T nx_hi = h * (h * (ne(0, 0, -1) + ne(1, 0, -1))
                               + h * (ne(0, 0, 0) + ne(1, 0, 0)));
            const T fx_lo = nx_lo * ((cw - wxm) * ihx);
            const T fx_hi = nx_hi * ((wxp - cw) * ihx);
            // y faces j, j+1: y mirror-average, then z-average
            const T ny_lo = h * (h * (ne(0, -1, -1) + ne(0, 0, -1))
                               + h * (ne(0, -1, 0) + ne(0, 0, 0)));
            const T ny_hi = h * (h * (ne(0, 0, -1) + ne(0, 1, -1))
                               + h * (ne(0, 0, 0) + ne(0, 1, 0)));
            const T fy_lo = ny_lo * ((cw - wym) * inv_dgy[j]);
            const T fy_hi = ny_hi * ((wyp - cw) * inv_dgy[j + 1]);
            lapw = (fx_hi - fx_lo) * ihx + (fy_hi - fy_lo) * inv_dy[j]
                 + (fz_hi - fz_lo) * ihz;
        }
        return cw + dt * (-convw + lapw);
    }

    // ---- v (y-face j of ny+1, wall faces included) star ---------------
    __device__ __forceinline__ T star_v(T dt) const {
        const T h = T(0.5), two = T(2);
        const T c = V(0, 0, 0);
        const T xp = V(1, 0, 0), xm = V(-1, 0, 0);
        const T zp = V(0, 0, 1), zm = V(0, 0, -1);
        // odd-reflection normal pad: 2 v_wall - v_next beyond each wall
        const T np_ = (EDGE && j == ny) ? two * V(0, 0, 0) - V(0, -1, 0)
                                        : V(0, 1, 0);
        const T nm_ = (EDGE && j == 0) ? two * V(0, 0, 0) - V(0, 1, 0)
                                       : V(0, -1, 0);
        // u and w interpolated to y-face j from the wall-padded cell rows
        const T ue_lo = h * (wall_t<0>(0, -1, 0) + wall_t<0>(0, 0, 0));
        const T ue_hi = h * (wall_t<0>(1, -1, 0) + wall_t<0>(1, 0, 0));
        const T wy_lo = h * (wall_t<2>(0, -1, 0) + wall_t<2>(0, 0, 0));
        const T wy_hi = h * (wall_t<2>(0, -1, 1) + wall_t<2>(0, 0, 1));
        // cells jc_hi = j (above the face) and jc_lo = j-1 (below),
        // clamped to the stored rows at the walls, as offsets from j
        const int dh = (EDGE && j >= ny - 1) ? ny - 1 - j : 0;
        const int dl = (EDGE && j == 0) ? 0 : -1;
        T conv;
        if constexpr (SKEW) {
            const T c_hi = h * (V(0, dh, 0) + V(0, dh + 1, 0));
            const T c_lo = h * (V(0, dl, 0) + V(0, dl + 1, 0));
            conv = h * (c_hi * np_ - c_lo * nm_) * inv_dyc[j];
            conv += h * (ue_hi * xp - ue_lo * xm) * ihx;
            conv += h * (wy_hi * zp - wy_lo * zm) * ihz;
        } else {
            conv = c * (np_ - nm_) * inv2_fy[j];
            conv += (h * (ue_lo + ue_hi)) * (xp - xm) * (h * ihx);
            conv += (h * (wy_lo + wy_hi)) * (zp - zm) * (h * ihz);
        }
        T lap;
        if constexpr (!NUT) {
            const T f_hi = nu * ((V(0, dh + 1, 0) - V(0, dh, 0)) * inv_dy[j + dh]);
            const T f_lo = nu * ((V(0, dl + 1, 0) - V(0, dl, 0)) * inv_dy[j + dl]);
            lap = nu * (xp - two * c + xm) * ihx * ihx
                + (f_hi - f_lo) * inv_dyc[j]
                + nu * (zp - two * c + zm) * ihz * ihz;
        } else {
            // y (own axis): the mirrored cell fluxes above and below face j
            const T f_hi = ne(0, dh, 0)
                           * ((V(0, dh + 1, 0) - V(0, dh, 0)) * inv_dy[j + dh]);
            const T f_lo = ne(0, dl, 0)
                           * ((V(0, dl + 1, 0) - V(0, dl, 0)) * inv_dy[j + dl]);
            // x faces i, i+1: x-average, then y mirror-average
            const T nx_lo = h * (h * (ne(-1, -1, 0) + ne(0, -1, 0))
                               + h * (ne(-1, 0, 0) + ne(0, 0, 0)));
            const T nx_hi = h * (h * (ne(0, -1, 0) + ne(1, -1, 0))
                               + h * (ne(0, 0, 0) + ne(1, 0, 0)));
            const T fx_lo = nx_lo * ((c - xm) * ihx);
            const T fx_hi = nx_hi * ((xp - c) * ihx);
            // z faces k, k+1: z-average, then y mirror-average
            const T nz_lo = h * (h * (ne(0, -1, -1) + ne(0, -1, 0))
                               + h * (ne(0, 0, -1) + ne(0, 0, 0)));
            const T nz_hi = h * (h * (ne(0, -1, 0) + ne(0, -1, 1))
                               + h * (ne(0, 0, 0) + ne(0, 0, 1)));
            const T fz_lo = nz_lo * (c - zm) * ihz;
            const T fz_hi = nz_hi * (zp - c) * ihz;
            lap = (fx_hi - fx_lo) * ihx + (f_hi - f_lo) * inv_dyc[j]
                + (fz_hi - fz_lo) * ihz;
        }
        return c + dt * (-conv + lap);
    }
};

// float32 at four blocks an SM (<= 64 registers a thread, no spill; three
// blocks at <= 80 registers ran 1.04x slower at 512^3), float64 at two
template <typename T>
constexpr int kChannelMinBlocks = sizeof(T) == 4 ? 4 : 2;
// the planes in flight: two in float32 (one ran 1.09x slower at 512^3),
// one in float64 (five slots of four float64 fields would pass the 48 KB
// of static shared memory)
template <typename T>
constexpr int kChannelAhead = sizeof(T) == 4 ? 2 : 1;

template <typename T, bool NUT, bool SKEW>
__global__ void __launch_bounds__(cfdnn::xz::kThreads, kChannelMinBlocks<T>)
predictor_channel_tile_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ dt_ptr,
        const T* __restrict__ inv_dy, const T* __restrict__ inv_dyc,
        const T* __restrict__ inv_dgy, const T* __restrict__ inv2_cy,
        const T* __restrict__ inv2_fy, const T* __restrict__ nut,
        T* __restrict__ su, T* __restrict__ sv, T* __restrict__ sw,
        int nx, int ny, int nz, T ihx, T ihz, T nu, T fx, int chunk) {
    constexpr int NF = NUT ? 4 : 3;
    using Win = Window<T, NF, 1, 1, kChannelAhead<T>>;
    using View = typename Win::View;
    __shared__ T buf[Win::kSize];
    Win win;
    win.init(buf, nx, ny, nz, 1, ny + 1, chunk);
    win.field(0, u, ny);
    win.field(1, v, ny + 1);
    win.field(2, w, ny);
    if constexpr (NUT) win.field(3, nut, ny);
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    // the three stars of a point are computed before any is stored, so
    // that an operand two stars read is loaded once; at j = ny (`cells`
    // false) only star v
    auto stars = [&](const auto& t, int j, bool cells) {
        const int f = (i * (ny + 1) + j) * nz + k;
        if (cells) {
            const T s_u = t.star_u(dt, fx);
            const T s_w = t.star_w(dt);
            const T s_v = t.star_v(dt);
            const int c = (i * ny + j) * nz + k;
            su[c] = s_u;
            sw[c] = s_w;
            sv[f] = s_v;
        } else {
            sv[f] = t.star_v(dt);
        }
    };
    win.walk([&](const View& r) {
        if (!owns) return;
        const int j = r.j;
        if (j == 0 || j >= ny - 1)
            stars(ChannelTile<T, NUT, SKEW, true, View>{
                      r, inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy, j, ny,
                      ihx, ihz, nu}, j, j < ny);
        else
            stars(ChannelTile<T, NUT, SKEW, false, View>{
                      r, inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy, j, ny,
                      ihx, ihz, nu}, j, true);
    });
}

template <typename T, bool NUT, bool SKEW>
void launch_tile(long long tiles, const void* u, const void* v,
                 const void* w, const void* dt, const void* inv_dy,
                 const void* inv_dyc, const void* inv_dgy,
                 const void* inv2_cy, const void* inv2_fy, const void* nut,
                 void* su, void* sv, void* sw, int nx, int ny, int nz,
                 double ihx, double ihz, double nu, double fx,
                 cudaStream_t stream) {
    const int chunk = cfdnn::walk_chunk<
        predictor_channel_tile_kernel<T, NUT, SKEW>, cfdnn::xz::kThreads>(
        tiles, ny + 1);
    predictor_channel_tile_kernel<T, NUT, SKEW>
        <<<cfdnn::xz::grid(nx, nz, ny + 1, chunk), cfdnn::xz::kThreads, 0,
           stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(dt),
        static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dyc),
        static_cast<const T*>(inv_dgy), static_cast<const T*>(inv2_cy),
        static_cast<const T*>(inv2_fy), static_cast<const T*>(nut),
        static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw),
        nx, ny, nz, T(ihx), T(ihz), T(nu), T(fx), chunk);
}

// The entry's body: refuses (cudaErrorInvalidValue) what the tile does
// not take (xz::fits: nx >= 8, 32-bit offsets) and a channel of fewer than
// two cells in y.
template <typename T>
int launch(const void* u, const void* v, const void* w, const void* dt,
           const void* inv_dy, const void* inv_dyc, const void* inv_dgy,
           const void* inv2_cy, const void* inv2_fy, const void* nut,
           void* su, void* sv, void* sw, int nx, int ny, int nz,
           double ihx, double ihz, double nu, double fx, int skew,
           void* stream) {
    static_assert(cfdnn::plan::kChunkMax == cfdnn::xz::kChunk,
                  "the picked chunks are at most the xz kernels' chunk");
    if (ny < 2 || !cfdnn::xz::fits(nx, ny + 1, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles = cfdnn::xz::grid(nx, nz, 1).x;   // of a plane
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CFDNN_TILE_ARGS u, v, w, dt, inv_dy, inv_dyc, inv_dgy, inv2_cy, \
    inv2_fy, nut, su, sv, sw, nx, ny, nz, ihx, ihz, nu, fx, s
    if (nut) {
        if (skew) launch_tile<T, true, true>(tiles, CFDNN_TILE_ARGS);
        else launch_tile<T, true, false>(tiles, CFDNN_TILE_ARGS);
    } else {
        if (skew) launch_tile<T, false, true>(tiles, CFDNN_TILE_ARGS);
        else launch_tile<T, false, false>(tiles, CFDNN_TILE_ARGS);
    }
#undef CFDNN_TILE_ARGS
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
