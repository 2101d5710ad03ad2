// predictor_channel_div: the fused Euler momentum predictor of the wall-y
// channel (periodic uniform x and z, no-slip walls in y at any stretching,
// O2 skew or central convection, scalar nu or nu + a cell eddy viscosity
// nu_t) that also zeroes v's wall faces and writes the divergence of its
// star in the same pass: the DIV instantiation of the slab kernel below.
// Its DIV = false instantiation, the channel predictor of the main path,
// is no longer compiled: predictor_channel_tile.cuh runs that function
// (these star_u, star_w, star_v over offsets on an (x, z) tile walked
// along y), and this file keeps the slab kernel's text for the DIV
// instantiation only, which stays the kernel of before, instruction for
// instruction (sass_compare.py).
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_channel_div
// (body _channel_div_kernel; the predictor's math is fused_predictor_channel's:
// _channel_kernel, predictor_slab_math_channel, _channel_y_arrays), both of
// its branches: nut_e=None (nut == nullptr here) and the cell nu_t operand
// of the LES closures. The plain PyTorch twin is ops/kernels.py
// predictor_channel_div_twin.
//
// Shapes: u, w, nut, div (nx, ny, nz); v (nx, ny+1, nz) with the wall faces
// stored. y-metrics (device vectors): inv_dy (ny), inv_dyc (ny+1),
// inv_dgy (ny+1), inv2_cy (ny), inv2_fy (ny+1).
// Wall ghosts, each as the twin builds them:
//   u, w tangential  -> -interior (odd reflection to 0 at the wall)
//   v normal         -> 2 v_wall - v_next (linear extrapolation)
//   cell quantities  -> mirror copy (phi_c of skew v, the v diffusion flux,
//                       nu + nu_t)
// With nu_t, the viscosity is taken at the cells along each component's
// own axis and averaged to the transverse faces flux direction first, then
// the component's axis, in the order of ops.operators.diffusive: the face
// values below are spelled out in that order.
// Without DIV (the template's other branch, not instantiated here), star v
// is computed at the wall faces too, exactly as the twin computes it.
//
// Bound on the H100: device-memory bandwidth (three fields in, three out,
// ~200 flops a cell; with nu_t one more field in and ~150 more flops; DIV
// one more field out and the flops of three more one-component stars).
// Design: one thread per (i, j_face, k) point of the v grid, z fastest
// within a warp; threads with j < ny also produce u and w (and with DIV the
// divergence) at (i, j, k). Periodic x/z wrap by index arithmetic; the wall
// ghosts are formed in registers from the interior values, so no padded
// copy is ever written. nu_t is read at i-1, k-1 and j+-1 (mirrored at the
// walls) besides the point itself: the same rows the velocity stencils
// touch, so L1/L2 serve them. Whether nu_t is there and whether the
// divergence is written are template parameters, and the divergence's
// output pointer is the kernel's last parameter.
//
// Where the DIV instantiation could go wrong, and what it does:
//   1. The divergence of cell (i, j, k) needs the star u at (i+1, j, k),
//      v at (i, j+1, k) and w at (i, j, k+1), which other threads (in
//      other blocks) write; a block cannot wait on another. So each thread
//      with j < ny also evaluates those three one-component stars itself.
//      Each component's star is written once, as a __forceinline__
//      function of (i, j, k) (star_u, star_v, star_w), called at the
//      thread's own point and at the +1 neighbour, so that the recomputed
//      value is the same arithmetic as the neighbour's stored one. nvcc may
//      still contract the two inlined copies into FMAs differently, so
//      chip_smoke.py holds the div output against the divergence kernel of
//      this kernel's own star output. x and z wrap; in y the face j+1 = ny
//      is the wall, whose star v is 0.
//   2. v's wall faces: with DIV the kernel writes star v = 0 at j = 0 and
//      j = ny itself, as the TPU kernel does, and the divergence reads
//      those zeros; the solver's BC pass afterwards is idempotent. The
//      threads at j = ny write only that zero, and only threads with
//      j < ny write div.
//   3. Metrics: 1/hx and 1/hz are host scalars and the y-metric is the
//      inv_dy vector, as in the TPU kernel; the twin divides by the
//      geometry's inv_d vectors, which on the uniform x and z equal 1/h
//      only to roundoff.
//   4. dt stays on the device (dt_ptr): under adaptive dt it is a new 0-d
//      tensor every step and is never read on the host.
//   5. The TPU kernel's asymmetric x-halo (bx+1 star planes per slab) is
//      not ported: it exists for the slab.
#include "common.cuh"

namespace {

using cfdnn::at3;
using cfdnn::wrap_m;
using cfdnn::wrap_p;

// Tangential wall pad of a (nx, ny, nz) field at row jj in [-1, ny].
template <typename T>
__device__ __forceinline__ T wall_t(const T* __restrict__ f, int i, int jj,
                                    int k, int ny, int nz) {
    if (jj < 0) return -f[at3(i, 0, k, ny, nz)];
    if (jj >= ny) return -f[at3(i, ny - 1, k, ny, nz)];
    return f[at3(i, jj, k, ny, nz)];
}

// nu + nu_t at cell (i, jj, k), jj in [-1, ny]: mirrored beyond the walls
// (pad_center neumann).
template <typename T>
__device__ __forceinline__ T nu_e(const T* __restrict__ nut, T nu, int i,
                                  int jj, int k, int ny, int nz) {
    const int j = jj < 0 ? 0 : (jj >= ny ? ny - 1 : jj);
    return nu + nut[at3(i, j, k, ny, nz)];
}

// The fields, metrics and scalars every star reads, as one parameter list.
#define CH_PARAMS                                                            \
    const T* __restrict__ u, const T* __restrict__ v,                        \
    const T* __restrict__ w, const T* __restrict__ nut,                      \
    const T* __restrict__ inv_dy, const T* __restrict__ inv_dyc,             \
    const T* __restrict__ inv_dgy, const T* __restrict__ inv2_cy,            \
    const T* __restrict__ inv2_fy, int nx, int ny, int nz, T ihx, T ihz,     \
    T nu, T fx, T dt, int skew
#define CH_ARGS u, v, w, nut, inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy, \
    nx, ny, nz, ihx, ihz, nu, fx, dt, skew

#define U(I, J, K) u[at3(I, J, K, ny, nz)]
#define W(I, J, K) w[at3(I, J, K, ny, nz)]
#define V(I, J, K) v[at3(I, J, K, ny + 1, nz)]
#define NE(I, J, K) nu_e(nut, nu, I, J, K, ny, nz)

// ---- u (x-face, y-center, z-center) star at (i, j, k), j < ny -----------
template <typename T, bool NUT>
__device__ __forceinline__ T star_u(CH_PARAMS, int i, int j, int k) {
    const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
    const int km = wrap_m(k, nz), kp = wrap_p(k, nz);
    const T h = T(0.5), two = T(2);
    const T c = U(i, j, k);
    const T xp = U(ip, j, k), xm = U(im, j, k);
    const T zp = U(i, j, kp), zm = U(i, j, km);
    const T yp = wall_t(u, i, j + 1, k, ny, nz);
    const T ym = wall_t(u, i, j - 1, k, ny, nz);
    // v at (x-face, y-face j / j+1), w at (x-face, z-face k / k+1)
    const T ve_lo = h * (V(im, j, k) + V(i, j, k));
    const T ve_hi = h * (V(im, j + 1, k) + V(i, j + 1, k));
    const T we_lo = h * (W(im, j, k) + W(i, j, k));
    const T we_hi = h * (W(im, j, kp) + W(i, j, kp));
    T conv;
    if (skew) {
        conv = h * ((h * (c + xp)) * xp - (h * (xm + c)) * xm) * ihx;
        conv += h * (ve_hi * yp - ve_lo * ym) * inv_dy[j];
        conv += h * (we_hi * zp - we_lo * zm) * ihz;
    } else {
        conv = c * (xp - xm) * (h * ihx);
        conv += (h * (ve_lo + ve_hi)) * (yp - ym) * inv2_cy[j];
        conv += (h * (we_lo + we_hi)) * (zp - zm) * (h * ihz);
    }
    T lap;
    if (!NUT) {
        const T f_lo = nu * ((c - ym) * inv_dgy[j]);
        const T f_hi = nu * ((yp - c) * inv_dgy[j + 1]);
        lap = nu * (xp - two * c + xm) * ihx * ihx
            + (f_hi - f_lo) * inv_dy[j]
            + nu * (zp - two * c + zm) * ihz * ihz;
    } else {
        // x (own axis): the cells on either side of face i
        const T fx_hi = NE(i, j, k) * (xp - c) * ihx;
        const T fx_lo = NE(im, j, k) * (c - xm) * ihx;
        // y faces j, j+1: y mirror-average, then x-average
        const T ny_lo = h * (h * (NE(im, j - 1, k) + NE(im, j, k))
                           + h * (NE(i, j - 1, k) + NE(i, j, k)));
        const T ny_hi = h * (h * (NE(im, j, k) + NE(im, j + 1, k))
                           + h * (NE(i, j, k) + NE(i, j + 1, k)));
        const T fy_lo = ny_lo * ((c - ym) * inv_dgy[j]);
        const T fy_hi = ny_hi * ((yp - c) * inv_dgy[j + 1]);
        // z faces k, k+1: z-average, then x-average
        const T nz_lo = h * (h * (NE(im, j, km) + NE(im, j, k))
                           + h * (NE(i, j, km) + NE(i, j, k)));
        const T nz_hi = h * (h * (NE(im, j, k) + NE(im, j, kp))
                           + h * (NE(i, j, k) + NE(i, j, kp)));
        const T fz_lo = nz_lo * (c - zm) * ihz;
        const T fz_hi = nz_hi * (zp - c) * ihz;
        lap = (fx_hi - fx_lo) * ihx + (fy_hi - fy_lo) * inv_dy[j]
            + (fz_hi - fz_lo) * ihz;
    }
    return c + dt * (-conv + lap + fx);
}

// ---- w (z-face, y-center) star at (i, j, k), j < ny ----------------------
template <typename T, bool NUT>
__device__ __forceinline__ T star_w(CH_PARAMS, int i, int j, int k) {
    const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
    const int km = wrap_m(k, nz), kp = wrap_p(k, nz);
    const T h = T(0.5), two = T(2);
    const T cw = W(i, j, k);
    const T wxp = W(ip, j, k), wxm = W(im, j, k);
    const T wzp = W(i, j, kp), wzm = W(i, j, km);
    const T wyp = wall_t(w, i, j + 1, k, ny, nz);
    const T wym = wall_t(w, i, j - 1, k, ny, nz);
    // u at (x-face, z-face), v at (y-face, z-face)
    const T ue_lo = h * (U(i, j, km) + U(i, j, k));
    const T ue_hi = h * (U(ip, j, km) + U(ip, j, k));
    const T vw_lo = h * (V(i, j, km) + V(i, j, k));
    const T vw_hi = h * (V(i, j + 1, km) + V(i, j + 1, k));
    T convw;
    if (skew) {
        convw = h * ((h * (cw + wzp)) * wzp - (h * (wzm + cw)) * wzm) * ihz;
        convw += h * (ue_hi * wxp - ue_lo * wxm) * ihx;
        convw += h * (vw_hi * wyp - vw_lo * wym) * inv_dy[j];
    } else {
        convw = cw * (wzp - wzm) * (h * ihz);
        convw += (h * (ue_lo + ue_hi)) * (wxp - wxm) * (h * ihx);
        convw += (h * (vw_lo + vw_hi)) * (wyp - wym) * inv2_cy[j];
    }
    T lapw;
    if (!NUT) {
        const T g_lo = nu * ((cw - wym) * inv_dgy[j]);
        const T g_hi = nu * ((wyp - cw) * inv_dgy[j + 1]);
        lapw = nu * (wxp - two * cw + wxm) * ihx * ihx
             + (g_hi - g_lo) * inv_dy[j]
             + nu * (wzp - two * cw + wzm) * ihz * ihz;
    } else {
        // z (own axis): the cells on either side of face k
        const T fz_hi = NE(i, j, k) * (wzp - cw) * ihz;
        const T fz_lo = NE(i, j, km) * (cw - wzm) * ihz;
        // x faces i, i+1: x-average, then z-average
        const T nx_lo = h * (h * (NE(im, j, km) + NE(i, j, km))
                           + h * (NE(im, j, k) + NE(i, j, k)));
        const T nx_hi = h * (h * (NE(i, j, km) + NE(ip, j, km))
                           + h * (NE(i, j, k) + NE(ip, j, k)));
        const T fx_lo = nx_lo * ((cw - wxm) * ihx);
        const T fx_hi = nx_hi * ((wxp - cw) * ihx);
        // y faces j, j+1: y mirror-average, then z-average
        const T ny_lo = h * (h * (NE(i, j - 1, km) + NE(i, j, km))
                           + h * (NE(i, j - 1, k) + NE(i, j, k)));
        const T ny_hi = h * (h * (NE(i, j, km) + NE(i, j + 1, km))
                           + h * (NE(i, j, k) + NE(i, j + 1, k)));
        const T fy_lo = ny_lo * ((cw - wym) * inv_dgy[j]);
        const T fy_hi = ny_hi * ((wyp - cw) * inv_dgy[j + 1]);
        lapw = (fx_hi - fx_lo) * ihx + (fy_hi - fy_lo) * inv_dy[j]
             + (fz_hi - fz_lo) * ihz;
    }
    return cw + dt * (-convw + lapw);
}

// ---- v (y-face j of ny+1, wall faces included) star at (i, j, k) ---------
template <typename T, bool NUT>
__device__ __forceinline__ T star_v(CH_PARAMS, int i, int j, int k) {
    const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
    const int km = wrap_m(k, nz), kp = wrap_p(k, nz);
    const T h = T(0.5), two = T(2);
    const T c = V(i, j, k);
    const T xp = V(ip, j, k), xm = V(im, j, k);
    const T zp = V(i, j, kp), zm = V(i, j, km);
    // odd-reflection normal pad: 2 v_wall - v_next beyond each wall
    const T np_ = (j == ny) ? two * V(i, ny, k) - V(i, ny - 1, k) : V(i, j + 1, k);
    const T nm_ = (j == 0) ? two * V(i, 0, k) - V(i, 1, k) : V(i, j - 1, k);
    // u and w interpolated to y-face j from the wall-padded cell rows
    const T ue_lo = h * (wall_t(u, i, j - 1, k, ny, nz) + wall_t(u, i, j, k, ny, nz));
    const T ue_hi = h * (wall_t(u, ip, j - 1, k, ny, nz) + wall_t(u, ip, j, k, ny, nz));
    const T wy_lo = h * (wall_t(w, i, j - 1, k, ny, nz) + wall_t(w, i, j, k, ny, nz));
    const T wy_hi = h * (wall_t(w, i, j - 1, kp, ny, nz) + wall_t(w, i, j, kp, ny, nz));
    // cells j (above the face) and j-1 (below), mirrored beyond the walls
    const int jc_hi = j < ny - 1 ? j : ny - 1;
    const int jc_lo = j > 0 ? j - 1 : 0;
    T conv;
    if (skew) {
        const T c_hi = h * (V(i, jc_hi, k) + V(i, jc_hi + 1, k));
        const T c_lo = h * (V(i, jc_lo, k) + V(i, jc_lo + 1, k));
        conv = h * (c_hi * np_ - c_lo * nm_) * inv_dyc[j];
        conv += h * (ue_hi * xp - ue_lo * xm) * ihx;
        conv += h * (wy_hi * zp - wy_lo * zm) * ihz;
    } else {
        conv = c * (np_ - nm_) * inv2_fy[j];
        conv += (h * (ue_lo + ue_hi)) * (xp - xm) * (h * ihx);
        conv += (h * (wy_lo + wy_hi)) * (zp - zm) * (h * ihz);
    }
    T lap;
    if (!NUT) {
        const T f_hi = nu * ((V(i, jc_hi + 1, k) - V(i, jc_hi, k)) * inv_dy[jc_hi]);
        const T f_lo = nu * ((V(i, jc_lo + 1, k) - V(i, jc_lo, k)) * inv_dy[jc_lo]);
        lap = nu * (xp - two * c + xm) * ihx * ihx
            + (f_hi - f_lo) * inv_dyc[j]
            + nu * (zp - two * c + zm) * ihz * ihz;
    } else {
        // y (own axis): the mirrored cell fluxes above and below face j
        const T f_hi = NE(i, jc_hi, k) * ((V(i, jc_hi + 1, k) - V(i, jc_hi, k)) * inv_dy[jc_hi]);
        const T f_lo = NE(i, jc_lo, k) * ((V(i, jc_lo + 1, k) - V(i, jc_lo, k)) * inv_dy[jc_lo]);
        // x faces i, i+1: x-average, then y mirror-average
        const T nx_lo = h * (h * (NE(im, j - 1, k) + NE(i, j - 1, k))
                           + h * (NE(im, j, k) + NE(i, j, k)));
        const T nx_hi = h * (h * (NE(i, j - 1, k) + NE(ip, j - 1, k))
                           + h * (NE(i, j, k) + NE(ip, j, k)));
        const T fx_lo = nx_lo * ((c - xm) * ihx);
        const T fx_hi = nx_hi * ((xp - c) * ihx);
        // z faces k, k+1: z-average, then y mirror-average
        const T nz_lo = h * (h * (NE(i, j - 1, km) + NE(i, j - 1, k))
                           + h * (NE(i, j, km) + NE(i, j, k)));
        const T nz_hi = h * (h * (NE(i, j - 1, k) + NE(i, j - 1, kp))
                           + h * (NE(i, j, k) + NE(i, j, kp)));
        const T fz_lo = nz_lo * (c - zm) * ihz;
        const T fz_hi = nz_hi * (zp - c) * ihz;
        lap = (fx_hi - fx_lo) * ihx + (f_hi - f_lo) * inv_dyc[j]
            + (fz_hi - fz_lo) * ihz;
    }
    return c + dt * (-conv + lap);
}
#undef U
#undef W
#undef V
#undef NE

template <typename T, bool NUT, bool DIV>
__global__ void predictor_channel_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ dt_ptr,
        const T* __restrict__ inv_dy, const T* __restrict__ inv_dyc,
        const T* __restrict__ inv_dgy, const T* __restrict__ inv2_cy,
        const T* __restrict__ inv2_fy, const T* __restrict__ nut,
        T* __restrict__ su, T* __restrict__ sv, T* __restrict__ sw,
        int nx, int ny, int nz, T ihx, T ihz, T nu, T fx, int skew,
        T* __restrict__ dv) {
    const int nyv = ny + 1;
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= static_cast<long long>(nx) * nyv * nz) return;
    const int k = static_cast<int>(idx % nz);
    const long long r = idx / nz;
    const int j = static_cast<int>(r % nyv);   // y-face index of v; cell j of u, w
    const int i = static_cast<int>(r / nyv);
    const T dt = *dt_ptr;

    if (j < ny) {
        const T s_u = star_u<T, NUT>(CH_ARGS, i, j, k);
        su[at3(i, j, k, ny, nz)] = s_u;
        const T s_w = star_w<T, NUT>(CH_ARGS, i, j, k);
        sw[at3(i, j, k, ny, nz)] = s_w;
        if (DIV) {
            // this face's star v (0 at the wall j = 0) and the +1
            // neighbours' stars, recomputed here (trouble 1 and 2 above)
            const T s_v = j == 0 ? T(0) : star_v<T, NUT>(CH_ARGS, i, j, k);
            sv[at3(i, j, k, nyv, nz)] = s_v;
            const T u1 = star_u<T, NUT>(CH_ARGS, wrap_p(i, nx), j, k);
            const T v1 = j + 1 == ny ? T(0)
                                     : star_v<T, NUT>(CH_ARGS, i, j + 1, k);
            const T w1 = star_w<T, NUT>(CH_ARGS, i, j, wrap_p(k, nz));
            dv[at3(i, j, k, ny, nz)] = (u1 - s_u) * ihx
                                     + (v1 - s_v) * inv_dy[j]
                                     + (w1 - s_w) * ihz;
            return;
        }
    }
    if (DIV) {   // j == ny: the top wall face
        sv[at3(i, j, k, nyv, nz)] = T(0);
        return;
    }
    sv[at3(i, j, k, nyv, nz)] = star_v<T, NUT>(CH_ARGS, i, j, k);
}
#undef CH_PARAMS
#undef CH_ARGS

template <typename T, bool NUT, bool DIV>
void launch_kernel(const void* u, const void* v, const void* w,
                   const void* dt, const void* inv_dy, const void* inv_dyc,
                   const void* inv_dgy, const void* inv2_cy,
                   const void* inv2_fy, const void* nut, void* su, void* sv,
                   void* sw, void* dv, int nx, int ny, int nz, double ihx,
                   double ihz, double nu, double fx, int skew, void* stream) {
    const long long n = static_cast<long long>(nx) * (ny + 1) * nz;
    predictor_channel_kernel<T, NUT, DIV><<<cfdnn::blocks_for(n), cfdnn::kBlock,
                                            0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(dt),
        static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dyc),
        static_cast<const T*>(inv_dgy), static_cast<const T*>(inv2_cy),
        static_cast<const T*>(inv2_fy), static_cast<const T*>(nut),
        static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw),
        nx, ny, nz, T(ihx), T(ihz), T(nu), T(fx), skew, static_cast<T*>(dv));
}

template <typename T, bool DIV>
int launch(const void* u, const void* v, const void* w, const void* dt,
           const void* inv_dy, const void* inv_dyc, const void* inv_dgy,
           const void* inv2_cy, const void* inv2_fy, const void* nut,
           void* su, void* sv, void* sw, void* dv, int nx, int ny, int nz,
           double ihx, double ihz, double nu, double fx, int skew,
           void* stream) {
    if (nut)
        launch_kernel<T, true, DIV>(u, v, w, dt, inv_dy, inv_dyc, inv_dgy,
                                    inv2_cy, inv2_fy, nut, su, sv, sw, dv, nx,
                                    ny, nz, ihx, ihz, nu, fx, skew, stream);
    else
        launch_kernel<T, false, DIV>(u, v, w, dt, inv_dy, inv_dyc, inv_dgy,
                                     inv2_cy, inv2_fy, nut, su, sv, sw, dv, nx,
                                     ny, nz, ihx, ihz, nu, fx, skew, stream);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_predictor_channel_div_f32(
        const void* u, const void* v, const void* w, const void* dt,
        const void* inv_dy, const void* inv_dyc, const void* inv_dgy,
        const void* inv2_cy, const void* inv2_fy, const void* nut,
        void* su, void* sv, void* sw, void* dv, int nx, int ny, int nz,
        double ihx, double ihz, double nu, double fx, int skew,
        void* stream) {
    return launch<float, true>(
        u, v, w, dt, inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy, nut, su, sv,
        sw, dv, nx, ny, nz, ihx, ihz, nu, fx, skew, stream);
}

extern "C" int cfdnn_predictor_channel_div_f64(
        const void* u, const void* v, const void* w, const void* dt,
        const void* inv_dy, const void* inv_dyc, const void* inv_dgy,
        const void* inv2_cy, const void* inv2_fy, const void* nut,
        void* su, void* sv, void* sw, void* dv, int nx, int ny, int nz,
        double ihx, double ihz, double nu, double fx, int skew,
        void* stream) {
    return launch<double, true>(
        u, v, w, dt, inv_dy, inv_dyc, inv_dgy, inv2_cy, inv2_fy, nut, su, sv,
        sw, dv, nx, ny, nz, ihx, ihz, nu, fx, skew, stream);
}
