// predictor_periodic_div: the fused Euler momentum predictor on an
// all-periodic uniform O2 grid that also writes the divergence of its star
// in the same pass (the DIV instantiation of a slab kernel whose DIV =
// false instantiation was predictor_periodic; that predictor now walks an
// (x, z) tile, predictor_periodic_tile.cuh).
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_div (body
// _predictor_div_kernel, math predictor_slab_math). For every cell it
// computes the skew convection, nu * Laplacian and the body force of u, v
// and w and writes the three star components:
//     star = phi + dt * (-conv + nu * lap (+ fx on u))
// and the staggered cell divergence of the star,
//     div = (u*_{i+1} - u*_i)/hx + (v*_{j+1} - v*_j)/hy + (w*_{k+1} - w*_k)/hz
// The plain PyTorch twin is ops/kernels.py predictor_periodic_div_twin.
//
// Bound on the H100: device-memory bandwidth. It reads three fields and
// writes four (28 B a cell in float32) for about 310 flops a cell, far
// below the card's flop-to-byte balance. Design: one thread per cell, z
// fastest within a warp (coalesced), periodic wrap by index arithmetic,
// each operand read through the read-only path so that the ~40 neighbour
// reads of a cell hit L1/L2 instead of device memory.
//
// Where it could go wrong, and what it does:
//   1. The divergence of cell (i, j, k) needs the star u at (i+1, j, k),
//      v at (i, j+1, k) and w at (i, j, k+1), which other threads (in
//      other blocks) write; a block cannot wait on another. So each thread
//      also evaluates those three one-component stars itself. Each
//      component's star is written once, as a __forceinline__ function of
//      (i, j, k) (star_u, star_v, star_w), called at the thread's own point
//      and at the +1 neighbour, so that the recomputed value is the same
//      arithmetic as the neighbour's stored one. nvcc may still contract
//      the two inlined copies into FMAs differently, so chip_smoke.py holds
//      the div output against the divergence kernel of this kernel's own
//      star output. The +1 neighbours wrap (periodic in x, y and z).
//   2. The metrics are the host scalars 1/hx, 1/hy, 1/hz, as in the TPU
//      kernel; the twin divides by the geometry's inv_d vectors, which
//      equal 1/h only to roundoff.
//   3. dt stays on the device (dt_ptr): under adaptive dt it is a new 0-d
//      tensor every step and is never read on the host.
//   4. The TPU kernel's asymmetric x-halo (bx+1 star planes per slab) is
//      not ported: it exists for the slab, and a thread here reaches its
//      neighbours directly.
// Whether the divergence is written is still the kernel's template
// parameter, and only DIV = true is instantiated: its SASS (cuobjdump
// -sass) is the kernel's of before, instruction for instruction.
#include "common.cuh"

namespace {

using cfdnn::at3;
using cfdnn::wrap_m;
using cfdnn::wrap_p;

#define F(a, I, J, K) a[at3(I, J, K, ny, nz)]

// ---- u (x-face) star at (i, j, k) ---------------------------------------
template <typename T>
__device__ __forceinline__ T star_u(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, int i, int j, int k, int nx, int ny, int nz,
        T ihx, T ihy, T ihz, T nu, T fx, T dt) {
    const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
    const int jm = wrap_m(j, ny), jp = wrap_p(j, ny);
    const int km = wrap_m(k, nz), kp = wrap_p(k, nz);
    const T h = T(0.5), two = T(2);
    const T c = F(u, i, j, k);
    const T xp = F(u, ip, j, k), xm = F(u, im, j, k);
    const T yp = F(u, i, jp, k), ym = F(u, i, jm, k);
    const T zp = F(u, i, j, kp), zm = F(u, i, j, km);
    // own axis: phi_c[i] = 0.5(u_i + u_{i+1})
    T conv = h * ((h * (c + xp)) * xp - (h * (xm + c)) * xm) * ihx;
    // y: v at (x-face, y-face) corners, 0.5(v_{i-1} + v_i)
    const T ve_lo = h * (F(v, im, j, k) + F(v, i, j, k));
    const T ve_hi = h * (F(v, im, jp, k) + F(v, i, jp, k));
    conv += h * (ve_hi * yp - ve_lo * ym) * ihy;
    // z: w at (x-face, z-face), 0.5(w_{i-1} + w_i)
    const T we_lo = h * (F(w, im, j, k) + F(w, i, j, k));
    const T we_hi = h * (F(w, im, j, kp) + F(w, i, j, kp));
    conv += h * (we_hi * zp - we_lo * zm) * ihz;
    const T lap = (xp - two * c + xm) * ihx * ihx
                + (yp - two * c + ym) * ihy * ihy
                + (zp - two * c + zm) * ihz * ihz;
    return c + dt * (-conv + nu * lap + fx);
}

// ---- v (y-face) star at (i, j, k) ---------------------------------------
template <typename T>
__device__ __forceinline__ T star_v(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, int i, int j, int k, int nx, int ny, int nz,
        T ihx, T ihy, T ihz, T nu, T dt) {
    const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
    const int jm = wrap_m(j, ny), jp = wrap_p(j, ny);
    const int km = wrap_m(k, nz), kp = wrap_p(k, nz);
    const T h = T(0.5), two = T(2);
    const T c = F(v, i, j, k);
    const T xp = F(v, ip, j, k), xm = F(v, im, j, k);
    const T yp = F(v, i, jp, k), ym = F(v, i, jm, k);
    const T zp = F(v, i, j, kp), zm = F(v, i, j, km);
    T conv = h * ((h * (c + yp)) * yp - (h * (ym + c)) * ym) * ihy;
    // x: u at (x-face, y-face), 0.5(u_{j-1} + u_j)
    const T ue_lo = h * (F(u, i, jm, k) + F(u, i, j, k));
    const T ue_hi = h * (F(u, ip, jm, k) + F(u, ip, j, k));
    conv += h * (ue_hi * xp - ue_lo * xm) * ihx;
    // z: w at (y-face, z-face), 0.5(w_{j-1} + w_j)
    const T we_lo = h * (F(w, i, jm, k) + F(w, i, j, k));
    const T we_hi = h * (F(w, i, jm, kp) + F(w, i, j, kp));
    conv += h * (we_hi * zp - we_lo * zm) * ihz;
    const T lap = (xp - two * c + xm) * ihx * ihx
                + (yp - two * c + ym) * ihy * ihy
                + (zp - two * c + zm) * ihz * ihz;
    return c + dt * (-conv + nu * lap);
}

// ---- w (z-face) star at (i, j, k) ---------------------------------------
template <typename T>
__device__ __forceinline__ T star_w(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, int i, int j, int k, int nx, int ny, int nz,
        T ihx, T ihy, T ihz, T nu, T dt) {
    const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
    const int jm = wrap_m(j, ny), jp = wrap_p(j, ny);
    const int km = wrap_m(k, nz), kp = wrap_p(k, nz);
    const T h = T(0.5), two = T(2);
    const T c = F(w, i, j, k);
    const T xp = F(w, ip, j, k), xm = F(w, im, j, k);
    const T yp = F(w, i, jp, k), ym = F(w, i, jm, k);
    const T zp = F(w, i, j, kp), zm = F(w, i, j, km);
    T conv = h * ((h * (c + zp)) * zp - (h * (zm + c)) * zm) * ihz;
    // x: u at (x-face, z-face), 0.5(u_{k-1} + u_k)
    const T ue_lo = h * (F(u, i, j, km) + F(u, i, j, k));
    const T ue_hi = h * (F(u, ip, j, km) + F(u, ip, j, k));
    conv += h * (ue_hi * xp - ue_lo * xm) * ihx;
    // y: v at (y-face, z-face), 0.5(v_{k-1} + v_k)
    const T ve_lo = h * (F(v, i, j, km) + F(v, i, j, k));
    const T ve_hi = h * (F(v, i, jp, km) + F(v, i, jp, k));
    conv += h * (ve_hi * yp - ve_lo * ym) * ihy;
    const T lap = (xp - two * c + xm) * ihx * ihx
                + (yp - two * c + ym) * ihy * ihy
                + (zp - two * c + zm) * ihz * ihz;
    return c + dt * (-conv + nu * lap);
}

template <typename T, bool DIV>
__global__ void predictor_periodic_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ dt_ptr,
        T* __restrict__ su, T* __restrict__ sv, T* __restrict__ sw,
        int nx, int ny, int nz, T ihx, T ihy, T ihz, T nu, T fx,
        T* __restrict__ dv) {
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= static_cast<long long>(nx) * ny * nz) return;
    const int k = static_cast<int>(idx % nz);
    const long long r = idx / nz;
    const int j = static_cast<int>(r % ny);
    const int i = static_cast<int>(r / ny);
    const T dt = *dt_ptr;

    const T s_u = star_u(u, v, w, i, j, k, nx, ny, nz, ihx, ihy, ihz, nu,
                         fx, dt);
    F(su, i, j, k) = s_u;
    const T s_v = star_v(u, v, w, i, j, k, nx, ny, nz, ihx, ihy, ihz, nu, dt);
    F(sv, i, j, k) = s_v;
    const T s_w = star_w(u, v, w, i, j, k, nx, ny, nz, ihx, ihy, ihz, nu, dt);
    F(sw, i, j, k) = s_w;
    if (DIV) {
        // the +1 neighbours' stars, recomputed here (trouble 1 above)
        const T u1 = star_u(u, v, w, wrap_p(i, nx), j, k, nx, ny, nz, ihx,
                            ihy, ihz, nu, fx, dt);
        const T v1 = star_v(u, v, w, i, wrap_p(j, ny), k, nx, ny, nz, ihx,
                            ihy, ihz, nu, dt);
        const T w1 = star_w(u, v, w, i, j, wrap_p(k, nz), nx, ny, nz, ihx,
                            ihy, ihz, nu, dt);
        F(dv, i, j, k) = (u1 - s_u) * ihx + (v1 - s_v) * ihy
                       + (w1 - s_w) * ihz;
    }
}
#undef F

template <typename T, bool DIV>
int launch(const void* u, const void* v, const void* w, const void* dt,
           void* su, void* sv, void* sw, void* dv, int nx, int ny, int nz,
           double ihx, double ihy, double ihz, double nu, double fx,
           void* stream) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    predictor_periodic_kernel<T, DIV><<<cfdnn::blocks_for(n), cfdnn::kBlock,
                                        0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(dt),
        static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw),
        nx, ny, nz, T(ihx), T(ihy), T(ihz), T(nu), T(fx),
        static_cast<T*>(dv));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_predictor_periodic_div_f32(
        const void* u, const void* v, const void* w, const void* dt,
        void* su, void* sv, void* sw, void* dv, int nx, int ny, int nz,
        double ihx, double ihy, double ihz, double nu, double fx,
        void* stream) {
    return launch<float, true>(u, v, w, dt, su, sv, sw, dv, nx, ny, nz,
                               ihx, ihy, ihz, nu, fx, stream);
}

extern "C" int cfdnn_predictor_periodic_div_f64(
        const void* u, const void* v, const void* w, const void* dt,
        void* su, void* sv, void* sw, void* dv, int nx, int ny, int nz,
        double ihx, double ihy, double ihz, double nu, double fx,
        void* stream) {
    return launch<double, true>(u, v, w, dt, su, sv, sw, dv, nx, ny, nz,
                                ihx, ihy, ihz, nu, fx, stream);
}
