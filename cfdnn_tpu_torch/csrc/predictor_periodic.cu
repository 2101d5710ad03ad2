// predictor_periodic: the fused Euler momentum predictor on an all-periodic
// uniform O2 grid (the Taylor-Green main path).
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor (body
// _predictor_kernel, math predictor_slab_math). For every cell it computes
// the skew convection, nu * Laplacian and the body force of u, v and w and
// writes the three star components:
//     star = phi + dt * (-conv + nu * lap (+ fx on u))
// The plain PyTorch twin is ops/kernels.py predictor_periodic_twin.
//
// Bound on the H100: device-memory bandwidth. It reads three fields and
// writes three (24 B a cell in float32) for about 150 flops a cell, far
// below the card's flop-to-byte balance. Design: one thread per cell,
// z fastest within a warp (coalesced), periodic wrap by index arithmetic,
// each operand read through the read-only path so that the ~20 neighbour
// reads of a cell hit L1/L2 instead of device memory. No shared-memory
// tiling yet: the x-slab and VMEM machinery of the TPU kernel has no
// counterpart here.
#include "common.cuh"

namespace {

using cfdnn::at3;
using cfdnn::wrap_m;
using cfdnn::wrap_p;

template <typename T>
__global__ void predictor_periodic_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ dt_ptr,
        T* __restrict__ su, T* __restrict__ sv, T* __restrict__ sw,
        int nx, int ny, int nz, T ihx, T ihy, T ihz, T nu, T fx) {
    const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (idx >= static_cast<long long>(nx) * ny * nz) return;
    const int k = static_cast<int>(idx % nz);
    const long long r = idx / nz;
    const int j = static_cast<int>(r % ny);
    const int i = static_cast<int>(r / ny);
    const int im = wrap_m(i, nx), ip = wrap_p(i, nx);
    const int jm = wrap_m(j, ny), jp = wrap_p(j, ny);
    const int km = wrap_m(k, nz), kp = wrap_p(k, nz);
    const T h = T(0.5), two = T(2);
    const T dt = *dt_ptr;

#define F(a, I, J, K) a[at3(I, J, K, ny, nz)]

    // ---- u (x-face) --------------------------------------------------
    {
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
        F(su, i, j, k) = c + dt * (-conv + nu * lap + fx);
    }
    // ---- v (y-face) --------------------------------------------------
    {
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
        F(sv, i, j, k) = c + dt * (-conv + nu * lap);
    }
    // ---- w (z-face) --------------------------------------------------
    {
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
        F(sw, i, j, k) = c + dt * (-conv + nu * lap);
    }
#undef F
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* dt,
           void* su, void* sv, void* sw, int nx, int ny, int nz,
           double ihx, double ihy, double ihz, double nu, double fx,
           void* stream) {
    const long long n = static_cast<long long>(nx) * ny * nz;
    predictor_periodic_kernel<T><<<cfdnn::blocks_for(n), cfdnn::kBlock, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(dt),
        static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw),
        nx, ny, nz, T(ihx), T(ihy), T(ihz), T(nu), T(fx));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cfdnn_predictor_periodic_f32(
        const void* u, const void* v, const void* w, const void* dt,
        void* su, void* sv, void* sw, int nx, int ny, int nz,
        double ihx, double ihy, double ihz, double nu, double fx,
        void* stream) {
    return launch<float>(u, v, w, dt, su, sv, sw, nx, ny, nz,
                         ihx, ihy, ihz, nu, fx, stream);
}

extern "C" int cfdnn_predictor_periodic_f64(
        const void* u, const void* v, const void* w, const void* dt,
        void* su, void* sv, void* sw, int nx, int ny, int nz,
        double ihx, double ihy, double ihz, double nu, double fx,
        void* stream) {
    return launch<double>(u, v, w, dt, su, sv, sw, nx, ny, nz,
                          ihx, ihy, ihz, nu, fx, stream);
}
