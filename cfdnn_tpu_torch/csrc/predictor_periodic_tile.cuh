// predictor_periodic: the all-periodic predictor on an (x, z) tile walked
// along y.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor (body
// _predictor_kernel, math predictor_slab_math). For every cell it computes
// the skew convection, nu * Laplacian and the body force of u, v and w and
// writes the three star components:
//     star = phi + dt * (-conv + nu * lap (+ fx on u))
// The plain PyTorch twin is ops/kernels.py predictor_periodic_twin. The
// predictor + divergence kernel (fused_predictor_div) runs these stars on
// a window with a two-cell high halo: predictor_periodic_div_tile.cuh.
//
// Grid: all-periodic uniform O2, skew, scalar nu, any nx, ny and nz.
// Shapes: u, v, w and their stars (nx, ny, nz).
//
// The stars are the slab kernel's star_u, star_v and star_w, term for
// term and in the same order of evaluation, rewritten over offsets from
// the thread's point: on the staged window (xz_tile.cuh) every neighbour,
// corners included, is one step away, so each operand is one shared-memory
// load at a fixed offset, with no wrap_m/wrap_p and no 64-bit at3. The
// ring holds the wrapped y planes (`Window::row` on a periodic y), so no
// plane is an edge: one instantiation a dtype. 1/hx, 1/hy and 1/hz are host
// scalars, as in the TPU kernel.
//
// Bound on the H100: device-memory bandwidth (u, v, w in, three stars out:
// 24 bytes a cell in float32, ~154 flops). Design: a block of 8 x 32
// threads stages its tile plus a one-cell x/z halo (corners included),
// 10 x 34 points of each field and plane, and walks ny planes in chunks,
// the next planes copied by cp.async (two in flight in float32); each
// plane of u, v and w is fetched from device memory once a block, where
// the slab kernel fetched every x neighbour a whole y-z plane away through
// L2. The launcher picks the chunk of planes a block walks (tile_plan.cuh:
// two waves of blocks at least, 8 to 64 planes). The window's staging
// wraps x once, which keeps every staged x inside the arrays from nx >= 8
// on; below that this kernel wraps the staged x fully, so it serves every
// nx.
//
// The float and double entry points are compiled apart
// (predictor_periodic_tile.cu, predictor_periodic_tile_f64.cu).
#pragma once

#include "xz_tile.cuh"

namespace {

using cfdnn::xz::Window;

// The stars at the thread's point on the staged window r (u, v, w: fields
// 0 ... 2). Every axis is periodic and staged wrapped.
template <typename T, typename View>
struct PeriodicTile {
    View r;
    T ihx, ihy, ihz, nu;

    __device__ __forceinline__ T U(int di, int dj, int dk) const {
        return r.template at<0>(di, dj, dk);
    }
    __device__ __forceinline__ T V(int di, int dj, int dk) const {
        return r.template at<1>(di, dj, dk);
    }
    __device__ __forceinline__ T W(int di, int dj, int dk) const {
        return r.template at<2>(di, dj, dk);
    }

    // ---- u (x-face) star ------------------------------------------------
    __device__ __forceinline__ T star_u(T dt, T fx) const {
        const T h = T(0.5), two = T(2);
        const T c = U(0, 0, 0);
        const T xp = U(1, 0, 0), xm = U(-1, 0, 0);
        const T yp = U(0, 1, 0), ym = U(0, -1, 0);
        const T zp = U(0, 0, 1), zm = U(0, 0, -1);
        // own axis: phi_c[i] = 0.5(u_i + u_{i+1})
        T conv = h * ((h * (c + xp)) * xp - (h * (xm + c)) * xm) * ihx;
        // y: v at (x-face, y-face) corners, 0.5(v_{i-1} + v_i)
        const T ve_lo = h * (V(-1, 0, 0) + V(0, 0, 0));
        const T ve_hi = h * (V(-1, 1, 0) + V(0, 1, 0));
        conv += h * (ve_hi * yp - ve_lo * ym) * ihy;
        // z: w at (x-face, z-face), 0.5(w_{i-1} + w_i)
        const T we_lo = h * (W(-1, 0, 0) + W(0, 0, 0));
        const T we_hi = h * (W(-1, 0, 1) + W(0, 0, 1));
        conv += h * (we_hi * zp - we_lo * zm) * ihz;
        const T lap = (xp - two * c + xm) * ihx * ihx
                    + (yp - two * c + ym) * ihy * ihy
                    + (zp - two * c + zm) * ihz * ihz;
        return c + dt * (-conv + nu * lap + fx);
    }

    // ---- v (y-face) star ------------------------------------------------
    __device__ __forceinline__ T star_v(T dt) const {
        const T h = T(0.5), two = T(2);
        const T c = V(0, 0, 0);
        const T xp = V(1, 0, 0), xm = V(-1, 0, 0);
        const T yp = V(0, 1, 0), ym = V(0, -1, 0);
        const T zp = V(0, 0, 1), zm = V(0, 0, -1);
        T conv = h * ((h * (c + yp)) * yp - (h * (ym + c)) * ym) * ihy;
        // x: u at (x-face, y-face), 0.5(u_{j-1} + u_j)
        const T ue_lo = h * (U(0, -1, 0) + U(0, 0, 0));
        const T ue_hi = h * (U(1, -1, 0) + U(1, 0, 0));
        conv += h * (ue_hi * xp - ue_lo * xm) * ihx;
        // z: w at (y-face, z-face), 0.5(w_{j-1} + w_j)
        const T we_lo = h * (W(0, -1, 0) + W(0, 0, 0));
        const T we_hi = h * (W(0, -1, 1) + W(0, 0, 1));
        conv += h * (we_hi * zp - we_lo * zm) * ihz;
        const T lap = (xp - two * c + xm) * ihx * ihx
                    + (yp - two * c + ym) * ihy * ihy
                    + (zp - two * c + zm) * ihz * ihz;
        return c + dt * (-conv + nu * lap);
    }

    // ---- w (z-face) star ------------------------------------------------
    __device__ __forceinline__ T star_w(T dt) const {
        const T h = T(0.5), two = T(2);
        const T c = W(0, 0, 0);
        const T xp = W(1, 0, 0), xm = W(-1, 0, 0);
        const T yp = W(0, 1, 0), ym = W(0, -1, 0);
        const T zp = W(0, 0, 1), zm = W(0, 0, -1);
        T conv = h * ((h * (c + zp)) * zp - (h * (zm + c)) * zm) * ihz;
        // x: u at (x-face, z-face), 0.5(u_{k-1} + u_k)
        const T ue_lo = h * (U(0, 0, -1) + U(0, 0, 0));
        const T ue_hi = h * (U(1, 0, -1) + U(1, 0, 0));
        conv += h * (ue_hi * xp - ue_lo * xm) * ihx;
        // y: v at (y-face, z-face), 0.5(v_{k-1} + v_k)
        const T ve_lo = h * (V(0, 0, -1) + V(0, 0, 0));
        const T ve_hi = h * (V(0, 1, -1) + V(0, 1, 0));
        conv += h * (ve_hi * yp - ve_lo * ym) * ihy;
        const T lap = (xp - two * c + xm) * ihx * ihx
                    + (yp - two * c + ym) * ihy * ihy
                    + (zp - two * c + zm) * ihz * ihz;
        return c + dt * (-conv + nu * lap);
    }
};

// the planes in flight: two in float32, one in float64 (5 slots of three
// fields: 20.4 KB of shared memory in float32; 4 slots: 32.6 KB in float64)
template <typename T>
constexpr int kPeriodicAhead = sizeof(T) == 4 ? 2 : 1;

// No minimum of blocks an SM: left free, ptxas gives float32 40 registers
// and 880 SASS instructions, where a cap of four blocks gave 54 and 912, and
// it ran ~1% faster at 512^3 on the H100.
template <typename T>
__global__ void __launch_bounds__(cfdnn::xz::kThreads)
predictor_periodic_tile_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ dt_ptr,
        T* __restrict__ su, T* __restrict__ sv, T* __restrict__ sw,
        int nx, int ny, int nz, T ihx, T ihy, T ihz, T nu, T fx, int chunk) {
    using Win = Window<T, 3, 1, 1, kPeriodicAhead<T>>;
    using View = typename Win::View;
    using cfdnn::xz::kPz;
    __shared__ T buf[Win::kSize];
    Win win;
    win.init(buf, nx, ny, nz, 0, ny, chunk);
    if (nx < cfdnn::xz::kTx) {
        // the window wraps a staged x once, which leaves a staged x of the
        // tile's far side (read by no owned point) past the arrays below a
        // tile's width: wrap every staged x fully
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int p = min(win.e + q * cfdnn::xz::kThreads,
                              cfdnn::xz::kPlane - 1);
            const int g = win.i0 - 1 + p / kPz;
            win.gx[q] = (g % nx + nx) % nx;
        }
    }
    win.field(0, u, ny);
    win.field(1, v, ny);
    win.field(2, w, ny);
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    win.walk([&](const View& r) {
        if (!owns) return;
        // the three stars of a point are computed before any is stored, so
        // that an operand two stars read is loaded once
        const PeriodicTile<T, View> t{r, ihx, ihy, ihz, nu};
        const T s_u = t.star_u(dt, fx);
        const T s_v = t.star_v(dt);
        const T s_w = t.star_w(dt);
        const int c = (i * ny + r.j) * nz + k;
        su[c] = s_u;
        sv[c] = s_v;
        sw[c] = s_w;
    });
}

// The entry's body: refuses (cudaErrorInvalidValue) an empty grid and a
// field past 32-bit offsets.
template <typename T>
int launch(const void* u, const void* v, const void* w, const void* dt,
           void* su, void* sv, void* sw, int nx, int ny, int nz,
           double ihx, double ihy, double ihz, double nu, double fx,
           void* stream) {
    if (nx < 1 || ny < 1 || nz < 1
        || static_cast<long long>(nx) * ny * nz > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long tiles = cfdnn::xz::grid(nx, nz, 1).x;   // of a plane
    const int chunk = cfdnn::walk_chunk<predictor_periodic_tile_kernel<T>,
                                        cfdnn::xz::kThreads>(tiles, ny);
    predictor_periodic_tile_kernel<T>
        <<<cfdnn::xz::grid(nx, nz, ny, chunk), cfdnn::xz::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(dt),
        static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw),
        nx, ny, nz, T(ihx), T(ihy), T(ihz), T(nu), T(fx), chunk);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
