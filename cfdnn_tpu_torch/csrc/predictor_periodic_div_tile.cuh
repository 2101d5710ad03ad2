// predictor_periodic_div: predictor_periodic_tile.cuh's predictor on an
// (x, z) tile walked along y that also writes the divergence of its star
// in the same pass.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_div (body
// _predictor_div_kernel, math predictor_slab_math). For every cell it
// writes the three star components of the all-periodic skew predictor,
//     star = phi + dt * (-conv + nu * lap (+ fx on u)),
// and the staggered cell divergence of the star,
//     div = (u*_{i+1} - u*_i)/hx + (v*_{j+1} - v*_j)/hy + (w*_{k+1} - w*_k)/hz
// The plain PyTorch twin is ops/kernels.py predictor_periodic_div_twin.
//
// Grid: all-periodic uniform O2, skew, scalar nu, any nx, ny and nz.
// Shapes: u, v, w and their stars and div (nx, ny, nz). 1/hx, 1/hy, 1/hz
// are host scalars, as in the TPU kernel.
//
// Bound on the H100: device-memory bandwidth (u, v, w in, three stars and
// div out: 28 bytes a cell in float32, ~162 flops). Design: the stars are
// predictor_periodic_tile.cuh's PeriodicTile, term for term, on
// xz_tile.cuh's window with a two-cell halo on the high side of x and z
// (11 x 35 staged points a plane); the divergence takes its +1 neighbours
// from the stored stars (div_tile.cuh): star v of face j + 1 from the next
// plane, one plane behind, and star u at i + 1 and star w at k + 1 from the
// neighbouring threads through a shared plane, the far x row and z column
// formed by the block itself. The slab kernel this replaces formed three
// more one-component stars a cell for that, about twice the predictor's
// arithmetic. A chunk (at least 16 planes: div_tile.cuh's kDivChunkMin)
// walks one plane past its last (the window's PAST): there it forms star v
// only (plane ny wraps to 0), for the divergence of its last cell, and
// stores nothing. The window stages x wrapped fully (its HI = 2), so every
// nx stages; z wraps by its modulo, y in the ring (`Window::row`).
//
// The float and double entry points are compiled apart
// (predictor_periodic_div_tile.cu, predictor_periodic_div_tile_f64.cu).
#pragma once

#include "div_tile.cuh"
#include "predictor_periodic_tile.cuh"

namespace {

template <typename T>
using PeriodicDivWindow = Window<T, 3, 1, 1, kPeriodicAhead<T>, 2, 1>;

// the dynamic shared memory of a block: the window and the star planes
// (27516 bytes in float32, 45792 in float64)
template <typename T>
constexpr size_t kPeriodicDivSmem =
    (PeriodicDivWindow<T>::kSize + cfdnn::xz::StarPlanes<T>::kSize)
    * sizeof(T);

template <typename T>
__global__ void __launch_bounds__(cfdnn::xz::kThreads)
predictor_periodic_div_tile_kernel(
        const T* __restrict__ u, const T* __restrict__ v,
        const T* __restrict__ w, const T* __restrict__ dt_ptr,
        T* __restrict__ su, T* __restrict__ sv, T* __restrict__ sw,
        T* __restrict__ dv, int nx, int ny, int nz, T ihx, T ihy, T ihz,
        T nu, T fx, int chunk) {
    using Win = PeriodicDivWindow<T>;
    using View = typename Win::View;
    using Tile = PeriodicTile<T, View>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* const smem = reinterpret_cast<T*>(smem_raw);
    Win win;
    win.init(smem, nx, ny, nz, 0, ny, chunk);
    win.field(0, u, ny);
    win.field(1, v, ny);
    win.field(2, w, ny);
    auto pass =
        cfdnn::xz::div_pass<Win::kPz>(smem + Win::kSize, win.tx, win.tz);
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    const int j0 = win.j0, j_end = win.j1 - 1;   // cells [j0, j_end)
    win.walk([&](const View& r) {
        const int j = r.j;
        const int slot = (j - j0) & 1;
        const Tile t{r, ihx, ihy, ihz, nu};
        // every thread forms its stars, an owner or not: a point past a
        // ragged tile's last is the first one wrapped, whose star u or w
        // the last owner reads
        const T s_v = t.star_v(dt);
        T s_u = T(0), s_w = T(0);
        if (j < j_end) {
            s_u = t.star_u(dt, fx);
            s_w = t.star_w(dt);
            pass.put(t, slot, s_u, s_w, dt, fx);
            if (owns) {
                const int c = (i * ny + j) * nz + k;
                su[c] = s_u;
                sv[c] = s_v;
                sw[c] = s_w;
            }
        }
        if (j > j0 && owns)
            dv[(i * ny + j - 1) * nz + k] = pass.div(slot, s_v, ihx, ihy, ihz);
        pass.carry(s_u, s_v, s_w);
    });
}

// The entry's body: refuses (cudaErrorInvalidValue) an empty grid and a
// field past 32-bit offsets.
template <typename T>
int launch_div(const void* u, const void* v, const void* w, const void* dt,
               void* su, void* sv, void* sw, void* dv, int nx, int ny,
               int nz, double ihx, double ihy, double ihz, double nu,
               double fx, void* stream) {
    if (nx < 1 || ny < 1 || nz < 1
        || static_cast<long long>(nx) * ny * nz > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    static_assert(kPeriodicDivSmem<double> <= 48 * 1024,
                  "the static limit of a block's shared memory");
    const long long tiles = cfdnn::xz::grid(nx, nz, 1).x;   // of a plane
    const int planned =
        cfdnn::walk_chunk<predictor_periodic_div_tile_kernel<T>,
                          cfdnn::xz::kThreads>(tiles, ny, kPeriodicDivSmem<T>);
    const int chunk = planned > cfdnn::xz::kDivChunkMin
                          ? planned : cfdnn::xz::kDivChunkMin;
    predictor_periodic_div_tile_kernel<T>
        <<<cfdnn::xz::grid(nx, nz, ny, chunk), cfdnn::xz::kThreads,
           kPeriodicDivSmem<T>, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(v),
        static_cast<const T*>(w), static_cast<const T*>(dt),
        static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw),
        static_cast<T*>(dv), nx, ny, nz, T(ihx), T(ihy), T(ihz), T(nu),
        T(fx), chunk);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
