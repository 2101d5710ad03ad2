// nu_sgs: the cell eddy viscosity of an algebraic LES closure from the
// nine-component velocity gradient, in one pass over u, v and w, on an
// (x, z) tile walked along y. (nu_sgs_xz, xz.cu, is the same function on
// the xz kernels' grid, over fixed chunks of xz::kChunk planes.)
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_nu_sgs (body
// _nu_sgs_kernel, which runs the closure's model_fn, turbulence/les.py, on
// an x-slab). The plain PyTorch twin is ops/kernels.py nu_sgs_twin:
// turbulence/base.py strain_rotation and filter_width, then the closure's
// algebra in turbulence/les.py. The closure is a compile-time parameter
// (les.cuh nu_closure: 0 Smagorinsky, 1 WALE, 2 Vreman) with its constant
// `coeff` and the filter width Delta of the cell's (y, z) column
// ((hx dy_j dz_k)^(1/3), filter_width). Sigma is not here: the reference
// runs it plain too (les.py SigmaModel).
//
// Grid and ghost rules: les.cuh (periodic uniform x; y and z each
// periodic uniform or no-slip walls at any stretching: the channel and
// the square duct), at every nx, ny, nz >= 2.
//
// The gradient is les.cuh's LesGrid::gradient, expression for expression,
// rewritten over offsets from the thread's point on the staged window
// (`gradient`, as xz.cu's nu_sgs_xz does): each operand is one
// shared-memory load at a fixed offset. The odd reflections beyond a wall
// are compiled only where they can be read: a walled y's in the planes
// next to a wall (EDGE), a walled z's in the blocks of the first and last
// z tiles (ZEDGE); every other read folds no index. The closures are
// les.cuh's nu_closure itself, so float64 agrees with the twin to
// roundoff and float32 keeps the slab kernel's order of operations.
//
// Bound on the H100: device-memory bandwidth (three fields in, one out;
// ~100 flops a cell for Smagorinsky, ~250 for WALE and Vreman, against
// 16 bytes moved a cell in float32). Design: xz_tile.cuh's 8 x 32 tile,
// a one-cell x/z halo with corners, a ring of y-planes j - 1 ... j + 1
// plus the planes in flight (two in float32, one in float64), the next
// plane copied by cp.async, one barrier a plane (tile_stage.cuh's
// `xz::Stage`: xz::Window's ring and walk, with each field's own stored
// rows and columns, so that w's nz + 1 columns of a walled z are staged
// too, the staged x wrapped fully and the staged columns beyond a walled z
// clamped into the array).
// Each plane of u, v and w is fetched from device memory once a block.
// float32 is capped at 64 registers, four blocks an SM (faster than three
// or five at 256x128x256). The launcher picks the chunk of planes a block
// walks (tile_plan.cuh: two waves of blocks at least, 8 to 64 planes).
// 32-bit offsets: the wrapper refuses a field of more than 2^31 - 1
// elements (ops/kernels.py tile_refusal).
#pragma once

#include <type_traits>

#include "les.cuh"
#include "tile_stage.cuh"

namespace {

using cfdnn::LesGrid;
namespace xz = cfdnn::xz;

// LesGrid::gradient at the thread's point (i, k) on the staged window r,
// its order of evaluation. x is periodic and staged wrapped, so are y
// unless EDGE (a plane next to a wall of a walled y: yc forms the odd
// reflection) and z unless ZEDGE (a block of a walled z's first or last z
// tile: zc forms it).
template <typename T, bool EDGE, bool ZEDGE, typename View>
__device__ __forceinline__ void gradient(const LesGrid<T>& g, const View& r,
                                         int i, int k, T G[3][3]) {
    const T h = T(0.5);
    const int j = r.j, ny = g.ny, nz = g.nz;
    // yc<C>(di, j + dj, dk): the odd reflection beyond a wall of y
    auto yc = [&](auto c, int di, int dj, int dk) -> T {
        constexpr int C = decltype(c)::value;
        if (EDGE) {
            if (j + dj < 0) return -r.template at<C>(di, -j, dk);
            if (j + dj >= ny) return -r.template at<C>(di, ny - 1 - j, dk);
        }
        return r.template at<C>(di, dj, dk);
    };
    // zc<C>(di, dj, k + dk): the odd reflection beyond a wall of z
    auto zc = [&](auto c, int di, int dj, int dk) -> T {
        constexpr int C = decltype(c)::value;
        if (ZEDGE) {
            if (k + dk < 0) return -r.template at<C>(di, dj, -k);
            if (k + dk >= nz) return -r.template at<C>(di, dj, nz - 1 - k);
        }
        return r.template at<C>(di, dj, dk);
    };
    using U = std::integral_constant<int, 0>;
    using V = std::integral_constant<int, 1>;
    using W = std::integral_constant<int, 2>;
    const T dy = g.den_y[j], dx = g.den_x[i], dz = g.den_z[k];
    // diagonal: staggered difference across the cell
    G[0][0] = (r.template at<0>(1, 0, 0) - r.template at<0>(0, 0, 0)) * g.inv_dx[i];
    G[1][1] = (r.template at<1>(0, 1, 0) - r.template at<1>(0, 0, 0)) * g.inv_dy[j];
    G[2][2] = (r.template at<2>(0, 0, 1) - r.template at<2>(0, 0, 0)) * g.inv_dz[k];
    // off the diagonal: central difference at the component's own
    // points, then the mean of the two points bounding the cell
    const T uy_lo = (yc(U{}, 0, 1, 0) - yc(U{}, 0, -1, 0)) / dy;
    const T uy_hi = (yc(U{}, 1, 1, 0) - yc(U{}, 1, -1, 0)) / dy;
    G[0][1] = h * (uy_lo + uy_hi);
    const T uz_lo = (zc(U{}, 0, 0, 1) - zc(U{}, 0, 0, -1)) / dz;
    const T uz_hi = (zc(U{}, 1, 0, 1) - zc(U{}, 1, 0, -1)) / dz;
    G[0][2] = h * (uz_lo + uz_hi);
    const T vx_lo = (r.template at<1>(1, 0, 0) - r.template at<1>(-1, 0, 0)) / dx;
    const T vx_hi = (r.template at<1>(1, 1, 0) - r.template at<1>(-1, 1, 0)) / dx;
    G[1][0] = h * (vx_lo + vx_hi);
    const T vz_lo = (zc(V{}, 0, 0, 1) - zc(V{}, 0, 0, -1)) / dz;
    const T vz_hi = (zc(V{}, 0, 1, 1) - zc(V{}, 0, 1, -1)) / dz;
    G[1][2] = h * (vz_lo + vz_hi);
    const T wx_lo = (r.template at<2>(1, 0, 0) - r.template at<2>(-1, 0, 0)) / dx;
    const T wx_hi = (r.template at<2>(1, 0, 1) - r.template at<2>(-1, 0, 1)) / dx;
    G[2][0] = h * (wx_lo + wx_hi);
    const T wy_lo = (yc(W{}, 0, 1, 0) - yc(W{}, 0, -1, 0)) / dy;
    const T wy_hi = (yc(W{}, 0, 1, 1) - yc(W{}, 0, -1, 1)) / dy;
    G[2][1] = h * (wy_lo + wy_hi);
}

// the planes in flight: two in float32, one in float64 (5 slots of three
// fields: 20.4 KB of shared memory in float32; 4 slots: 32.6 KB in float64)
template <typename T>
constexpr int kSgsAhead = sizeof(T) == 4 ? 2 : 1;

// blocks an SM the registers are capped for: four in float32 (64
// registers), two in float64
template <typename T>
constexpr int kSgsMinBlocks = sizeof(T) == 4 ? 4 : 2;

template <typename T, int CLOSURE>
__global__ void __launch_bounds__(xz::kThreads, kSgsMinBlocks<T>)
nu_sgs_tile_kernel(LesGrid<T> g, const T* __restrict__ delta,
                   T* __restrict__ out, T coeff, int chunk) {
    using Win = xz::Stage<T, 3, kSgsAhead<T>>;
    using View = typename Win::View;
    __shared__ T buf[Win::kSize];
    Win win;
    win.init(buf, g, chunk);
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    // a walled z's reflections are read only in its first and last z tiles
    const bool zedge = g.wall_z && (win.k0 == 0 || win.k0 + xz::kTz >= g.nz);
    win.walk([&](const View& view) {
        if (!owns) return;
        const int j = view.j;
        const bool edge = g.wall_y && (j == 0 || j == g.ny - 1);
        T G[3][3];
        if (zedge) {
            if (edge) gradient<T, true, true>(g, view, i, k, G);
            else gradient<T, false, true>(g, view, i, k, G);
        } else {
            if (edge) gradient<T, true, false>(g, view, i, k, G);
            else gradient<T, false, false>(g, view, i, k, G);
        }
        out[(i * g.ny + j) * g.nz + k] =
            cfdnn::nu_closure<T, CLOSURE>(G, delta + (j * g.nz + k), coeff);
    });
}

template <typename T, int CLOSURE>
void launch_closure(const LesGrid<T>& g, const T* delta, T* out, T coeff,
                    cudaStream_t stream) {
    const long long tiles = xz::grid(g.nx, g.nz, 1).x;   // of a plane
    const int chunk = cfdnn::walk_chunk<nu_sgs_tile_kernel<T, CLOSURE>,
                                        xz::kThreads>(tiles, g.ny);
    nu_sgs_tile_kernel<T, CLOSURE>
        <<<xz::grid(g.nx, g.nz, g.ny, chunk), xz::kThreads, 0, stream>>>(
            g, delta, out, coeff, chunk);
}

// The entry's body: refuses (cudaErrorInvalidValue) an axis of one cell,
// an unknown closure and a field past 32-bit offsets.
template <typename T>
int launch(const void* u, const void* v, const void* w, const void* inv_dx,
           const void* inv_dy, const void* inv_dz, const void* den_x,
           const void* den_y, const void* den_z, const void* delta, void* out,
           int nx, int ny, int nz, int wall_y, int wall_z, int closure,
           double coeff, void* stream) {
    const long long cx = nx, cy = ny, cz = nz;
    const long long n_v = cx * (cy + (wall_y ? 1 : 0)) * cz;
    const long long n_w = cx * cy * (cz + (wall_z ? 1 : 0));
    if (nx < 2 || ny < 2 || nz < 2 || (n_v > n_w ? n_v : n_w) > 2147483647LL)
        return static_cast<int>(cudaErrorInvalidValue);
    const LesGrid<T> g{static_cast<const T*>(u), static_cast<const T*>(v),
                       static_cast<const T*>(w), static_cast<const T*>(inv_dx),
                       static_cast<const T*>(inv_dy), static_cast<const T*>(inv_dz),
                       static_cast<const T*>(den_x), static_cast<const T*>(den_y),
                       static_cast<const T*>(den_z), nx, ny, nz, wall_y,
                       wall_z};
    const T* d = static_cast<const T*>(delta);
    T* o = static_cast<T*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (closure) {
        case 0: launch_closure<T, 0>(g, d, o, T(coeff), s); break;
        case 1: launch_closure<T, 1>(g, d, o, T(coeff), s); break;
        case 2: launch_closure<T, 2>(g, d, o, T(coeff), s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
