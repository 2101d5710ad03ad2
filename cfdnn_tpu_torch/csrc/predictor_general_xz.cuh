// predictor_general_xz: the general predictor (predictor_general.cu's
// function) on an (x, z) tile walked along y, for grids whose y-z planes
// the reference's TPU slab cannot hold.
//
// Replaces cfdnn_tpu/ops/pallas_kernels.py fused_predictor_general_xz
// (body _general_kernel_xz, which runs ops.convective + ops.diffusive on
// an (x, z) tile with full y columns and the 3 x 3 neighbour blocks). The
// plain PyTorch twin is ops/kernels.py predictor_general_twin, the
// operator library itself, as for the slab kernel. Grid: periodic uniform
// x and z, y periodic or bounded by no-slip walls (moving or not) at any
// stretching; O2 skew or central, scalar nu or nu + a cell nu_t. Shapes
// and metrics as predictor_general.cu, whose C interface this shares (z
// periodic: nzf = nz; the launcher refuses wall_z).
//
// The terms are predictor_terms.cuh's, the slab kernel's own, read through
// TileGrid from the staged window (xz_tile.cuh) in place of device
// memory: the cross terms interpolate in x and z, so the tile stages its
// halo's corners too, and the y stencil reaches planes j - 1 ... j + 1.
//
// Bound on the H100: device-memory bandwidth, as the slab kernel's (u, v,
// w, nu_t in, three stars out: 28 bytes a cell in float32, ~300 flops a
// cell). Design: a block of 8 x 32 threads stages its tile plus halo,
// 10 x 34 points of each field and plane (a read amplification of 1.33
// over the owned points), and walks 64 planes; each staged value is read
// from shared memory by every stencil that needs it, where the slab
// kernel leaves the reuse to L1/L2.
//
// The float and double entry points are compiled apart
// (predictor_general_xz.cu, predictor_general_xz_f64.cu), so that the
// library's parallel build does not wait on one file of eight kernels.
#pragma once

#include "predictor_terms.cuh"
#include "xz_tile.cuh"

namespace {

using namespace cfdnn::general;
using cfdnn::xz::Window;

// The reader of predictor_terms.cuh over the staged window: the axes and
// nu of the kernel's Grid, the fields (u, v, w and nu_t: field 3) from the
// window.
template <typename T, int NF>
struct TileGrid {
    Axis<T> ax[3];
    T nu;
    typename Window<T, NF, 1, 1>::View win;

    template <int C>
    __device__ __forceinline__ T val(const Pt& p) const {
        return win.read(C, p.q[0], p.q[1], p.q[2]);
    }

    __device__ __forceinline__ T ne(const Pt& p) const {
        return nu + win.read(3, p.q[0], p.q[1], p.q[2]);
    }
};

template <typename T, bool NUT, bool SKEW>
__global__ void __launch_bounds__(cfdnn::xz::kThreads)
predictor_general_xz_kernel(Grid<T> g, const T* __restrict__ dt_ptr,
                            T* __restrict__ su, T* __restrict__ sv,
                            T* __restrict__ sw, T fx) {
    constexpr int NF = NUT ? 4 : 3;
    __shared__ T buf[NF * 3 * cfdnn::xz::kPlane];
    const int nx = g.ax[0].n, ny = g.ax[1].n, nz = g.ax[2].n;
    const int nyf = g.ax[1].wall ? ny + 1 : ny;
    Window<T, NF, 1, 1> win;
    win.init(buf, nx, ny, nz, g.ax[1].wall, nyf, true);
#pragma unroll
    for (int c = 0; c < 3; ++c) win.field(c, g.f[c], c == 1 ? nyf : ny);
    if constexpr (NUT) win.field(3, g.nut, ny);
    const T dt = *dt_ptr;
    const int i = win.i, k = win.k;
    const bool owns = win.owns;
    win.walk([&](const typename Window<T, NF, 1, 1>::View& view) {
        if (!owns) return;
        const TileGrid<T, NF> r{{g.ax[0], g.ax[1], g.ax[2]}, g.nu, view};
        const int j = view.jc;
        const Pt p{{i, j, k}};
        if (j < ny) {
            su[i * g.sx[0] + j * g.sy[0] + k] = star<T, NUT, SKEW, 0>(r, p, dt, fx);
            sw[i * g.sx[2] + j * g.sy[2] + k] = star<T, NUT, SKEW, 2>(r, p, dt, fx);
        }
        sv[i * g.sx[1] + j * g.sy[1] + k] = star<T, NUT, SKEW, 1>(r, p, dt, fx);
    });
}

template <typename T, bool NUT, bool SKEW>
void launch_kernel(const Grid<T>& g, const T* dt, T* su, T* sv, T* sw, T fx,
                   cudaStream_t stream) {
    const int nyf = g.ax[1].wall ? g.ax[1].n + 1 : g.ax[1].n;
    predictor_general_xz_kernel<T, NUT, SKEW>
        <<<cfdnn::xz::grid(g.ax[0].n, g.ax[2].n, nyf), cfdnn::xz::kThreads, 0,
           stream>>>(g, dt, su, sv, sw, fx);
}

template <typename T>
int launch(const void* u, const void* v, const void* w, const void* dt,
           const void* nut, void* su, void* sv, void* sw,
           const void* const* metrics, const double* tang, int nx, int ny,
           int nz, int wall_y, int wall_z, double nu, double fx, int skew,
           void* stream) {
    if (wall_z || !cfdnn::xz::fits(nx, wall_y ? ny + 1 : ny, nz))
        return static_cast<int>(cudaErrorInvalidValue);
    const Grid<T> g = make_grid<T>(u, v, w, nut, metrics, tang, nx, ny, nz,
                                   wall_y, 0, nu);
    const T* d = static_cast<const T*>(dt);
    T* o[3] = {static_cast<T*>(su), static_cast<T*>(sv), static_cast<T*>(sw)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (nut) {
        if (skew) launch_kernel<T, true, true>(g, d, o[0], o[1], o[2], T(fx), s);
        else launch_kernel<T, true, false>(g, d, o[0], o[1], o[2], T(fx), s);
    } else {
        if (skew) launch_kernel<T, false, true>(g, d, o[0], o[1], o[2], T(fx), s);
        else launch_kernel<T, false, false>(g, d, o[0], o[1], o[2], T(fx), s);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
